from .pipeline import PipelineConfig, PipelineStats, correct_shard, correct_to_fasta

__all__ = ["PipelineConfig", "PipelineStats", "correct_shard", "correct_to_fasta"]
