from .synth import SimConfig, SimResult, make_dataset, score_vs_truth, simulate

__all__ = ["SimConfig", "SimResult", "simulate", "make_dataset", "score_vs_truth"]
