from .launch import MergeGateError, load_shard_manifest, merge_shards, run_shard

__all__ = ["MergeGateError", "load_shard_manifest", "merge_shards", "run_shard"]
