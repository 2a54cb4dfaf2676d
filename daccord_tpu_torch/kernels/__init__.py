from .tensorize import BatchShape, WindowBatch, pad_batch, tensorize_windows
from .tiers import TierLadder, ladder_core, pack_result, solve_ladder, unpack_result
from .window_kernel import KernelParams, prep_batch, solve_batch_core

__all__ = ["BatchShape", "WindowBatch", "pad_batch", "tensorize_windows",
           "TierLadder", "ladder_core", "pack_result", "solve_ladder",
           "unpack_result", "KernelParams", "prep_batch", "solve_batch_core"]
