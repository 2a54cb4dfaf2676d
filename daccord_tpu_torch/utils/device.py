"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asks for ``cpu``. Raises when CUDA is asked for (the default) and is not
    available — the port never falls back to the CPU on its own.

    On CUDA, float32 matmuls are pinned to full float32 (no TF32): the
    OffsetLikely weights feed the DP's argmax ties, so their bits matter."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
