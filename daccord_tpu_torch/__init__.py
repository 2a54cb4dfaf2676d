"""daccord_tpu_torch — the PyTorch/CUDA port of the daccord consensus engine.

Long-read error correction by per-window local de Bruijn graph consensus over
DALIGNER piles, written in PyTorch for an NVIDIA H100. The layout mirrors the
JAX package ``daccord_tpu`` module for module, so each file has one obvious
counterpart there:

- ``utils``    : base encodings, URL streams and the storage-fault gate
                 (``aio``), the event log, tracer, ledger, stage profile,
                 device probe and cold-shape registry (``obs``).
- ``formats``  : Dazzler DB / LAS / FASTA readers and writers, and the
                 ingest validation (``ingest``).
- ``oracle``   : numpy executable spec (alignment, windows, error profile,
                 per-window DBG consensus, stitching).
- ``sim``      : synthetic genome/read/overlap generator.
- ``kernels``  : batched torch window solver, the tier ladder and its
                 dispatcher thread, and the hand-written Hopper kernels
                 (``csrc/*.cu``).
- ``native``   : the C++ host library (feeder, window-consensus engine).
- ``runtime``  : the DB+LAS -> FASTA pipeline, the device supervisor, the
                 capacity governor and the fault plan.
- ``tools``    : the ``daccord`` command line, ``eventcheck`` and the
                 chip-side measurement tools.

The package imports torch and numpy only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; without CUDA they raise instead of falling
back.
"""

__version__ = "0.1.0"
