"""Base-level encoding helpers.

Conventions (shared by every layer of the framework):

- Bases are encoded A=0, C=1, G=2, T=3 (the Dazzler 2-bit numbering; reference:
  DAZZ_DB ``DB.h`` Compress_Read / libmaus2 ``dazzler/db`` decode tables —
  file:line to backfill per SURVEY.md §8).
- In-memory sequences are numpy ``int8`` arrays of 0..3; the value 4 is the
  universal PAD sentinel in batched tensors.
- On-disk ``.bps`` packing is 4 bases/byte, first base in the two *highest*
  bits of the byte (Dazzler order).
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
PAD = 4

# ASCII -> 0..3 lookup (uppercase + lowercase); everything else maps to 0 (A),
# matching the Dazzler convention of arbitrary-coding unknown characters.
_ASCII_LUT = np.zeros(256, dtype=np.int8)
for _i, _c in enumerate(BASES):
    _ASCII_LUT[ord(_c)] = _i
    _ASCII_LUT[ord(_c.lower())] = _i

_INT_TO_CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)


def seq_to_ints(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 array of 0..3."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ASCII_LUT[raw]


def ints_to_seq(arr: np.ndarray) -> str:
    """int8 array of 0..3 -> ASCII string."""
    arr = np.asarray(arr)
    return _INT_TO_CHAR[arr.astype(np.intp)].tobytes().decode("ascii")


def revcomp_ints(arr: np.ndarray) -> np.ndarray:
    """Reverse complement in integer space: complement is 3 - b."""
    return (3 - np.asarray(arr))[::-1].astype(np.int8)


def revcomp_seq(seq: str) -> str:
    return ints_to_seq(revcomp_ints(seq_to_ints(seq)))


def pack_2bit(arr: np.ndarray) -> bytes:
    """Pack 0..3 ints into Dazzler .bps bytes (4 bases/byte, MSB-first).

    Length is padded up with base 0 (A); callers must remember the true length.
    """
    arr = np.asarray(arr, dtype=np.uint8)
    n = len(arr)
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = arr
    quads = padded.reshape(-1, 4)
    packed = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    return packed.astype(np.uint8).tobytes()


def unpack_2bit(buf: bytes | np.ndarray, length: int) -> np.ndarray:
    """Unpack Dazzler .bps bytes into an int8 array of ``length`` bases."""
    raw = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) else np.asarray(buf, dtype=np.uint8)
    out = np.empty(len(raw) * 4, dtype=np.int8)
    out[0::4] = (raw >> 6) & 3
    out[1::4] = (raw >> 4) & 3
    out[2::4] = (raw >> 2) & 3
    out[3::4] = raw & 3
    return out[:length]
