"""What a picture's intra prediction needs to move, counted from the
parsed picture alone, whatever implements it.

Each intra-predicted sample (every sample of every intra transform
block, luma and chroma) has its residual read once, at 16 bits (the
residual of video up to 15 bits fits), and its reconstruction written
once, at the picture's sample size (1 byte up to 8 bits, else 2). PCM
samples are left out: they are copied into the picture before the intra
kernels run, not by them. None of the program's own job metadata,
schedules or padding is counted, so a change to its layout cannot move
this yardstick.
"""
from __future__ import annotations

RESIDUAL_BYTES = 2


def intra_samples(fs) -> int:
    """Samples of the picture's intra transform blocks, from either
    parser: the native core's job rows (`native_raw["ij_meta"]`, column
    3 the block size) or the Python parser's `intra_jobs`."""
    raw = getattr(fs, "native_raw", None)
    if raw is not None:
        sizes = raw["ij_meta"][:, 3].astype("int64")
        return int((sizes * sizes).sum())
    return sum(j.size * j.size for j in fs.intra_jobs)


def intra_bytes(fs) -> int:
    """Bytes the picture's intra prediction needs to move."""
    sps = fs.sps
    depth = max(sps.bit_depth, getattr(sps, "bit_depth_chroma",
                                       sps.bit_depth))
    return intra_samples(fs) * (RESIDUAL_BYTES + (1 if depth <= 8 else 2))
