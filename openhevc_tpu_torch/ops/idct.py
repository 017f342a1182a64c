"""Residual assembly: dequant + inverse transform of one TU size bucket.

Counterpart of the JAX package's ops/idct.py::residual_bucket, written as
plain torch ops (no kernel: every TU is independent, so this is two
batched matrix products and elementwise integer arithmetic). Bit-exact
with the scalar reference ops/transforms_np.py (hevcdsp_template.c).

Exactness of the products: the two transform stages run as float64
`torch.matmul`. Every operand is an integer (|coeff| < 2^15, |basis| <=
90) and a dot product has at most 32 terms, so every partial sum is
below 2^27 and float64 (53-bit mantissa) holds it exactly on the CPU and
on the card alike; TF32 never applies to float64. torch has no integer
matmul on CUDA, and an unsplit float32 product would not be exact
(32 * 2^15 * 90 > 2^24).
"""
from __future__ import annotations

import torch

from .tables import TABLES

_MATS = {}


def _mats(s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(DCT_s, DST4^T) as float64 on `device`: both stages use B with
    stage 1 = B^T @ c and stage 2 = t @ B (B = M for the DCT, A^T for
    the 4x4 DST)."""
    key = (s, str(device))
    if key not in _MATS:
        dct = TABLES[f"DCT{s}"].to(device, torch.float64)
        dst = TABLES["DST4"].T.contiguous().to(device, torch.float64)
        _MATS[key] = (dct, dst)
    return _MATS[key]


def _clip16(x):
    return x.clamp(-32768, 32767)


def _two_stage(d: torch.Tensor, b: torch.Tensor, bit_depth: int):
    shift2 = 20 - bit_depth
    t = torch.matmul(b.T, d.to(torch.float64)).to(torch.int64)
    t = _clip16((t + 64) >> 7)
    r = torch.matmul(t.to(torch.float64), b).to(torch.int64)
    return _clip16((r + (1 << (shift2 - 1))) >> shift2)


def residual_bucket(levels, qp, is_dst, tskip, bypass, rdpcm_vert,
                    has_rdpcm, *, s: int, bit_depth: int):
    """levels: int [N, s, s] raw levels; qp int [N]; flags bool [N].
    Dequantises with the flat scaling factor 16 (scaling lists are not
    ported). Returns the int32 residual [N, s, s]."""
    log2s = s.bit_length() - 1
    bd_shift = bit_depth + log2s - 5
    lv = levels.to(torch.int64)
    qp = qp.to(torch.int64)
    ls = TABLES["LEVEL_SCALE"].to(lv.device)[qp % 6]
    # (lv*16*ls << qp//6 + rnd) >> bd_shift; |lv*16*ls << 8| < 2^42
    d = (lv * 16 * ls[:, None, None]) << (qp // 6)[:, None, None]
    d = _clip16((d + (1 << (bd_shift - 1))) >> bd_shift)

    dct, dst = _mats(s, lv.device)
    r_full = _two_stage(d, dct, bit_depth)
    if s == 4:
        r_full = torch.where(is_dst[:, None, None],
                             _two_stage(d, dst, bit_depth), r_full)
    ts_shift = 15 - bit_depth - log2s
    r_ts = (d + (1 << (ts_shift - 1))) >> ts_shift if ts_shift > 0 \
        else d << -ts_shift
    r = torch.where(bypass[:, None, None], lv,
                    torch.where(tskip[:, None, None], r_ts, r_full))
    r_dpcm = torch.where(rdpcm_vert[:, None, None], r.cumsum(1), r.cumsum(2))
    r = torch.where(has_rdpcm[:, None, None], r_dpcm, r)
    return r.to(torch.int32)
