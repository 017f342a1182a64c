"""Inter prediction on the device: the two-stage dense formulation.

Counterpart of the JAX package's ops/mc.py (plain XLA there, plain torch
ops here: no hand kernel, see PERF.md for their times).

Stage 1 (per decoded picture, cached across the pictures that reference
it): the reference plane is horizontally filtered at ALL fractional
phases: P = 4 (qpel) or 8 (epel) int16 planes, the reference decoder's
int16 `tmp` intermediate, once per phase column (`mc_hprefilter`). The
all-phase-PAIR variant filters vertically too, for every (y-phase,
x-phase) (`mc_prefilter_pairs`).

Stage 2 (per predicted picture): per pixel, `taps` rows of the stage-1
planes gathered by (reference slot, x-phase, integer offset) and filtered
vertically by the pixel's y-phase (`mc_put_core`), or ONE gather from the
all-pair planes (`mc_put_pairs_core`). The motion arrives as per-4x4
grids and is brought to pixel granularity here.

A pad margin of PAD = 8 makes clamped out-of-range gathers land in
constant filtered regions, which equals the reference's replicated-edge
emulation. torch neither clamps nor drops an out-of-range index, so every
index that JAX clamps implicitly (the slot, the phase) is clamped here
explicitly, and the linear indices are int64: the pair planes of a few
4K references hold more than 2^31 samples.

Both stage-1 functions take `out=`: the stage-1 planes of a picture's
references live side by side in one tensor [S, ...] (the engine's
cache), so that stage 2 indexes references by slot without stacking
them for every picture. Bit-exact with the JAX package's ops/mc.py and
ops/mc_np.py (integers; tolerance none).
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import EPEL_FILTERS, QPEL_FILTERS

PAD = 8

# phase 0 = identity row (64 at the "center" tap used by the put paths)
_QPEL_ALL = np.zeros((4, 8), np.int32)
_QPEL_ALL[0, 3] = 64
_QPEL_ALL[1:] = QPEL_FILTERS
_EPEL_ALL = np.zeros((8, 4), np.int32)
_EPEL_ALL[0, 1] = 64
_EPEL_ALL[1:] = EPEL_FILTERS


def stage1_shape(H: int, W: int, is_luma: bool, pairs: bool):
    """Shape of one reference plane's stage-1 planes: [P, Hp, wn] (tap
    mode) or [Py, Px, hn, wn] (pair mode)."""
    taps, P = (8, 4) if is_luma else (4, 8)
    Hp, wn = H + 2 * PAD, W + 2 * PAD - taps + 1
    return (P, P, Hp - taps + 1, wn) if pairs else (P, Hp, wn)


def _hfilter32(ref, bit_depth: int, is_luma: bool):
    """[P, H + 2 PAD, wn] int32: the horizontally filtered intermediate
    at every phase, already >> (bd - 8) and wrapped to int16's range."""
    H, W = ref.shape
    taps = 8 if is_luma else 4
    filt = _QPEL_ALL if is_luma else _EPEL_ALL
    dev = ref.device
    # edge padding by clamped index: the same on every build and device
    yi = (torch.arange(H + 2 * PAD, device=dev) - PAD).clamp(0, H - 1)
    xi = (torch.arange(W + 2 * PAD, device=dev) - PAD).clamp(0, W - 1)
    padded = ref.to(torch.int32)[yi][:, xi]
    wn = W + 2 * PAD - taps + 1
    acc = torch.zeros((filt.shape[0], H + 2 * PAD, wn), dtype=torch.int32,
                      device=dev)
    for k in range(taps):
        w = torch.tensor(filt[:, k], dtype=torch.int32, device=dev)
        acc += padded[None, :, k:k + wn] * w[:, None, None]
    return acc >> (bit_depth - 8)


def mc_hprefilter(ref, bit_depth: int, is_luma: bool, out=None):
    """ref: [H, W] integer plane -> hf [P, H + 2 PAD, wn] int16, the
    horizontally filtered intermediate at every phase (>> (bd - 8), the
    reference's 14-bit-headroom tmp). The int32 -> int16 conversion
    wraps, as the reference's int16 store does."""
    acc = _hfilter32(ref, bit_depth, is_luma)
    if out is None:
        return acc.to(torch.int16)
    return out.copy_(acc)


def mc_prefilter_pairs(ref, bit_depth: int, is_luma: bool, out=None):
    """All-phase-PAIR prefilter: [Py, Px, hn, wn] int16, the fully
    filtered 'put' intermediate at every (y-phase, x-phase). Turns stage
    2 into a single gather per pixel at 4x (luma) / 8x (chroma) the
    memory of `mc_hprefilter`."""
    taps = 8 if is_luma else 4
    filt = _QPEL_ALL if is_luma else _EPEL_ALL
    # the int16 wrap of stage 1, kept in int32 for the vertical sums
    hf32 = _hfilter32(ref, bit_depth, is_luma).to(torch.int16) \
        .to(torch.int32)
    P, Hp, wn = hf32.shape
    hn = Hp - taps + 1
    if out is None:
        out = torch.empty((P, P, hn, wn), dtype=torch.int16,
                          device=ref.device)
    for py in range(P):
        acc = torch.zeros((P, hn, wn), dtype=torch.int32, device=ref.device)
        for t in range(taps):
            if filt[py, t]:
                acc += hf32[:, t:t + hn, :] * int(filt[py, t])
        out[py].copy_(acc >> 6)
    return out


def _up(a, repv: int, reph: int, H: int, W: int):
    """A per-4x4 grid at pixel granularity, cut to [H, W]."""
    return a.repeat_interleave(repv, 0).repeat_interleave(reph, 1)[:H, :W]


def _pixel_motion(mv4, slot4, is_luma, hs, vs, H, W, R, hn, wn):
    """Per pixel: (slot, x-phase, y-phase, clamped column, clamped row)
    of the stage-1 sample at the pixel's integer offset, all int64.
    Chroma offset / phase follow hevc.c:1807-1813 (offset =
    mv >> (2 + shift), phase = (mv & mask) << (1 - shift))."""
    mv4 = mv4.to(torch.int64)
    fbx = 2 if is_luma else 2 + hs
    fby = 2 if is_luma else 2 + vs
    pmx = 1 if is_luma else 1 << (1 - hs)
    pmy = 1 if is_luma else 1 << (1 - vs)
    center = 3 if is_luma else 1
    reph = 4 if is_luma else 4 >> hs
    repv = 4 if is_luma else 4 >> vs
    mvx = _up(mv4[:, :, 0], repv, reph, H, W)
    mvy = _up(mv4[:, :, 1], repv, reph, H, W)
    slot = _up(slot4.to(torch.int64), repv, reph, H, W).clamp(0, R - 1)
    ys = torch.arange(H, device=mv4.device)[:, None]
    xs = torch.arange(W, device=mv4.device)[None, :]
    fx = (mvx & ((1 << fbx) - 1)) * pmx
    fy = (mvy & ((1 << fby) - 1)) * pmy
    gi = (xs + (mvx >> fbx) + PAD - center).clamp(0, wn - 1)
    gj = (ys + (mvy >> fby) + PAD - center).clamp(0, hn - 1)
    return slot, fx, fy, gi, gj


def mc_put_core(hf, mv4, slot4, bit_depth: int, is_luma: bool, hs: int,
                vs: int, H: int, W: int):
    """hf: [R, P, Hp, wn] int16 stage-1 planes of R references. mv4:
    [h4, w4, 2] integer (this list's luma quarter-pel MVs at 4x4
    granularity), slot4: [h4, w4] integer reference-slot grid (clamped
    to 0..R-1). Returns the 14-bit 'put' intermediate [H, W] int32 of
    this plane."""
    R, P, Hp, wn = hf.shape
    taps = 8 if is_luma else 4
    hn = Hp - taps + 1
    slot, fx, fy, gi, gj = _pixel_motion(mv4, slot4, is_luma, hs, vs, H, W,
                                         R, hn, wn)
    filt = torch.tensor(_QPEL_ALL if is_luma else _EPEL_ALL,
                        dtype=torch.int32, device=hf.device)
    flat = hf.reshape(R * P, Hp, wn)
    lin = slot * P + fx
    acc = torch.zeros((H, W), dtype=torch.int32, device=hf.device)
    for j in range(taps):
        acc += flat[lin, gj + j, gi].to(torch.int32) * filt[:, j][fy]
    return acc >> 6


def mc_put_pairs_core(pp, mv4, slot4, bit_depth: int, is_luma: bool,
                      hs: int, vs: int, H: int, W: int):
    """Stage 2 over the all-pair planes: ONE linearized gather per pixel.
    pp: [R, Py, Px, hn, wn] int16. Identical output to `mc_put_core`
    (the >> 6 already happened inside the phase planes; both shift after
    the full 2-D filter sum). The linear index is int64."""
    R, Py, Px, hn, wn = pp.shape
    slot, fx, fy, gi, gj = _pixel_motion(mv4, slot4, is_luma, hs, vs, H, W,
                                         R, hn, wn)
    idx = (((slot * Py + fy) * Px + fx) * hn + gj) * wn + gi
    return pp.reshape(-1)[idx].to(torch.int32)


def combine_plane(put0, put1, pf, res, bit_depth: int):
    """Per-plane default (non-weighted) uni / bi combine + residual add:
    pf is the pixel-granular pred_flag (0 intra, 1 L0, 2 L1, 3 BI);
    intra pixels return 0 (the caller's prefill base)."""
    maxv = (1 << bit_depth) - 1
    shift_u = 14 - bit_depth
    off_u = 1 << (shift_u - 1)
    shift_b = 15 - bit_depth
    off_b = 1 << (shift_b - 1)
    uni0 = (put0 + off_u) >> shift_u
    uni1 = (put1 + off_u) >> shift_u
    bi = (put0 + put1 + off_b) >> shift_b
    pred = torch.where(pf == 3, bi, torch.where(pf == 2, uni1, uni0))
    pred = pred.clamp(0, maxv)
    return torch.where(pf > 0, (pred + res).clamp(0, maxv), 0)


def combine_plane_w(put0, put1, pf, res, w0, o0, w1, o1, bit_depth: int,
                    denom: int):
    """Per-plane weighted-prediction combine (put_hevc_*_uni_w / bi_w
    semantics). With denom = 0, w = 1, o = 0 it reduces exactly to
    `combine_plane`."""
    maxv = (1 << bit_depth) - 1
    osc = 1 << (bit_depth - 8)
    shift_u = denom + 14 - bit_depth
    off_u = 1 << (shift_u - 1) if shift_u > 0 else 0
    uni0 = ((put0 * w0 + off_u) >> shift_u) + o0 * osc
    uni1 = ((put1 * w1 + off_u) >> shift_u) + o1 * osc
    log2wd = denom + (15 - bit_depth) - 1
    bi = (put1 * w1 + put0 * w0 +
          ((o0 * osc + o1 * osc + 1) << log2wd)) >> (log2wd + 1)
    pred = torch.where(pf == 3, bi, torch.where(pf == 2, uni1, uni0))
    pred = pred.clamp(0, maxv)
    return torch.where(pf > 0, (pred + res).clamp(0, maxv), 0)
