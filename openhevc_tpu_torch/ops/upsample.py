"""SHVC inter-layer upsampling on the device (torch ops).

Counterpart of the JAX package's ops/upsample.py. The separable resample
(whole-frame variant of ff_upsample_block, hevc_filter.c:1175-1370) is a
tap plan per axis: for every output column (row) the `ntaps` source
columns (rows), clipped to the plane, and the filter row of its phase.
The JAX package turns the plans into two dense int32 matrices and
multiplies, because gathers are slow on a TPU. torch has no int32 matmul
on CUDA and a gather is cheap there, so the port evaluates the plan as it
stands: one gather of every tap's columns (rows), times the
coefficients, summed over the taps in int32. That is exact by
construction (the same integers the numpy reference adds; border-clipped
duplicate taps add up just as they do in the dense matrices), moves 8 or
4 reads a sample instead of one per source column, and needs no matrix
per mapping.

Range: the horizontal sums are at most 112 * (2^bd - 1) (112 = the
largest absolute coefficient sum of a phase) and the vertical ones 112
times that: 112 * 112 * 4095 < 2^26 at 12 bits, inside int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .upsample_np import UP_FILTER_CHROMA, UP_FILTER_LUMA, scale_add


def _axis_plan(n_out, n_in, scale, add, filt, end_minus1=False, off16=0):
    """(idx, coef) int32 [n_out, ntaps]: source positions (clipped to
    0..n_in-1) and filter coefficients of every output position (no
    scaled-reference-layer offsets: the window is the whole picture)."""
    ntaps = filt.shape[1]
    half = (ntaps >> 1) - 1
    x = np.minimum(np.arange(n_out), n_out - (1 if end_minus1 else 0))
    ref16 = ((x * scale + add) >> 12) + off16
    refpos = (ref16 >> 4) - half
    idx = np.clip(refpos[:, None] + np.arange(ntaps)[None, :], 0, n_in - 1)
    return idx.astype(np.int32), filt[ref16 & 15].astype(np.int32)


_PLAN_CACHE: dict = {}


def _plans(bl_w, bl_h, el_w, el_h, luma, device):
    """Cached tap plans of one (BL dims -> EL dims) plane mapping on one
    device, tap-major: (hidx int64 [ntaps, el_w], hcoef int32
    [ntaps, el_w], vidx int64 [ntaps, el_h], vcoef int32
    [ntaps, el_h, 1]). The key holds the canonical device: "cuda" and
    "cuda:0" are one card and share one entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (bl_w, bl_h, el_w, el_h, luma, device)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    if luma:
        filt, off16_y = UP_FILTER_LUMA, 0
        sx, ax = scale_add(bl_w, el_w)
        sy, ay = scale_add(bl_h, el_h)
    else:
        # chroma reuses the luma-derived scales (hevc.c:487); the vertical
        # phase is 1 (cross_layer_phase_alignment_flag == 0), and the
        # vertical position has the -4/16 offset (hevcdsp_template.c
        # chroma pass)
        filt, off16_y = UP_FILTER_CHROMA, -4
        sx, ax = scale_add(bl_w * 2, el_w * 2)
        sy, ay = scale_add(bl_h * 2, el_h * 2, phase=1)
    hidx, hcoef = _axis_plan(el_w, bl_w, sx, ax, filt)
    vidx, vcoef = _axis_plan(el_h, bl_h, sy, ay, filt, end_minus1=True,
                             off16=off16_y)

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(device, dt)

    out = (dev(hidx, torch.int64), dev(hcoef, torch.int32),
           dev(vidx, torch.int64), dev(vcoef, torch.int32)[:, :, None])
    if len(_PLAN_CACHE) > 64:
        _PLAN_CACHE.clear()
    _PLAN_CACHE[key] = out
    return out


def upsample_plane_dev(bl, hidx, hcoef, vidx, vcoef, bit_depth: int):
    """One plane through its tap plans (`_plans`): int32 [el_h, el_w].
    Horizontal pass at BL height, then the vertical pass, each one gather
    of all taps, one multiply and one int32 sum over the taps;
    (acc + 2^11) >> 12 and the clip to the sample range."""
    src = bl.to(torch.int32)
    # [bl_h, ntaps, el_w] -> [bl_h, el_w]
    temp = (src[:, hidx] * hcoef).sum(1, dtype=torch.int32)
    # [ntaps, el_h, el_w] -> [el_h, el_w]
    acc = (temp[vidx] * vcoef).sum(0, dtype=torch.int32)
    nshift = 20 - 8
    return ((acc + (1 << (nshift - 1))) >> nshift) \
        .clamp(0, (1 << bit_depth) - 1)


def upsample_il_frame_dev(planes_dev, el_w, el_h, bit_depth=8, hs=1, vs=1):
    """The inter-layer reference picture: the decoded BL planes [Y, Cb,
    Cr] (integer tensors on one device) upsampled to EL dimensions on
    that device (scale / phase rules hevc.c:473-487). Returns three int32
    tensors; nothing touches the host."""
    y = planes_dev[0]
    bl_h, bl_w = y.shape
    out = [upsample_plane_dev(
        y, *_plans(bl_w, bl_h, el_w, el_h, True, y.device), bit_depth)]
    for c in (1, 2):
        p = planes_dev[c]
        bh, bw = p.shape
        out.append(upsample_plane_dev(
            p, *_plans(bw, bh, el_w >> hs, el_h >> vs, False, p.device),
            bit_depth))
    return out
