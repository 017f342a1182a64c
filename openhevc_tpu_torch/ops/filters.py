"""In-loop filters on the device: whole-frame deblocking + SAO.

Counterpart of the JAX package's ops/filters_jax.py (plain XLA there).
On a card, `apply_filters_device` is three hand-written kernels
(csrc/loop_filters.cu: vertical edges, horizontal edges, SAO, one launch
each); on the CPU it runs the plain PyTorch version `apply_filters_ref`,
dense stencils (`roll` / `reshape` / `where`) over the whole frame,
which the kernels equal sample for sample (scalar truth in the JAX
package: ops/deblock_np.py, ops/sao_np.py, ops/filters_sched.py).

The one entry point is `plan_filters(fs)`: None for a picture with no
filters, else a `FilterPlan` that says the route (the device, or the
host's CTB schedule where a halo pattern falls outside the whole-frame
model) and carries what the device route needs by name. The engine
(models/pipeline.py) and a mesh's tile axis (parallel/mesh.py) follow
it and know nothing else of the filters' data: they put `plan.arrays`
(or its grids) into their upload and call `plan.args` (one
`edge_params` launch) and `plan.apply`. The order of `FARG_KEYS` and the
(1, 1) placeholders of the control arrays a picture lacks stay inside
this module.

Design: the host derives the per-edge control data that depends on the
picture's structure (no-filter flags, the CTB-16 chroma halo, per-CTB
SAO parameters) as SMALL numpy arrays (`prep_filters`), which ride in
the picture's one upload, and the device applies the sample stencils
over the whole frame. The per-edge boundary strengths and beta / tc
thresholds are made on the device from the parser's per-4x4 grids
(`edge_params`: the kernel csrc/edge_params.cu on a card, its plain
PyTorch version `edge_params_ref` on the CPU). In the plain version,
vertical-edge windows tile a row exactly (edges are 8 apart, each window
spans +-4), so a pass is one reshape + elementwise math; the horizontal
passes run on the transposed plane. The kernels keep that tiling: one
thread a window.

The whole-frame formulation reproduces the reference decoder's staggered
CTB schedule, including PCM / transquant-bypass no-filter blocks (write
suppression per edge + restore after SAO, of which the chroma restore
covers only the top-left quadrant of a CTB, as the reference does) and
the 16x16-CTB SAO chroma halo (`_chroma_stale_reads`). Where a halo
pattern falls outside that model `prep_filters` returns None and the
plan's route is "host". Bit-exact with the JAX package's module
(integers; tolerance none).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..bitstream.syntax import chroma_qp
from ..utils import trace
from .tables import BETA_TABLE, TC_TABLE


# =========================================================================
# Host side: vectorized boundary strengths (the host-filter route,
# ops/filters_sched.py) and the control arrays
# =========================================================================

def _mv_bs_vec(mc, psel, qsel):
    """Vectorized MV-difference rule (_mv_bs of deblock_np.py) over
    (row-slice, col-slice) selectors p/q of equal extent. Returns int32
    array (0/1). Selectors are basic slices — the edge grids are
    regular every-other-column/row patterns, and slicing avoids the
    fancy-gather copies that cost ~40 ms/frame at 1080p."""
    PF_BI = 3
    p_pf = np.asarray(mc.pred_flag[psel], np.int32)
    q_pf = np.asarray(mc.pred_flag[qsel], np.int32)
    p_mv = np.asarray(mc.mv[psel], np.int32)      # [..., 2(list), 2(xy)]
    q_mv = np.asarray(mc.mv[qsel], np.int32)
    p_poc = mc.refpoc[psel]
    q_poc = mc.refpoc[qsel]
    p_ri = mc.ref_idx[psel]
    q_ri = mc.ref_idx[qsel]

    # near = per-(list-pairing) "both components differ by < 4":
    # near_s[..., l] pairs list l with list l; near_x pairs them crossed.
    # Two abs-diff passes replace the five pairwise far() evaluations.
    near_s = (np.abs(p_mv - q_mv) < 4).all(axis=-1)          # [..., 2]
    near_x = (np.abs(p_mv[..., ::-1, :] - q_mv) < 4).all(axis=-1)
    straight = near_s[..., 0] & near_s[..., 1]
    crossed = near_x[..., 0] & near_x[..., 1]

    same = ((p_pf == q_pf) &
            (p_mv == q_mv).all(axis=(-2, -1)) &
            (p_poc == q_poc).all(axis=-1) &
            (p_ri == q_ri).all(axis=-1))

    # both BI
    both_bi = (p_pf == PF_BI) & (q_pf == PF_BI)
    same_all_poc = (q_poc[..., 0] == p_poc[..., 0]) & \
        (q_poc[..., 0] == q_poc[..., 1]) & (p_poc[..., 0] == p_poc[..., 1])
    bi_case1 = same_all_poc & (straight | crossed)
    match_ll = (p_poc[..., 0] == q_poc[..., 0]) & \
        (p_poc[..., 1] == q_poc[..., 1])
    bi_case2 = ~same_all_poc & match_ll & straight
    match_x = (p_poc[..., 1] == q_poc[..., 0]) & \
        (p_poc[..., 0] == q_poc[..., 1])
    bi_case3 = ~same_all_poc & ~match_ll & match_x & crossed
    bi_zero = bi_case1 | bi_case2 | bi_case3

    # both uni: used list = 0 when pf has bit0, else 1; select with
    # where instead of take_along_axis gathers
    both_uni = (p_pf != PF_BI) & (q_pf != PF_BI)
    lq0 = (q_pf & 1) != 0
    lp0 = (p_pf & 1) != 0
    q_poc_u = np.where(lq0, q_poc[..., 0], q_poc[..., 1])
    p_poc_u = np.where(lp0, p_poc[..., 0], p_poc[..., 1])
    # near for the used-list pairing, via the two precomputed tables
    # (lp0 True = p uses list 0): both-0 -> near_s[...,0]; both-1 ->
    # near_s[...,1]; p0 vs q1 -> near_x[...,1]; p1 vs q0 -> near_x[...,0]
    near_u = np.where(
        lp0 == lq0,
        np.where(lp0, near_s[..., 0], near_s[..., 1]),
        np.where(lp0, near_x[..., 1], near_x[..., 0]))
    uni_zero = (q_poc_u == p_poc_u) & near_u

    bs = np.ones(p_pf.shape, np.int32)
    bs[both_bi & bi_zero] = 0
    bs[both_uni & uni_zero] = 0
    bs[same] = 0
    return bs


def boundary_strengths_vec(fs):
    """Vectorized whole-frame BS (parity: boundary_strengths,
    deblock_np.py / ff_hevc_deblocking_boundary_strengths)."""
    sps = fs.sps
    h4, w4 = sps.height >> 2, sps.width >> 2
    h8, w8 = sps.height >> 3, sps.width >> 3
    pm = fs.pred_mode[:h4, :w4]
    cbf = fs.cbf_luma4[:h4, :w4]
    vbs = np.zeros((h4, w8), np.int32)
    hbs = np.zeros((h8, w4), np.int32)

    def dir_bs(psel, qsel, tu_edge):
        intra = (pm[qsel] == 1) | (pm[psel] == 1)
        anycbf = (cbf[psel] != 0) | (cbf[qsel] != 0)
        if fs.motion is not None:
            mv = _mv_bs_vec(fs.motion, psel, qsel)
        else:
            mv = np.zeros(intra.shape, np.int32)
        at_edge = np.where(intra, 2, np.where(anycbf, 1, mv))
        interior = np.where(intra, 0, mv)
        return np.where(tu_edge != 0, at_edge, interior)

    if w8 > 1:
        # p columns 1,3,..,w4-3; q columns 2,4,..,w4-2 (both w8-1 wide)
        vbs[:, 1:] = dir_bs((slice(0, h4), slice(1, w4 - 2, 2)),
                            (slice(0, h4), slice(2, w4, 2)),
                            fs.bounds_v[:h4, 2:w4:2])
    if h8 > 1:
        hbs[1:, :] = dir_bs((slice(1, h4 - 2, 2), slice(0, w4)),
                            (slice(2, h4, 2), slice(0, w4)),
                            fs.bounds_h[2:h4:2, :w4])
    return vbs, hbs


FARG_KEYS = ("beta_v", "tc_v", "beta_h", "tc_h", "tc_cv1", "tc_ch1",
             "tc_cv2", "tc_ch2", "sao", "nop_v", "noq_v", "nop_h",
             "noq_h", "nop_cv", "noq_cv", "nop_ch", "noq_ch", "nf4",
             "nf4c", "st_b0", "st_b2", "st_a3")
EDGE_KEYS = FARG_KEYS[:8]       # what `edge_params` makes, in this order


def _no_filter_mask(fs):
    """Per-4x4 bool map of blocks whose samples the filters must leave
    alone (PCM with pcm_loop_filter_disabled, cu_transquant_bypass), or
    None when the stream can have none."""
    sps, pps = fs.sps, fs.pps
    pcmf = (sps.pcm_enabled and sps.pcm_loop_filter_disabled) or \
        pps.transquant_bypass_enabled
    if not pcmf:
        return None
    return (fs.is_pcm.astype(bool) &
            bool(sps.pcm_enabled and sps.pcm_loop_filter_disabled)) | \
        fs.tqb.astype(bool)


def _nofilter_grids(fs, nf, H, W):
    """Per-edge-segment write-suppression flags for the device deblock
    (granularity mirror of filters_sched._deblock_ctb's get_nf calls)
    plus the per-4x4 restore mask. nf: [h4, w4] bool.
    Chroma-format-generic: chroma edges sit every 8 chroma samples;
    the luma-grid sampling positions scale by the hs/vs shifts."""
    sps = fs.sps
    hs, vs = sps.hshift1, sps.vshift1
    h4, w4, h8, w8 = H >> 2, W >> 2, H >> 3, W >> 3
    Hc, Wc = H >> vs, W >> hs
    hc4, wc8 = Hc >> 2, (Wc + 7) >> 3
    hc8, wc4 = (Hc + 7) >> 3, Wc >> 2
    g = {}
    nop_v = np.zeros((h4, w8), np.int16)
    noq_v = np.zeros((h4, w8), np.int16)
    if w8 > 1:
        nop_v[:, 1:] = nf[:h4, 1:2 * w8 - 1:2]
        noq_v[:, 1:] = nf[:h4, 2:2 * w8:2]
    nop_h = np.zeros((h8, w4), np.int16)
    noq_h = np.zeros((h8, w4), np.int16)
    if h8 > 1:
        nop_h[1:] = nf[1:2 * h8 - 1:2, :w4]
        noq_h[1:] = nf[2:2 * h8:2, :w4]
    nop_cv = np.zeros((hc4, wc8), np.int16)
    noq_cv = np.zeros((hc4, wc8), np.int16)
    if wc8 > 1:
        cy4, cx8 = np.mgrid[0:hc4, 1:wc8]
        nop_cv[:, 1:] = nf[cy4 << vs, (cx8 << hs) * 2 - 1]
        noq_cv[:, 1:] = nf[cy4 << vs, (cx8 << hs) * 2]
    nop_ch = np.zeros((hc8, wc4), np.int16)
    noq_ch = np.zeros((hc8, wc4), np.int16)
    if hc8 > 1:
        cy8, cx4 = np.mgrid[1:hc8, 0:wc4]
        nop_ch[1:] = nf[(cy8 << vs) * 2 - 1, cx4 << hs]
        noq_ch[1:] = nf[(cy8 << vs) * 2, cx4 << hs]
    nf4 = nf[:h4, :w4].astype(np.int16)
    # chroma restore covers only the top-left (ctb>>hs, ctb>>vs)
    # plane-unit region of each CTB: the reference passes plane-unit
    # width/height with LUMA x/y into restore_tqb_pixels
    # (hevc_filter.c:163) — reproduced faithfully
    # (see filters_sched._restore_ctb)
    ctb = 1 << sps.log2_ctb
    xl = np.arange(w4) * 4
    yl = np.arange(h4) * 4
    cx0 = (xl // ctb) * ctb
    cy0 = (yl // ctb) * ctb
    qw = np.minimum(ctb >> hs, Wc - (cx0 >> hs))
    qh = np.minimum(ctb >> vs, Hc - (cy0 >> vs))
    quad = ((yl - cy0 < qh)[:, None] & (xl - cx0 < qw)[None, :])
    g.update(nop_v=nop_v, noq_v=noq_v, nop_h=nop_h, noq_h=noq_h,
             nop_cv=nop_cv, noq_cv=noq_cv, nop_ch=nop_ch, noq_ch=noq_ch,
             nf4=nf4, nf4c=(nf4 & quad).astype(np.int16))
    return g


def _chroma_stale_reads(fs):
    """Exact schedule simulation of the reference's staggered filter
    pipeline (ops/filters_sched.py truth; ff_hevc_hls_filter +
    deblocking_filter_CTB's chroma x_end -= 8*h deferral): for every
    chroma position, the step at which its horizontal deblock lands,
    and for every CTB, the step at which its SAO runs. A neighbor read
    is stale (must source the vertical-stage plane) iff the target's
    h-deblock lands strictly after the reader CTB's SAO step.

    Returns center-space masks {(dx, dy): [Hc, Wc] int16} for the three
    +x neighbor offsets of the SAO edge classes (eo0 b=(1,0),
    eo2 b=(1,1), eo3 a=(1,-1)), or None when a non-+x offset would be
    stale (never observed; caller then falls back to host filters)."""
    sps = fs.sps
    ctb = 1 << sps.log2_ctb
    W, H = sps.width, sps.height
    hs, vs = sps.hshift1, sps.vshift1
    ch, cv = 1 << hs, 1 << vs
    Hc, Wc = H >> vs, W >> hs
    h_time = np.full((Hc, Wc), -1, np.int64)
    sao_t = np.full((sps.ctbs_h, sps.ctbs_w), 1 << 60, np.int64)
    step = 0

    def deblock_times(x0, y0, t):
        # mirror of filters_sched's horizontal-chroma loop geometry:
        # edges every 8 chroma samples (8*ch / 8*cv luma), last 8*ch
        # luma columns deferred unless at the picture edge
        x_end = min(x0 + ctb, W)
        y_end = min(y0 + ctb, H)
        x_end2 = x_end
        if x_end2 != W:
            x_end = x_end2 - 8 * ch
        for y in range(y0 if y0 else 8 * cv, y_end, 8 * cv):
            for x in range(x0 - 8 * ch if x0 else 0, x_end, 8 * ch):
                for sub in (0, 4 * ch):
                    xx = x + sub
                    if xx >= W:
                        continue
                    cy, cx = y >> vs, xx >> hs
                    h_time[cy - 1, cx:cx + 4] = t
                    if cy < Hc:
                        h_time[cy, cx:cx + 4] = t

    def hls_filter(x, y, t):
        deblock_times(x, y, t)
        x_end = x >= W - ctb
        y_end = y >= H - ctb
        for (sx, sy, cond) in (((x - ctb), (y - ctb), y and x),
                               ((x - ctb), y, x and y_end),
                               (x, (y - ctb), y and x_end),
                               (x, y, x_end and y_end)):
            if cond:
                sao_t[sy >> sps.log2_ctb, sx >> sps.log2_ctb] = \
                    min(sao_t[sy >> sps.log2_ctb, sx >> sps.log2_ctb], t)

    if fs.ctb_order is not None:
        order = list(fs.ctb_order)
    else:
        order = [(rx * ctb, ry * ctb) for ry in range(sps.ctbs_h)
                 for rx in range(sps.ctbs_w)]
    calls = []
    for (x, y) in order:
        x_end = x >= W - ctb
        y_end = y >= H - ctb
        if y and x:
            calls.append((x - ctb, y - ctb))
        if y and x_end:
            calls.append((x, y - ctb))
        if x and y_end:
            calls.append((x - ctb, y))
    calls.append(order[-1])
    for t, (x, y) in enumerate(calls):
        hls_filter(x, y, t)

    yy, xx = np.mgrid[0:Hc, 0:Wc]
    ry = np.minimum((yy << vs) // ctb, sps.ctbs_h - 1)
    rx = np.minimum((xx << hs) // ctb, sps.ctbs_w - 1)
    reader_t = sao_t[ry, rx]
    masks = {}
    any_bad = False
    for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1),
                     (1, 1), (1, -1), (-1, 1)):
        ty = np.clip(yy + dy, 0, Hc - 1)
        tx = np.clip(xx + dx, 0, Wc - 1)
        inb = ((yy + dy >= 0) & (yy + dy < Hc) &
               (xx + dx >= 0) & (xx + dx < Wc))
        m = inb & (h_time[ty, tx] > reader_t)
        if dx == 1:
            masks[(dx, dy)] = m.astype(np.int16)
        elif m.any():
            any_bad = True
    return None if any_bad else masks


@functools.lru_cache(maxsize=64)
def _chroma_qp_lut(offset: int, chroma_format_idc: int) -> np.ndarray:
    # per-qp LUT (np.vectorize over chroma_qp ran at python rate, ~10
    # ms/frame on 4:4:4); domain covers negative average QPs
    # (high-bit-depth offsets)
    lut = np.array([chroma_qp(q, offset, chroma_format_idc, 0)
                    for q in range(-32, 64)], np.int32)
    lut.flags.writeable = False
    return lut


def chroma_qp_luts(fs) -> np.ndarray:
    """[2, 96] int32: the chroma QP (8.7.1, no bit-depth offset) of Cb and
    Cr for the average luma QPs -32..63 of a chroma edge, with the PPS
    and slice offsets of each component."""
    sps, pps = fs.sps, fs.pps
    offs = (pps.cb_qp_offset + getattr(fs, "slice_cb_qp_offset", 0),
            pps.cr_qp_offset + getattr(fs, "slice_cr_qp_offset", 0))
    return np.stack([_chroma_qp_lut(o, sps.chroma_format_idc)
                     for o in offs])


def _steps(fs):
    """(deblocking, SAO): which filters the picture runs."""
    return (not fs.deblock_disabled,
            bool(fs.sps.sao_enabled and (fs.sao_luma or fs.sao_chroma)))


def prep_filters(fs):
    """The host half of one filtered picture's device filtering: the
    control arrays that depend on the picture's structure, where the
    picture has them (the no-filter grids, the CTB-16 stale-read masks,
    the per-CTB SAO parameters: small int16 arrays by name). None when a
    halo pattern falls outside the whole-frame device model (the picture
    then takes the host filters, `plan_filters`). The per-edge
    parameters are made on the device (`edge_params`)."""
    sps = fs.sps
    do_deblock, do_sao = _steps(fs)
    out = {}
    nf = _no_filter_mask(fs)
    if nf is not None:
        out.update(_nofilter_grids(fs, nf, sps.height, sps.width))
    if do_sao and do_deblock and sps.log2_ctb == 4:
        masks = _chroma_stale_reads(fs)
        if masks is None:
            return None          # caller falls back to host filters
        out["st_b0"] = masks[(1, 0)]
        out["st_b2"] = masks[(1, 1)]
        out["st_a3"] = masks[(1, -1)]
    if do_sao:
        # per-CTB params [cH, cW, 3, 6] int16 as-is; luma/chroma gates
        sao = fs.sao.astype(np.int16).copy()
        if not fs.sao_luma:
            sao[:, :, 0, 0] = 0
        if not fs.sao_chroma:
            sao[:, :, 1:, 0] = 0
        out["sao"] = sao
    return out


# =========================================================================
# Per-edge parameters on the device
# =========================================================================

def edge_inputs(fs):
    """`edge_params`' arguments for one picture: (grids, scalars), for
    `edge_params(*grids.values(), **scalars)` once the grids are on the
    device. grids, by name and in that order: pred_mode, cbf, bounds_v,
    bounds_h (uint8), qp (int8), all [gh, gw] as the parser made them
    (CTB-padded), the [2, 96] chroma QP tables qlut (`chroma_qp_luts`),
    then, on a picture with inter blocks, the motion grids pred_flag
    (uint8 [gh, gw]), mv (int16 [gh, gw, 2, 2]: H.265 bounds MVs to 16
    bits) and refpoc (int32 [gh, gw, 2]). A picture without inter blocks
    is intra throughout, where the motion never decides a strength."""
    sps = fs.sps
    grids = dict(pred_mode=np.asarray(fs.pred_mode, np.uint8),
                 cbf=np.asarray(fs.cbf_luma4, np.uint8),
                 bounds_v=np.asarray(fs.bounds_v, np.uint8),
                 bounds_h=np.asarray(fs.bounds_h, np.uint8),
                 qp=np.asarray(fs.qp_y4, np.int8), qlut=chroma_qp_luts(fs))
    if fs.inter_pbs and fs.motion is not None:
        mc = fs.motion
        grids.update(pred_flag=np.asarray(mc.pred_flag, np.uint8),
                     mv=np.asarray(mc.mv, np.int16),
                     refpoc=np.asarray(mc.refpoc, np.int32))
    return grids, dict(H=sps.height, W=sps.width, hs=sps.hshift1,
                       vs=sps.vshift1, bd=sps.bit_depth,
                       bdc=sps.bit_depth_chroma,
                       beta_offset=int(fs.beta_offset),
                       tc_offset=int(fs.tc_offset))


def edge_shapes(H: int, W: int, hs: int, vs: int):
    """Shapes of the eight `EDGE_KEYS` arrays of a H x W picture."""
    Hc, Wc = H >> vs, W >> hs
    v, h = (H >> 2, W >> 3), (H >> 3, W >> 2)
    cv, ch = (Hc >> 2, (Wc + 7) >> 3), ((Hc + 7) >> 3, Wc >> 2)
    return [v, v, h, h, cv, ch, cv, ch]


def _mv_bs_ref(pf, mv, poc, p, q):
    """The MV / reference rule of the boundary strength (`_mv_bs_vec`)
    between the blocks at flat grid indices p and q: int32, 1 where the
    motion differs. `_mv_bs_vec`'s test of identical motion (reference
    indices too) is left out: where it holds, the POC and MV tests below
    give 0 as well."""
    fp, fq = pf[p], pf[q]
    mp, mq = mv[p], mv[q]                        # [..., list, xy]
    p0, p1 = poc[p][..., 0], poc[p][..., 1]
    q0, q1 = poc[q][..., 0], poc[q][..., 1]

    def near(a, b):
        return ((a - b).abs() < 4).all(-1)

    ns0, ns1 = near(mp[..., 0, :], mq[..., 0, :]), \
        near(mp[..., 1, :], mq[..., 1, :])
    nx0, nx1 = near(mp[..., 1, :], mq[..., 0, :]), \
        near(mp[..., 0, :], mq[..., 1, :])
    straight, crossed = ns0 & ns1, nx0 & nx1
    same_all = (q0 == p0) & (q0 == q1) & (p0 == p1)
    bi_zero = torch.where(
        same_all, straight | crossed,
        torch.where((p0 == q0) & (p1 == q1), straight,
                    (p1 == q0) & (p0 == q1) & crossed))
    lp0, lq0 = (fp & 1) != 0, (fq & 1) != 0
    near_u = torch.where(lp0 == lq0, torch.where(lp0, ns0, ns1),
                         torch.where(lp0, nx1, nx0))
    uni_zero = (torch.where(lp0, p0, p1) == torch.where(lq0, q0, q1)) & \
        near_u
    zero = torch.where((fp == 3) & (fq == 3), bi_zero,
                       (fp != 3) & (fq != 3) & uni_zero)
    return (~zero).to(torch.int32)


def edge_params_ref(pm, cbf, bv, bh, qp, qlut, *motion, H, W, hs, vs, bd,
                    bdc, beta_offset, tc_offset):
    """Plain PyTorch version of `edge_params`, segment for segment the
    kernel's arithmetic (csrc/edge_params.cu), on any device; returns the
    eight int16 arrays of `EDGE_KEYS`."""
    dev = pm.device
    gw = pm.shape[1]
    i32 = [t.reshape(-1).to(torch.int32) for t in (pm, cbf, bv, bh, qp)]
    pm_, cbf_, bv_, bh_, qp_ = i32
    if motion:
        pf, mv, poc = motion
        pf = pf.reshape(-1).to(torch.int32)
        mv = mv.reshape(-1, 2, 2).to(torch.int32)
        poc = poc.reshape(-1, 2)
    qlut = qlut.to(torch.int32)
    beta_t = torch.as_tensor(BETA_TABLE, device=dev)
    tc_t = torch.as_tensor(TC_TABLE, device=dev)

    def bs(p, q, tu, ok):
        intra = (pm_[p] == 1) | (pm_[q] == 1)
        anycbf = (cbf_[p] != 0) | (cbf_[q] != 0)
        mvbs = _mv_bs_ref(pf, mv, poc, p, q) if motion else 0
        b = torch.where(intra, torch.where(tu, 2, 0),
                        torch.where(tu & anycbf, 1, mvbs))
        return torch.where(ok, b, 0)

    def vertical(y4, x8):               # the edge at luma column 8 * x8
        q = y4 * gw + 2 * x8
        ok = x8 > 0
        p = torch.where(ok, q - 1, q)
        return p, q, bs(p, q, bv_[q] != 0, ok)

    def horizontal(y8, x4):             # the edge at luma row 8 * y8
        q = 2 * y8 * gw + x4
        ok = y8 > 0
        p = torch.where(ok, q - gw, q)
        return p, q, bs(p, q, bh_[q] != 0, ok)

    def avg_qp(p, q):
        return (qp_[p] + qp_[q] + 1) >> 1

    def luma(p, q, b):
        qpa = avg_qp(p, q)
        beta = beta_t[(qpa + beta_offset).clamp(0, 51)] << (bd - 8)
        tc = tc_t[(qpa + 2 * (b - 1) + tc_offset).clamp(0, 53)] << (bd - 8)
        return (torch.where(b > 0, beta, 0).to(torch.int16),
                torch.where(b > 0, tc, 0).to(torch.int16))

    def chroma(p, q, b):
        c = avg_qp(p, q).clamp(-32, 63) + 32
        return [torch.where(b == 2, tc_t[(lut[c] + 2 + tc_offset)
                                         .clamp(0, 53)] << (bdc - 8), 0)
                .to(torch.int16) for lut in qlut]

    def ar(n, shift=0):
        return torch.arange(n, device=dev) << shift

    v, _, h, _, cv, ch, _, _ = edge_shapes(H, W, hs, vs)
    beta_v, tc_v = luma(*vertical(ar(v[0])[:, None], ar(v[1])[None, :]))
    beta_h, tc_h = luma(*horizontal(ar(h[0])[:, None], ar(h[1])[None, :]))
    tc_cv1, tc_cv2 = chroma(*vertical(ar(cv[0], vs)[:, None],
                                      ar(cv[1], hs)[None, :]))
    tc_ch1, tc_ch2 = chroma(*horizontal(ar(ch[0], vs)[:, None],
                                        ar(ch[1], hs)[None, :]))
    return beta_v, tc_v, beta_h, tc_h, tc_cv1, tc_ch1, tc_cv2, tc_ch2


# name, dtype and trailing dims of each grid `edge_params` takes
_EDGE_GRIDS = (("pred_mode", torch.uint8, ()), ("cbf", torch.uint8, ()),
               ("bounds_v", torch.uint8, ()), ("bounds_h", torch.uint8, ()),
               ("qp", torch.int8, ()), ("pred_flag", torch.uint8, ()),
               ("mv", torch.int16, (2, 2)), ("refpoc", torch.int32, (2,)))


def _check_edges(grids, qlut, H, W, hs, vs, bd, bdc):
    dev = grids[0].device
    shape = tuple(grids[0].shape)
    if len(grids) not in (5, 8):
        raise ValueError(f"{len(grids) - 5} motion grids: want 0 or 3")
    for (name, dt, tail), t in zip(_EDGE_GRIDS, grids):
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dt}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, pred_mode on {dev}")
        if tuple(t.shape) != shape + tail:
            raise ValueError(f"{name} {tuple(t.shape)} with grids {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if qlut.dtype != torch.int32 or tuple(qlut.shape) != (2, 96) or \
            qlut.device != dev or not qlut.is_contiguous():
        raise ValueError(f"qlut {qlut.dtype} {tuple(qlut.shape)} on "
                         f"{qlut.device}: want contiguous int32 [2, 96]")
    if H <= 0 or W <= 0 or H % 8 or W % 8 or len(shape) != 2 or \
            shape[0] < H >> 2 or shape[1] < W >> 2:
        raise ValueError(f"picture {W}x{H} with grids {shape}")
    if hs not in (0, 1) or vs not in (0, 1) or not 8 <= bd <= 16 or \
            not 8 <= bdc <= 16:
        raise ValueError(f"hs {hs}, vs {vs}, bit depths {bd} / {bdc}")


def edge_params(pm, cbf, bv, bh, qp, qlut, *motion, H, W, hs, vs, bd, bdc,
                beta_offset, tc_offset):
    """The deblocking filter's per-edge parameters of a H x W picture,
    the eight int16 arrays of `EDGE_KEYS` that `apply_filters_device`
    takes, from the picture's per-4x4 grids (`edge_inputs`): pm, cbf, bv,
    bh uint8 and qp int8 [gh, gw] (gh >= H / 4, gw >= W / 4), qlut int32
    [2, 96], then on a picture with inter blocks the motion: pred_flag
    uint8 [gh, gw], mv int16 [gh, gw, 2, 2], refpoc int32 [gh, gw, 2].
    Equal, array for array, to `edge_params_ref`.

    CUDA tensors make ONE launch of csrc/edge_params.cu on the current
    stream into one new buffer and count it; CPU tensors run
    `edge_params_ref`."""
    grids = [pm, cbf, bv, bh, qp]
    _check_edges(grids + list(motion), qlut, H, W, hs, vs, bd, bdc)
    kw = dict(H=H, W=W, hs=hs, vs=vs, bd=bd, bdc=bdc,
              beta_offset=beta_offset, tc_offset=tc_offset)
    if pm.device.type == "cpu":
        return edge_params_ref(*grids, qlut, *motion, **kw)
    if pm.device.type != "cuda":
        raise ValueError(f"unsupported device {pm.device}")
    shapes = edge_shapes(H, W, hs, vs)
    sizes = [a * b for a, b in shapes]
    out = torch.empty(sum(sizes), dtype=torch.int16, device=pm.device)
    pf, mv, poc = [t.data_ptr() for t in motion] or [None] * 3
    lib = kernels.load("edge_params", _SIGNATURES["edge_params"])
    with torch.cuda.device(pm.device):
        rc = lib.edge_params_launch(
            *(t.data_ptr() for t in grids), pf, mv, poc, pm.shape[1],
            qlut.data_ptr(), out.data_ptr(), H, W, hs, vs, bd, bdc,
            beta_offset, tc_offset, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge_params launch failed: cudaError_t {rc}")
    edge_params.launches += 1
    return tuple(a.view(s) for a, s in zip(out.split(sizes), shapes))


edge_params.launches = 0


# {library: {C function: argument types}} of the kernels in this module
# (`kernels.load`)
_P, _I = ctypes.c_void_p, ctypes.c_int
_PP, _PI = ctypes.POINTER(_P), ctypes.POINTER(_I)
_SIGNATURES = {
    "edge_params": {
        "edge_params_launch": [_P] * 8 + [_I, _P, _P] + [_I] * 8 + [_P]},
    "loop_filters": {
        "deblock_launch": [_I, _PP, _PP, _PI, _PP, _I, _I, _P],
        "sao_launch": [_PP, _PP, _PP, _PI, _PP, _PI, _PP, _P, _I, _I, _I,
                       _P]}}


# =========================================================================
# Device side
# =========================================================================

def _shift_params(a):
    """Edge-window k holds edge x8=k+1: roll params so index k matches
    (last column wraps to edge 0 == picture edge, always inactive)."""
    return torch.roll(a.to(torch.int32), -1, 1)


def _windows(pl, shift: int, H4: int, W8: int):
    """[H, 8 * W8] plane -> [H4, W8, line, col] windows of 8 columns
    starting `shift` columns in (wrapping). `reshape` copies where the
    rolled plane is not contiguous (the transposed passes)."""
    return torch.roll(pl, -shift, 1).reshape(H4, 4, W8, 8).permute(0, 2, 1, 3)


def _unwindows(w, shift: int, H: int, W: int):
    return torch.roll(w.permute(0, 2, 1, 3).reshape(H, W), shift, 1)


def _deblock_luma_dir(pl, beta_e, tc_e, bd: int, nop_e=None, noq_e=None):
    """One direction of luma deblocking over the whole plane.
    pl [H, W] int32, vertical edges at x=8k; beta/tc [H//4, W//8]
    (0 where inactive). nop/noq: per-segment PCM/tqb write suppression.
    Bit-exact to the scalar edge filter (8.7.2.5.3-7)."""
    H, W = pl.shape
    H4, W8 = H // 4, W // 8
    w = _windows(pl, 4, H4, W8)
    beta = _shift_params(beta_e)[:, :, None]        # [H4, W8, 1]
    tc = _shift_params(tc_e)[:, :, None]
    l0 = w[:, :, 0, :]
    l3 = w[:, :, 3, :]

    def dpq(ln):
        dp = (ln[..., 1] - 2 * ln[..., 2] + ln[..., 3]).abs()
        dq = (ln[..., 6] - 2 * ln[..., 5] + ln[..., 4]).abs()
        return dp, dq

    dp0, dq0 = dpq(l0)
    dp3, dq3 = dpq(l3)
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    b = beta[..., 0]
    t = tc[..., 0]
    filt = (t > 0) & (d0 + d3 < b)

    def strong_line(ln, d):
        return ((2 * d < (b >> 2)) &
                ((ln[..., 0] - ln[..., 3]).abs() +
                 (ln[..., 4] - ln[..., 7]).abs() < (b >> 3)) &
                ((ln[..., 3] - ln[..., 4]).abs() < ((5 * t + 1) >> 1)))

    strong = filt & strong_line(l0, d0) & strong_line(l3, d3)

    p3, p2, p1, p0, q0, q1, q2, q3 = w.unbind(-1)
    tc2 = 2 * tc
    # ---- strong filter ----
    sp0 = torch.clamp((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      p0 - tc2, p0 + tc2)
    sp1 = torch.clamp((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2)
    sp2 = torch.clamp((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                      p2 - tc2, p2 + tc2)
    sq0 = torch.clamp((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                      q0 - tc2, q0 + tc2)
    sq1 = torch.clamp((p0 + q0 + q1 + q2 + 2) >> 2, q1 - tc2, q1 + tc2)
    sq2 = torch.clamp((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                      q2 - tc2, q2 + tc2)
    # ---- normal filter ----
    maxv = (1 << bd) - 1
    side = (b + (b >> 1)) >> 3
    nd_p = (dp0 + dp3 < side)[:, :, None]
    nd_q = (dq0 + dq3 < side)[:, :, None]
    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    dok = delta0.abs() < 10 * tc
    delta = torch.clamp(delta0, -tc, tc)
    np0 = (p0 + delta).clamp(0, maxv)
    nq0 = (q0 - delta).clamp(0, maxv)
    tch = tc >> 1
    dp = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tch, tch)
    np1 = (p1 + dp).clamp(0, maxv)
    dq = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tch, tch)
    nq1 = (q1 + dq).clamp(0, maxv)

    sm = strong[:, :, None]
    fm = (filt & ~strong)[:, :, None] & dok
    out_p0 = torch.where(sm, sp0, torch.where(fm, np0, p0))
    out_p1 = torch.where(sm, sp1, torch.where(fm & nd_p, np1, p1))
    out_p2 = torch.where(sm, sp2, p2)
    out_q0 = torch.where(sm, sq0, torch.where(fm, nq0, q0))
    out_q1 = torch.where(sm, sq1, torch.where(fm & nd_q, nq1, q1))
    out_q2 = torch.where(sm, sq2, q2)
    if nop_e is not None and nop_e.shape == beta_e.shape:
        keep_p = _shift_params(nop_e)[:, :, None] > 0
        keep_q = _shift_params(noq_e)[:, :, None] > 0
        out_p0 = torch.where(keep_p, p0, out_p0)
        out_p1 = torch.where(keep_p, p1, out_p1)
        out_p2 = torch.where(keep_p, p2, out_p2)
        out_q0 = torch.where(keep_q, q0, out_q0)
        out_q1 = torch.where(keep_q, q1, out_q1)
        out_q2 = torch.where(keep_q, q2, out_q2)
    new = torch.stack([p3, out_p2, out_p1, out_p0,
                       out_q0, out_q1, out_q2, q3], dim=-1)
    return _unwindows(new, 4, H, W)


def _deblock_chroma_dir(pl, tc_e, bd: int, nop_e=None, noq_e=None):
    """Chroma deblocking, one direction: edges every 8 chroma samples,
    tc [Hc//4, ceil(Wc/8)] already zeroed where bs != 2. nop/noq:
    PCM/tqb write suppression per segment. Chroma dims need not be
    multiples of 8 (1080p 4:2:0 has Hc=540): the plane pads to the
    ceil window count so the final in-picture edge (e.g. chroma 536)
    is filtered."""
    H, Wc_in = pl.shape
    W8 = (Wc_in + 7) // 8
    W = W8 * 8
    if W != Wc_in:
        pl = torch.cat([pl, pl.new_zeros((H, W - Wc_in))], 1)
    H4 = H // 4
    w = _windows(pl, 6, H4, W8)
    tc = _shift_params(tc_e)[:, :, None]
    p1, p0, q0, q1 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    maxv = (1 << bd) - 1
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    act = tc > 0
    if nop_e is not None and nop_e.shape == tc_e.shape:
        keep_p = _shift_params(nop_e)[:, :, None] > 0
        keep_q = _shift_params(noq_e)[:, :, None] > 0
    else:
        keep_p = keep_q = torch.zeros_like(act)
    np0 = torch.where(act & ~keep_p, (p0 + delta).clamp(0, maxv), p0)
    nq0 = torch.where(act & ~keep_q, (q0 - delta).clamp(0, maxv), q0)
    new = torch.cat([torch.stack([p1, np0, nq0, q1], dim=-1), w[..., 4:]],
                    dim=-1)
    return _unwindows(new, 6, H, W)[:, :Wc_in]


def _expand_ctb(a, cs, H: int, W: int):
    """Per-CTB values -> per-pixel grid, gather-free (broadcast+reshape).
    cs: int (square) or (csy, csx) for non-square chroma CTBs (4:2:2)."""
    csy, csx = (cs, cs) if isinstance(cs, int) else cs
    cH, cW = a.shape
    g = a[:, None, :, None].expand(cH, csy, cW, csx)
    return g.reshape(cH * csy, cW * csx)[:H, :W]


def _sao_component(pl, typ, second, offs, cs, bd: int,
                   vstage=None, st_b0=None, st_b2=None, st_a3=None,
                   ybounds=None):
    """SAO one component. pl [H, W] int32 (deblocked input); typ/second
    [cH, cW]; offs [cH, cW, 4]. vstage/stale: 16x16-CTB chroma halo
    timing: neighbour reads in the +x direction of `stale` positions
    source the vertical-deblock-stage plane. ybounds: (ytop, ybot), the
    TRUE picture rows in this plane's coordinates when pl is a halo band
    of a larger frame (the mesh's band-sharded filters); the edge
    classes' border restrictions apply there instead of at the array
    edges."""
    H, W = pl.shape
    maxv = (1 << bd) - 1
    typ_px = _expand_ctb(typ, cs, H, W)
    sec_px = _expand_ctb(second, cs, H, W)
    o = [_expand_ctb(offs[:, :, k], cs, H, W) for k in range(4)]

    # ---- band ----
    band = pl >> (bd - 5)
    badd = torch.zeros_like(pl)
    for k in range(4):
        badd = badd + torch.where(band == ((sec_px + k) & 31), o[k], 0)
    out_band = (pl + badd).clamp(0, maxv)

    # stale-read patching (16x16 CTBs): center-space masks say which
    # +x neighbor reads land on positions whose horizontal deblock the
    # schedule runs after this CTB's SAO: those reads source the
    # vertical-stage plane instead
    use_stale = (vstage is not None and st_b0 is not None and
                 st_b0.shape == pl.shape)

    # ---- edge (all 4 classes, select by sec_px) ----
    yy = torch.arange(H, device=pl.device)[:, None]
    xx = torch.arange(W, device=pl.device)[None, :]
    neigh = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
             ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))
    out_edge = pl
    for eo, ((ax, ay), (bx, by)) in enumerate(neigh):
        a = torch.roll(pl, (-ay, -ax), (0, 1))
        bq = torch.roll(pl, (-by, -bx), (0, 1))
        if use_stale:
            if eo == 0:
                bq = torch.where(st_b0 > 0,
                                 torch.roll(vstage, (-by, -bx), (0, 1)), bq)
            elif eo == 2:
                bq = torch.where(st_b2 > 0,
                                 torch.roll(vstage, (-by, -bx), (0, 1)), bq)
            elif eo == 3:
                a = torch.where(st_a3 > 0,
                                torch.roll(vstage, (-ay, -ax), (0, 1)), a)
        idx = 2 + torch.sign(pl - a) + torch.sign(pl - bq)
        eadd = (torch.where(idx == 0, o[0], 0) +
                torch.where(idx == 1, o[1], 0) +
                torch.where(idx == 3, o[2], 0) +
                torch.where(idx == 4, o[3], 0))
        ytop, ybot = (0, H) if ybounds is None else ybounds
        valid = ((xx >= max(0, -min(ax, bx, 0))) &
                 (xx < W - max(ax, bx, 0)) &
                 (yy >= ytop - min(ay, by, 0)) &
                 (yy < ybot - max(ay, by, 0)))
        res = torch.where(valid, (pl + eadd).clamp(0, maxv), pl)
        out_edge = torch.where(sec_px == eo, res, out_edge)

    return torch.where(typ_px == 1, out_band,
                       torch.where(typ_px == 2, out_edge, pl))


def apply_filters_ref(y, cb, cr, beta_v, tc_v, beta_h, tc_h,
                      tc_cv1, tc_ch1, tc_cv2, tc_ch2, sao,
                      nop_v, noq_v, nop_h, noq_h,
                      nop_cv, noq_cv, nop_ch, noq_ch, nf4, nf4c,
                      st_b0, st_b2, st_a3, ybounds=None,
                      *, bd, bdc, cs, do_deblock, do_sao, hs=1, vs=1,
                      stage=contextlib.nullcontext):
    """Plain PyTorch version of `apply_filters_device` (whole-plane torch
    ops, on any device): whole-frame deblock (vertical then horizontal,
    luma + chroma) followed by SAO. y [H, W], cb/cr [Hc, Wc] int32 (views
    are fine: nothing is written in place); returns new (y, cb, cr).
    nop*/noq*/nf4: PCM/tqb no-filter suppression + restore ((1,1)
    placeholders when absent); st_*: 16x16-CTB SAO chroma halo positions.
    hs/vs: chroma subsampling shifts (1,1=4:2:0; 1,0=4:2:2; 0,0=4:4:4).
    `stage(name)` is a context manager entered around "deblock" and "sao"
    (the engine's stage timers). ybounds: ((ytop, ybot), (cytop, cybot)),
    the picture's true luma and chroma rows when y / cb / cr are a halo
    band of a larger frame (parallel/mesh.py `band_filters`), else
    None."""
    vst_cb = vst_cr = None
    if do_deblock:
        with stage("deblock"):
            y = _deblock_luma_dir(y, beta_v, tc_v, bd, nop_v, noq_v)
            y = _deblock_luma_dir(y.T, beta_h.T, tc_h.T, bd,
                                  nop_h.T, noq_h.T).T
            cb = _deblock_chroma_dir(cb, tc_cv1, bdc, nop_cv, noq_cv)
            cr = _deblock_chroma_dir(cr, tc_cv2, bdc, nop_cv, noq_cv)
            if do_sao and cs == 16:
                vst_cb, vst_cr = cb, cr    # vertical-stage snapshot
            cb = _deblock_chroma_dir(cb.T, tc_ch1.T, bdc,
                                     nop_ch.T, noq_ch.T).T
            cr = _deblock_chroma_dir(cr.T, tc_ch2.T, bdc,
                                     nop_ch.T, noq_ch.T).T
    if do_sao:
        with stage("sao"):
            pre_y, pre_cb, pre_cr = y, cb, cr
            csc = (cs >> vs, cs >> hs)     # chroma CTB (rows, cols)
            yb, cyb = (None, None) if ybounds is None else ybounds
            s32 = sao.to(torch.int32)
            y = _sao_component(y, s32[:, :, 0, 0], s32[:, :, 0, 1],
                               s32[:, :, 0, 2:6], cs, bd, ybounds=yb)
            cb = _sao_component(cb, s32[:, :, 1, 0], s32[:, :, 1, 1],
                                s32[:, :, 1, 2:6], csc, bdc, vst_cb,
                                st_b0, st_b2, st_a3, ybounds=cyb)
            cr = _sao_component(cr, s32[:, :, 2, 0], s32[:, :, 2, 1],
                                s32[:, :, 2, 2:6], csc, bdc, vst_cr,
                                st_b0, st_b2, st_a3, ybounds=cyb)
            if nf4.shape != (1, 1):
                # restore_tqb_pixels: SAO writes to no-filter blocks
                # revert to the deblocked input (4x4 luma /
                # (4>>vs)x(4>>hs) chroma per block)
                H, W = y.shape
                Hc, Wc = cb.shape
                m = (nf4 > 0).repeat_interleave(4, 0) \
                    .repeat_interleave(4, 1)[:H, :W]
                mc = (nf4c > 0).repeat_interleave(4 >> vs, 0) \
                    .repeat_interleave(4 >> hs, 1)[:Hc, :Wc]
                y = torch.where(m, pre_y, y)
                cb = torch.where(mc, pre_cb, cb)
                cr = torch.where(mc, pre_cr, cr)
    return y, cb, cr


def _check_filters(planes, fargs, ybounds, bd, bdc, cs, do_deblock, do_sao,
                   hs, vs):
    """Raise on what the kernels of csrc/loop_filters.cu do not take."""
    dev = planes[0].device
    for name, t in zip(("y", "cb", "cr"), planes):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, y on {dev}")
        if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name} {tuple(t.shape)} with strides "
                             f"{t.stride()}: want 2-D with contiguous rows")
    (H, W), (Hc, Wc) = planes[0].shape, planes[1].shape
    if hs not in (0, 1) or vs not in (0, 1) or not 8 <= bd <= 16 or \
            not 8 <= bdc <= 16 or cs not in (16, 32, 64):
        raise ValueError(f"hs {hs}, vs {vs}, bit depths {bd} / {bdc}, "
                         f"CTB {cs}")
    if tuple(planes[2].shape) != (Hc, Wc) or (Hc, Wc) != (H >> vs, W >> hs) \
            or H % 8 or W % 8 or Hc % 4 or Wc % 4 or not H:
        raise ValueError(f"planes {W}x{H}, {Wc}x{Hc}, "
                         f"{tuple(planes[2].shape)[::-1]} with hs {hs}, "
                         f"vs {vs}")
    shapes = dict(zip(EDGE_KEYS, edge_shapes(H, W, hs, vs)))
    for k, t in zip(FARG_KEYS, fargs):
        if t.dtype != torch.int16:
            raise TypeError(f"{k}: dtype {t.dtype}, want torch.int16")
        if t.device != dev:
            raise ValueError(f"{k} on {t.device}, y on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{k} is not contiguous")
        if do_deblock and k in EDGE_KEYS and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k} {tuple(t.shape)}, want {shapes[k]}")
    a = dict(zip(FARG_KEYS, fargs))
    if do_deblock:
        # a no-filter array is a (1, 1) placeholder or its tc array's shape
        for k, tc in (("nop_v", "tc_v"), ("noq_v", "tc_v"),
                      ("nop_h", "tc_h"), ("noq_h", "tc_h"),
                      ("nop_cv", "tc_cv1"), ("noq_cv", "tc_cv1"),
                      ("nop_ch", "tc_ch1"), ("noq_ch", "tc_ch1")):
            if tuple(a[k].shape) not in ((1, 1), shapes[tc]):
                raise ValueError(f"{k} {tuple(a[k].shape)}, want (1, 1) "
                                 f"or {shapes[tc]}")
    if do_sao:
        s = tuple(a["sao"].shape)
        if len(s) != 4 or s[2:] != (3, 6) or s[0] * cs < H or s[1] * cs < W:
            raise ValueError(f"sao {s} for a {W}x{H} picture of CTB {cs}")
        if tuple(a["nf4"].shape) != (1, 1):
            # a flag a 4x4 luma block: (4 >> vs) x (4 >> hs) chroma samples
            for k, h, w, n, m in (("nf4", H, W, 4, 4),
                                  ("nf4c", Hc, Wc, 4 >> vs, 4 >> hs)):
                if a[k].dim() != 2 or a[k].shape[0] * n < h or \
                        a[k].shape[1] * m < w:
                    raise ValueError(f"{k} {tuple(a[k].shape)} does not "
                                     f"cover a {w}x{h} plane")
        st = {tuple(a[k].shape) for k in ("st_b0", "st_b2", "st_a3")}
        if st not in ({(1, 1)}, {(Hc, Wc)}):
            raise ValueError(f"st_b0 / st_b2 / st_a3 {sorted(st)}, want "
                             f"all (1, 1) or all {(Hc, Wc)}")
    if ybounds is not None and (len(ybounds) != 2 or
                                any(len(b) != 2 for b in ybounds)):
        raise ValueError(f"ybounds {ybounds}: want ((ytop, ybot), "
                         f"(cytop, cybot))")


def apply_filters_device(y, cb, cr, beta_v, tc_v, beta_h, tc_h,
                         tc_cv1, tc_ch1, tc_cv2, tc_ch2, sao,
                         nop_v, noq_v, nop_h, noq_h,
                         nop_cv, noq_cv, nop_ch, noq_ch, nf4, nf4c,
                         st_b0, st_b2, st_a3, ybounds=None,
                         *, bd, bdc, cs, do_deblock, do_sao, hs=1, vs=1,
                         stage=contextlib.nullcontext):
    """The in-loop filters of a picture (or of a halo band of one):
    deblocking, vertical then horizontal edges, then SAO, on int32 planes
    y [H, W], cb / cr [Hc, Wc] (views with contiguous rows are fine:
    nothing is written in place); returns new (y, cb, cr). The control
    arrays are int16, as `prep_filters` and `edge_params` make them, in
    the order of `FARG_KEYS` ((1, 1) placeholders, (1, 1, 3, 6) for
    `sao`, where a picture has none: `FilterPlan.apply` fills them in);
    the arguments are `apply_filters_ref`'s.

    CUDA tensors make at most THREE launches of csrc/loop_filters.cu on
    the current stream (vertical edges and horizontal edges inside
    `stage("deblock")`, SAO inside `stage("sao")`; none for a step the
    picture skips) into new buffers, and count them in `.launches`; CPU
    tensors run `apply_filters_ref`. Equal, sample for sample, to
    `apply_filters_ref`."""
    fargs = (beta_v, tc_v, beta_h, tc_h, tc_cv1, tc_ch1, tc_cv2, tc_ch2,
             sao, nop_v, noq_v, nop_h, noq_h, nop_cv, noq_cv, nop_ch,
             noq_ch, nf4, nf4c, st_b0, st_b2, st_a3)
    _check_filters((y, cb, cr), fargs, ybounds, bd, bdc, cs, do_deblock,
                   do_sao, hs, vs)
    kw = dict(bd=bd, bdc=bdc, cs=cs, do_deblock=do_deblock, do_sao=do_sao,
              hs=hs, vs=vs, stage=stage)
    if y.device.type == "cpu":
        return apply_filters_ref(y, cb, cr, *fargs, ybounds, **kw)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    with torch.cuda.device(y.device):
        return _filters_cuda((y, cb, cr), dict(zip(FARG_KEYS, fargs)),
                             ybounds, **kw)


apply_filters_device.launches = 0
# the kernels count on the function itself, also while a caller's spy
# stands in for this module's name of it (the plan calls it by that name)
_FILTERS = apply_filters_device


def _filters_cuda(planes, a, ybounds, *, bd, bdc, cs, do_deblock, do_sao,
                  hs, vs, stage):
    """`apply_filters_device`'s launches on the current card."""
    lib = kernels.load("loop_filters", _SIGNATURES["loop_filters"])
    stream = torch.cuda.current_stream().cuda_stream
    (H, W), (Hc, Wc) = planes[0].shape, planes[1].shape
    dims = ((H, W), (Hc, Wc), (Hc, Wc))

    def empty(n_chroma):     # Y and n_chroma chroma planes, one buffer
        buf = torch.empty(H * W + n_chroma * Hc * Wc, dtype=torch.int32,
                          device=planes[0].device)
        return [t.view(s) for t, s in zip(
            buf.split([H * W] + [Hc * Wc] * n_chroma), dims + dims[1:])]

    def opt(t, like):        # a no-filter array, or None for a placeholder
        return t if t.shape == like.shape else None     # (`_check_filters`)

    def ptrs(ts):
        return (_P * len(ts))(*(None if t is None else t.data_ptr()
                                for t in ts))

    def deblock(vertical, src, dst, edges):
        d = [v for s, t in zip(src, dst) for v in (*s.shape, s.stride(0),
                                                  t.stride(0))]
        rc = lib.deblock_launch(int(vertical), ptrs(src), ptrs(dst),
                                (_I * 12)(*d), ptrs(edges), bd, bdc, stream)
        if rc != 0:
            raise RuntimeError(f"deblock launch failed: cudaError_t {rc}")
        _FILTERS.launches += 1

    vst = [None] * 3
    # SAO's stale-read rule reads the vertical stage's chroma (CTB 16)
    snap = do_deblock and do_sao and cs == 16 and \
        a["st_b0"].shape == (Hc, Wc)
    if do_deblock:
        with stage("deblock"):
            out = empty(4 if snap else 2)
            v_edges = [a["beta_v"], a["tc_v"], opt(a["nop_v"], a["tc_v"]),
                       opt(a["noq_v"], a["tc_v"])]
            h_edges = [a["beta_h"], a["tc_h"], opt(a["nop_h"], a["tc_h"]),
                       opt(a["noq_h"], a["tc_h"])]
            for c in ("1", "2"):
                tv, th = a["tc_cv" + c], a["tc_ch" + c]
                v_edges += [None, tv, opt(a["nop_cv"], tv),
                            opt(a["noq_cv"], tv)]
                h_edges += [None, th, opt(a["nop_ch"], th),
                            opt(a["noq_ch"], th)]
            deblock(True, planes, out[:3], v_edges)
            # a 16x16-CTB picture with SAO keeps the vertical stage's
            # chroma for the stale-read masks: horizontal edges write new
            # chroma planes there, and work in place everywhere else
            done = [out[0], *out[3:]] if snap else out
            deblock(False, out[:3], done, h_edges)
            if snap:
                vst = [None, out[1], out[2]]
            planes = done
    if do_sao:
        with stage("sao"):
            out = empty(2)
            yb = ((0, H), (0, Hc)) if ybounds is None else ybounds
            d = []       # h, w, pitch, vst pitch, CTB rows, cols, true rows
            for c, p in enumerate(planes):
                d += [*p.shape, p.stride(0), Wc, cs >> (vs if c else 0),
                      cs >> (hs if c else 0), *yb[c > 0]]
            nf = [None, None] if a["nf4"].shape == (1, 1) else \
                [a["nf4"], a["nf4c"]]
            nf_dims = (a["nf4"].shape[1], 4, 4) + \
                (a["nf4c"].shape[1], 4 >> vs, 4 >> hs) * 2
            st = [a["st_b0"], a["st_b2"], a["st_a3"]] if snap else [None] * 3
            rc = lib.sao_launch(ptrs(planes), ptrs(vst), ptrs(out),
                                (_I * 24)(*d), ptrs(nf), (_I * 9)(*nf_dims),
                                ptrs(st), a["sao"].data_ptr(),
                                a["sao"].shape[1], bd, bdc, stream)
            if rc != 0:
                raise RuntimeError(f"sao launch failed: cudaError_t {rc}")
            _FILTERS.launches += 1
            planes = out
    return tuple(planes)


# =========================================================================
# The filter plan: the one entry point of the engine and the mesh
# =========================================================================

@functools.lru_cache(maxsize=None)
def _placeholder(device: torch.device, sao: bool) -> torch.Tensor:
    """The (1, 1) int16 stand-in ((1, 1, 3, 6) for `sao`) of a control
    array a picture does not have: one per device for the whole process,
    never uploaded with a picture. The kernels and the plain version read
    only its shape."""
    return torch.zeros((1, 1, 3, 6) if sao else (1, 1), dtype=torch.int16,
                       device=device)


@contextlib.contextmanager
def _annotated(stage, name, kernel):
    with stage(name):
        trace.annotate(kernel=kernel)
        yield


class FilterPlan:
    """How one picture's in-loop filters run (`plan_filters`).

    route: "device" (the whole-frame model: `edge_params`, then
    `apply_filters_device`) or "host" (outside that model: the caller
    fetches the unfiltered picture and filters it on the host, on the
    reference's CTB schedule, ops/filters_sched.py). do_deblock, do_sao,
    cs (CTB size), hs, vs, bd, bdc: the picture's steps and format.
    controls: {name: int16 numpy array}, the control arrays the picture
    has (`prep_filters`; a picture lacks those it does not need). grids
    and edge_kw: the per-4x4 grids and scalars `edge_params` makes the
    per-edge parameters from (`edge_inputs`; empty unless the picture is
    deblocked on the device). `arrays` is what rides in the picture's
    upload."""

    def __init__(self, route, do_deblock, do_sao, fs, controls=None,
                 grids=None, edge_kw=None):
        sps = fs.sps
        self.route, self.do_deblock, self.do_sao = route, do_deblock, do_sao
        self.cs, self.hs, self.vs = 1 << sps.log2_ctb, sps.hshift1, \
            sps.vshift1
        self.bd, self.bdc = sps.bit_depth, sps.bit_depth_chroma
        self.controls = controls or {}
        self.grids = grids or {}
        self.edge_kw = edge_kw or {}

    @property
    def arrays(self) -> dict:
        """{name: numpy array}: the control arrays and the grids."""
        return {**self.controls, **self.grids}

    def args(self, up: dict, stage=trace.span) -> dict:
        """The filters' arguments by name from `up`, the picture's upload
        ({name: tensor}; it holds `grids`, and `arrays` on the engine's
        route): each control array as uploaded (the numpy array where
        `up` lacks it: a band is cut from it later), and, on a deblocked
        picture, the eight per-edge arrays that ONE `edge_params` launch
        makes from the uploaded grids, inside stage("edge_params") with
        `kernel` 1 on its span."""
        out = {k: up.get(k, a) for k, a in self.controls.items()}
        if self.grids:
            with _annotated(stage, "edge_params", 1):
                out.update(zip(EDGE_KEYS, edge_params(
                    *(up[k] for k in self.grids), **self.edge_kw)))
        return out

    def apply(self, y, cb, cr, args: dict, stage=None, ybounds=None):
        """`apply_filters_device` on int32 planes y, cb, cr (the picture's,
        or a halo band of them with `ybounds`) with `args` (`args`' names,
        as tensors on the planes' device); a control array the picture
        lacks is a placeholder. stage(name), where given, is entered
        around "deblock" and "sao", each span annotated with `kernel` (1:
        the kernels of csrc/loop_filters.cu on a card, 0: the plain
        version). Returns new (y, cb, cr)."""
        dev = y.device
        fargs = [args[k] if k in args else _placeholder(dev, k == "sao")
                 for k in FARG_KEYS]
        kernel = int(dev.type == "cuda")
        spans = contextlib.nullcontext if stage is None else \
            (lambda name: _annotated(stage, name, kernel))
        return apply_filters_device(
            y, cb, cr, *fargs, ybounds, bd=self.bd, bdc=self.bdc, cs=self.cs,
            do_deblock=self.do_deblock, do_sao=self.do_sao, hs=self.hs,
            vs=self.vs, stage=spans)


def plan_filters(fs):
    """The in-loop filter plan of one picture (`FilterPlan`), or None for a
    picture with no filters. The one place where the route is chosen: the
    device where `prep_filters` models the picture, else the host."""
    do_deblock, do_sao = _steps(fs)
    if not do_deblock and not do_sao:
        return None
    controls = prep_filters(fs)
    if controls is None:
        return FilterPlan("host", do_deblock, do_sao, fs)
    grids, edge_kw = edge_inputs(fs) if do_deblock else (None, None)
    return FilterPlan("device", do_deblock, do_sao, fs, controls, grids,
                      edge_kw)
