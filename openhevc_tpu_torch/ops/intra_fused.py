"""Fused intra reconstruction: every intra TU of a frame in one kernel
launch, the jobs of each wavefront level side by side.

Counterpart of the JAX package's ops/intra_fused.py (`_build`, the
whole-frame Pallas kernel, `_build_banded`, its banded twin for large
frames, and their per-TU body `_job`). The hand-written CUDA kernels
live in csrc/intra_fused.cu and csrc/intra_fused_banded.cu (scheduler
shared in csrc/intra_sched.cuh, per-TU body in csrc/intra_job.cuh); this
module holds what surrounds them:

  - the padded plane layout (origin (OY, OX) = (8, 128), bottom pad 48
    rows, right pad to a 128 multiple + 256), kept from the JAX package
    so every neighbour read up to x + 2s stays in bounds;
  - the banded layout (`band_plan`) and the stable band sort of the
    job meta (`sort_meta_by_band`);
  - the cut of a picture's jobs to one tile group, with the levels
    renumbered densely (`meta6_tile_group`, `tile_group_of`: a tile
    shard of parallel/mesh.py);
  - `derive_meta16`: the kernel's [16, npad] job meta from the 5 packed
    rows the native parser emits;
  - `level_schedule`: the jobs' order by wavefront level and the level
    bounds, from the level the native parser gives each job;
  - `intra_fused_ref` / `intra_fused_banded_ref`: the plain PyTorch
    versions (a Python loop over jobs, tensor ops per TU), used for CPU
    tensors and as the yardstick the kernels are held against on the
    card;
  - `intra_fused` / `intra_fused_banded`: the wrappers of the
    level-parallel kernels, and `intra_fused_serial`, the serial-order
    entry kept for checking, each with its launch counter.

Levels. A job's level is 1 + the highest level among the jobs that
wrote its available neighbours (0 where the neighbour was not written
by a job: PCM samples, and the inter prediction of an inter picture, are
in the planes before the kernel starts). Jobs of one level are independent; level L may
start when levels below L are done. The planes never depend on each
other, so one level index serves all three.

Bit-exact with the JAX package's ops/intra_np.py (hevcpred_template.c:
intra_pred :30, pred_planar :359, pred_dc :388, pred_angular :419;
substitution 8.4.4.2.2, filtering 8.4.4.2.3).

Meta rows: 0 y(buf) 1 x(buf) 2 size_log2-2 3 mode 4 plane 5 do_filter
6 avail word0 (groups 0..15) 7 avail word1 (16..31) 8 angle 9 inv_angle
10 strong_allowed 11 any_avail 12 edge_filters 13 avail bit 32.
Availability is one bit per 4-sample group in spec order
[left s/2 groups (bottom->top) | corner | top s/2 groups].
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .tables import TABLES

OY, OX = 8, 128
BOT, RIGHT = 48, 256
# csrc/intra_sched.cuh: a block's 8 warps form kWarpsPerBlock / kTeam
# teams, each running one job at a time
TEAMS_PER_BLOCK = 2


def padded_dims(h: int, w: int) -> tuple[int, int]:
    hp = (OY + h + BOT + 7) & ~7
    wp = OX + ((w + 127) & ~127) + RIGHT
    return hp, wp


# Banded layout. These constants are the JAX package's selection rule
# for `_build_banded` (CTB-row bands slid through a TPU's VMEM scratch),
# kept as they are so that the port takes its banded kernel on exactly
# the streams where the JAX package takes `_build_banded`. Whether the
# band order pays on a GPU is measured (PERF.md), not a knob.
SCR_PAD = 64                 # rows below the last band for window overrun
VMEM_SCRATCH_BUDGET = 9 * 2 ** 20


def band_scratch_bytes(band_h, W, Wc, vs):
    """Bytes of the int32 recon + residual scratch of one band of band_h
    luma rows, luma and both chroma planes."""
    wl = OX + ((W + 127) & ~127) + RIGHT
    wc = OX + ((Wc + 127) & ~127) + RIGHT
    return 4 * 2 * ((8 + band_h + SCR_PAD) * wl +
                    2 * (8 + (band_h >> vs) + SCR_PAD) * wc)


def one_row_budget(W, cs, hs, vs):
    """A VMEM_SCRATCH_BUDGET under which `band_plan` cuts a picture of
    width W and CTB size cs into bands of one CTB row (the scratch of a
    one-row band, exactly): how tests and chip_smoke.py force the banded
    plan on small pictures."""
    return band_scratch_bytes(cs, W, W >> hs, vs)


def band_plan(H, W, Hc, Wc, cs, vs):
    """Band height (a multiple of the CTB size cs) whose recon+residual
    scratch of luma and chroma fits VMEM_SCRATCH_BUDGET. Returns
    (band_h, nbands, hl, wl, hc, wc) or None if even one CTB row does
    not fit."""
    wl = OX + ((W + 127) & ~127) + RIGHT
    wc = OX + ((Wc + 127) & ~127) + RIGHT

    def scratch_bytes(bh):
        return band_scratch_bytes(bh, W, Wc, vs)

    m = 1
    while m * cs < H and \
            scratch_bytes((m + 1) * cs) <= VMEM_SCRATCH_BUDGET:
        m += 1
    band_h = m * cs
    if scratch_bytes(band_h) > VMEM_SCRATCH_BUDGET:
        return None
    nb = -(-H // band_h)
    hl = (OY + nb * band_h + SCR_PAD + 7) & ~7
    hc = (OY + nb * (band_h >> vs) + SCR_PAD + 7) & ~7
    return band_h, nb, hl, wl, hc, wc


def sort_meta_by_band(meta8: np.ndarray, n: int, band_h: int, vs: int,
                      nb: int):
    """Stable sort of the first n job columns of the packed meta
    [5, npad] (or [6, npad]: with the level row, which is carried
    along) by band; returns (sorted meta, bounds [nb+1] int32), band k
    holding jobs bounds[k]..bounds[k+1]. Row 0 is the buffer y (frame
    y + OY), the plane rides in row 2 bits 2-3, and a chroma band is
    band_h >> vs rows. Stability keeps decode order inside a band, which
    keeps every intra dependency: top references come from row y - 1
    (at most one band up) and below-left ones never cross a CTB row."""
    if n == 0:
        return meta8, np.zeros(nb + 1, np.int32)
    y = meta8[0, :n].astype(np.int32) - OY
    plane = (meta8[2, :n] >> 2) & 3
    band = np.where(plane == 0, y // band_h, y // (band_h >> vs))
    order = np.argsort(band, kind="stable")
    out = meta8.copy()
    out[:, :n] = meta8[:, :n][:, order]
    bounds = np.searchsorted(band[order], np.arange(nb + 1)).astype(np.int32)
    return out, bounds


def pack_meta(planes, xs, ys, szs, modes, avail_rows) -> np.ndarray:
    """Decode-order jobs -> the packed [5, n] int16 rows that
    `derive_meta16` reads (y + OY, x + OX, size_log2-2 | plane<<2 |
    mode<<4 | av_hi<<10, avail word 0, avail word 1): the Python mirror
    of the native packer's meta (the JAX package's `pack_meta`).
    avail_rows: uint8 / bool [n, >= 4 * max size + 1], one flag per
    reference sample in spec order; availability is uniform over
    4-sample runs, so one bit per group ships."""
    n = len(planes)
    meta = np.zeros((n, 5), np.int64)
    meta[:, 0] = ys + OY
    meta[:, 1] = xs + OX
    packed = (np.log2(szs).astype(np.int64) - 2) | (planes << 2) | \
        (modes.astype(np.int64) << 4)
    for s in (4, 8, 16, 32):
        sel = np.nonzero(szs == s)[0]
        if not len(sel):
            continue
        av = avail_rows[sel, :4 * s + 1] != 0
        # groups in spec order: left s/2 | corner | top s/2
        gb = np.concatenate(
            [av[:, :2 * s].reshape(len(sel), s // 2, 4)[:, :, 0],
             av[:, 2 * s:2 * s + 1],
             av[:, 2 * s + 1:4 * s + 1].reshape(len(sel), s // 2, 4)[:, :, 0]],
            axis=1).astype(np.int64)                        # [n, s + 1]
        w = (gb << np.arange(s + 1, dtype=np.int64)).sum(1)
        meta[sel, 3] = w & 0xFFFF
        meta[sel, 4] = (w >> 16) & 0xFFFF
        packed[sel] |= ((w >> 32) & 1) << 10
    meta[:, 2] = packed
    # int16 on the wire: coordinates < 2^14; the 33-bit availability word
    # rides as two 16-bit words and one bit of the packed row
    return np.ascontiguousarray(meta.T.astype(np.int16))


def pack_meta_native(raw: dict) -> np.ndarray:
    """`pack_meta` of the native parser's raw job arrays (`fs.native_raw`:
    ij_meta columns plane, x, y, size, mode; ij_avail)."""
    im = raw["ij_meta"]
    if not len(im):
        return np.zeros((5, 0), np.int16)
    return pack_meta(im[:, 0], im[:, 1], im[:, 2], im[:, 3], im[:, 4],
                     raw["ij_avail"])


def meta6_native(raw: dict) -> np.ndarray:
    """[6, n] int16: `pack_meta_native` plus each job's wavefront level
    (ij_meta column 6) as the sixth row, as the native packer ships it."""
    level = raw["ij_meta"][:, 6]
    if len(level) and not 1 <= int(level.min()) <= int(level.max()) <= 32767:
        raise ValueError("intra job levels outside 1..32767")
    return np.concatenate([pack_meta_native(raw),
                           level.astype(np.int16)[None, :]])


def pack_meta_objects(jobs) -> np.ndarray:
    """`pack_meta` of the Python parser's decode-order `IntraJob` list."""
    if not jobs:
        return np.zeros((5, 0), np.int16)
    cols = np.array([(j.plane, j.x, j.y, j.size, j.mode) for j in jobs],
                    np.int32)
    av = np.zeros((len(jobs), 129), np.uint8)
    for i, j in enumerate(jobs):
        av[i, :len(j.avail)] = j.avail
    return pack_meta(cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3],
                     cols[:, 4], av)


def _neighbour_offsets(s: int):
    """(dx, dy) of the 4s+1 reference samples of an s x s TU in spec
    order (left bottom->top | corner | top left->right)."""
    k = np.arange(2 * s)
    return (np.concatenate([np.full(2 * s + 1, -1), k]),
            np.concatenate([2 * s - 1 - k, [-1], np.full(2 * s, -1)]))


_OFFSETS = {s: _neighbour_offsets(s) for s in (4, 8, 16, 32)}


def object_levels(jobs, H: int, W: int) -> np.ndarray:
    """Each job's wavefront level (int32 [n]) from the Python parser's
    jobs, by the rule the native parser applies (and the JAX package's
    `_pack_from_objects`): 1 + the highest level among the jobs that
    wrote an available reference sample, per plane on the 4x4 grid; 0
    for samples no job wrote."""
    level_map = np.zeros((3, (H >> 2) + 1, (W >> 2) + 1), np.int32)
    out = np.zeros(len(jobs), np.int32)
    for i, j in enumerate(jobs):
        s = j.size
        dx, dy = _OFFSETS[s]
        av = np.asarray(j.avail[:4 * s + 1], bool)
        m = level_map[j.plane]
        lvl = 1
        if av.any():
            lvl += int(m[(j.y + dy[av]) >> 2, (j.x + dx[av]) >> 2].max())
        n4 = max(1, s >> 2)
        m[j.y >> 2:(j.y >> 2) + n4, j.x >> 2:(j.x >> 2) + n4] = lvl
        out[i] = lvl
    return out


def meta6_objects(jobs, H: int, W: int):
    """(meta [6, n] int16, n_levels): `pack_meta_objects` plus each job's
    `object_levels` as the sixth row, the layout of `meta6_native`."""
    level = object_levels(jobs, H, W)
    if len(level) and int(level.max()) > 32767:
        raise ValueError("intra job levels outside 1..32767")
    return (np.concatenate([pack_meta_objects(jobs),
                            level.astype(np.int16)[None, :]]),
            int(level.max()) if len(level) else 0)


def tile_group_of(gmap, plane, x, y, log2_ctb: int, hs: int, vs: int):
    """Tile group of each block at plane coordinates (x, y) of plane
    `plane` (0 luma): gmap [ctbs_h, ctbs_w] (one group a CTB) read at the
    CTB of the block's luma-grid position (chroma coordinates scale by
    hs / vs), clipped into the grid. Works on numpy arrays and on torch
    tensors alike (gmap on the blocks' device)."""
    ch, cw = gmap.shape
    chroma = plane != 0
    cy = ((y << (chroma * vs)) >> log2_ctb).clip(0, ch - 1)
    cx = ((x << (chroma * hs)) >> log2_ctb).clip(0, cw - 1)
    return gmap[cy, cx]


def meta6_tile_group(meta6: np.ndarray, n: int, gmap: np.ndarray, g: int,
                     log2_ctb: int, hs: int, vs: int):
    """The jobs of tile group g of a picture's [6, >= n] meta
    (`meta6_native` layout: buffer y, x, packed size / plane / mode,
    availability words, level), in their meta order, with their levels
    renumbered densely (each level becomes its rank among the levels
    left), so the level schedule gets no empty level. Returns (meta
    [6, n_g] int16, n_g, n_levels_g).

    The relative order and the order of levels are kept, so every
    dependency still holds; the standard makes another tile's samples
    unavailable, so no job of group g reads a sample that a job of
    another group writes."""
    m = meta6[:, :n]
    plane = (m[2].astype(np.int32) >> 2) & 3
    grp = tile_group_of(gmap, plane, m[1].astype(np.int32) - OX,
                        m[0].astype(np.int32) - OY, log2_ctb, hs, vs)
    out = np.ascontiguousarray(m[:, grp == g])
    levels, rank = np.unique(out[5], return_inverse=True)
    out[5] = rank.astype(np.int16) + 1
    return out, out.shape[1], len(levels)


def derive_meta16(meta8: torch.Tensor, sdis: bool, c444: bool,
                  strong: bool) -> torch.Tensor:
    """[5, npad] int16 packed rows (y, x, sl|plane<<2|mode<<4|av_hi<<10,
    av_w0, av_w1) -> the kernel's [16, npad] int32 meta. The derived rows
    are pure functions of size, mode and plane (pipeline.py
    _derive_meta16 in the JAX package)."""
    m8 = meta8.to(torch.int32)
    my, mx, mpk, mav0, mav1 = m8.unbind(0)
    msl = mpk & 3
    mplane = (mpk >> 2) & 3
    mmode = (mpk >> 4) & 63
    mavhi = (mpk >> 10) & 1
    ms = 4 << msl
    md = torch.minimum((mmode - 26).abs(), (mmode - 10).abs())
    thr = torch.where(ms == 8, 7, torch.where(ms == 16, 1,
                      torch.where(ms == 32, 0, 99)))
    filt_ok = ((mplane == 0) | bool(c444)) & (not sdis)
    m5 = filt_ok & (ms > 4) & (mmode != 1) & (md > thr)
    idx = mmode.clamp(0, 34).long()
    mang = TABLES["ANG"].to(m8.device)[idx].to(torch.int32)
    minv = TABLES["INV"].to(m8.device)[idx].to(torch.int32)
    m10 = (ms == 32) & bool(strong) & (mplane == 0)
    m11 = (mav0 != 0) | (mav1 != 0) | (mavhi != 0)
    m12 = (ms < 32) & (mplane == 0)
    z = torch.zeros_like(my)
    rows = [my, mx, msl, mmode, mplane, m5, mav0, mav1, mang, minv, m10,
            m11, m12, mavhi, z, z]
    return torch.stack([r.to(torch.int32) for r in rows]).contiguous()


def level_schedule(level: torch.Tensor, n: int, n_levels: int):
    """The level-parallel kernels' schedule from each job's wavefront
    level (`level` [>= n], any integer dtype, values 1..n_levels, in the
    meta's job order): returns (order int32 [n], level_bounds int32
    [n_levels + 1]) on level's device. `order` lists the jobs by level,
    stably (so decode order inside a level and, on band-sorted meta,
    band then decode order); level L (1-based) holds the jobs
    order[level_bounds[L-1]:level_bounds[L]], and level_bounds rises
    from 0 to n. Tensor ops only: no host synchronisation."""
    sorted_lv, order = torch.sort(level[:n].to(torch.int32), stable=True)
    edges = torch.arange(1, n_levels + 2, dtype=torch.int32,
                         device=level.device)
    level_bounds = torch.searchsorted(sorted_lv, edges)
    return order.to(torch.int32), level_bounds.to(torch.int32)


def check_rising(values, n: int, name: str):
    """Raise unless the host sequence `values` (band bounds or level
    bounds) rises from 0 to n."""
    b = [int(v) for v in values]
    if not b or b[0] != 0 or b[-1] != n or \
            any(p > q for p, q in zip(b, b[1:])):
        raise ValueError(f"{name} must rise from 0 to n={n}: {b}")


# =========================================================================
# Plain version
# =========================================================================

def _sample_groups(s: int) -> list[int]:
    """Availability group of each of the 4s+1 reference samples."""
    h = s // 2
    return [i >> 2 for i in range(2 * s)] + [h] + \
        [h + 1 + (i >> 2) for i in range(2 * s)]


def _job_ref(buf, res, s: int, bd: int, f: list[int]):
    """One TU: gather, substitute, filter, predict, add residual, clip;
    returns the s x s block for buf[y:y+s, x:x+s] (nothing is stored).
    f: the job's 16 meta fields."""
    y, x, mode, do_filter = f[0], f[1], f[3], f[5]
    angle, inv, strong_allowed, edge = f[8], f[9], f[10], f[12]
    n = 4 * s + 1
    log2s = s.bit_length() - 1
    maxv = (1 << bd) - 1
    dev = buf.device
    w = (f[6] & 0xFFFF) | ((f[7] & 0xFFFF) << 16) | ((f[13] & 1) << 32)
    w &= (1 << (s + 1)) - 1
    # reference samples in spec order: left bottom->top | corner | top
    ref = torch.cat([buf[y:y + 2 * s, x - 1].flip(0),
                     buf[y - 1, x - 1:x + 2 * s]]).to(torch.int64)
    # 8.4.4.2.2 substitution: each unavailable sample takes the last
    # available one before it, or the first available one if none is
    if w == 0:
        ref = torch.full((n,), 1 << (bd - 1), dtype=torch.int64, device=dev)
    else:
        av = [(w >> g) & 1 for g in _sample_groups(s)]
        last = av.index(1)
        src = []
        for i in range(n):
            if av[i]:
                last = i
            src.append(last)
        ref = ref[torch.tensor(src, device=dev)]
    # 8.4.4.2.3 filtering
    if do_filter:
        f121 = ref.clone()
        f121[1:n - 1] = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
        if s == 32 and strong_allowed:
            c, r0, rn = ref[2 * s], ref[0], ref[4 * s]
            th = 1 << (bd - 5)
            cond = ((c + rn - 2 * ref[3 * s]).abs() < th) & \
                ((c + r0 - 2 * ref[s]).abs() < th)
            k = torch.arange(2 * s - 1, device=dev)
            strong = ref.clone()
            strong[2 * s + 1:4 * s] = ((63 - k) * c + (k + 1) * rn + 32) >> 6
            strong[1:2 * s] = (((63 - k) * c + (k + 1) * r0 + 32) >> 6) \
                .flip(0)
            f121 = torch.where(cond, strong, f121)
        ref = f121
    left = ref[:2 * s].flip(0)          # left[y] = p[-1][y]
    corner = ref[2 * s]
    top = ref[2 * s + 1:]               # top[x] = p[x][-1]
    yg = torch.arange(s, device=dev)[:, None]
    xg = torch.arange(s, device=dev)[None, :]
    if mode == 0:
        pr = ((s - 1 - xg) * left[yg] + (xg + 1) * top[s] +
              (s - 1 - yg) * top[xg] + (yg + 1) * left[s] + s) >> (log2s + 1)
    elif mode == 1:
        dc = (top[:s].sum() + left[:s].sum() + s) >> (log2s + 1)
        pr = dc.expand(s, s).clone()
        if edge:
            pr[0, 1:] = (top[1:s] + 3 * dc + 2) >> 2
            pr[1:, 0] = (left[1:s] + 3 * dc + 2) >> 2
            pr[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
    else:
        ver = mode >= 18
        main, side = (top, left) if ver else (left, top)
        r = torch.zeros(3 * s + 2, dtype=torch.int64, device=dev)
        r[s] = corner
        r[s + 1:3 * s + 1] = main
        if angle < 0:
            k = torch.arange(s, device=dev)
            proj = (-1 + ((-(k + 1) * inv + 128) >> 8)).clamp(0, 2 * s - 1)
            r[:s] = side[proj].flip(0)
        # rows advance along the side direction (yg), columns along main
        idx = ((yg + 1) * angle) >> 5
        fact = ((yg + 1) * angle) & 31
        pr = ((32 - fact) * r[s + xg + idx + 1] +
              fact * r[s + xg + idx + 2] + 16) >> 5
        if not ver:
            pr = pr.T.contiguous()
        if edge and mode == 26:
            pr[:, 0] = (top[0] + ((left[:s] - corner) >> 1)).clamp(0, maxv)
        if edge and mode == 10:
            pr[0, :] = (left[0] + ((top[:s] - corner) >> 1)).clamp(0, maxv)
    return (pr + res[y:y + s, x:x + s]).clamp(0, maxv).to(buf.dtype)


def _jobs_ref(meta, jobs, luma, chroma, res_l, res_c, bd, together=False):
    """The jobs `jobs` (column indices into meta), one at a time in that
    order, or, with together=True, as jobs that run side by side: all of
    them read the planes as they were before any of them stored."""
    stores = []
    for f in meta[:, jobs].to("cpu").T.tolist():
        plane, s = f[4], 4 << f[2]
        buf, res = (luma, res_l) if plane == 0 else \
            (chroma[plane - 1], res_c[plane - 1])
        dst = buf[f[0]:f[0] + s, f[1]:f[1] + s]
        blk = _job_ref(buf, res, s, bd, f)
        if together:
            stores.append((dst, blk))
        else:
            dst.copy_(blk)
    for dst, blk in stores:
        dst.copy_(blk)


def _levels_ref(meta, luma, chroma, res_l, res_c, bd, order, level_bounds):
    """Level by level, each level's jobs side by side (`_jobs_ref` with
    together=True): what the level-parallel kernels compute, provided no
    job reads what another job of its level writes."""
    order = order.to("cpu")
    b = level_bounds.tolist()
    for lo, hi in zip(b, b[1:]):
        if hi > lo:
            _jobs_ref(meta, order[lo:hi].long(), luma, chroma, res_l, res_c,
                      bd, together=True)


def intra_fused_ref(meta, n, luma, chroma, res_l, res_c, bd, order=None,
                    level_bounds=None):
    """Plain PyTorch version of the fused intra kernel: same arguments and
    in-place effect as `intra_fused`. Without a schedule the jobs run one
    at a time in meta order (decode order); with `order` and
    `level_bounds` (`level_schedule`) they run level by level, the jobs
    of a level all reading the planes before any of them stores, as the
    kernel's warps may."""
    if order is None:
        _jobs_ref(meta, slice(0, n), luma, chroma, res_l, res_c, bd)
    else:
        _levels_ref(meta, luma, chroma, res_l, res_c, bd, order,
                    level_bounds)
    return luma, chroma


def intra_fused_banded_ref(meta, bounds, n, luma, chroma, res_l, res_c, bd,
                           order=None, level_bounds=None):
    """Plain PyTorch version of the banded kernel: same arguments and
    in-place effect as `intra_fused_banded`. Without a schedule, band k
    runs the jobs bounds[k]..bounds[k+1] of the band-sorted meta one at
    a time, bands in order; with `order` and `level_bounds` the jobs run
    level by level across all bands, as in `intra_fused_ref`."""
    if order is None:
        b = bounds.tolist()
        for lo, hi in zip(b, b[1:]):
            _jobs_ref(meta, slice(lo, hi), luma, chroma, res_l, res_c, bd)
    else:
        _levels_ref(meta, luma, chroma, res_l, res_c, bd, order,
                    level_bounds)
    return luma, chroma


# =========================================================================
# Kernel wrappers
# =========================================================================

def _check(meta, n, luma, chroma, res_l, res_c, bd):
    if not 1 <= bd <= 16:
        raise ValueError(f"bit depth {bd} out of range")
    dev = luma.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("meta", meta), ("luma", luma), ("chroma", chroma),
                    ("res_l", res_l), ("res_c", res_c)):
        _check_i32(name, t, dev)
    if meta.dim() != 2 or meta.shape[0] != 16 or not 0 <= n <= meta.shape[1]:
        raise ValueError(f"meta {tuple(meta.shape)} with n={n}")
    if luma.dim() != 2 or chroma.dim() != 3 or chroma.shape[0] != 2:
        raise ValueError(f"planes {tuple(luma.shape)}, "
                         f"{tuple(chroma.shape)}")
    if res_l.shape != luma.shape or res_c.shape != chroma.shape:
        raise ValueError("residual planes must match the recon planes")


def _check_i32(name, t, dev):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want int32")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, luma on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_vector(name, t, n, dev):
    """An int32 vector on dev; on the CPU, where reading it costs no
    device synchronisation, also one that rises from 0 to n."""
    _check_i32(name, t, dev)
    if t.dim() != 1 or t.shape[0] < 1:
        raise ValueError(f"{name} {tuple(t.shape)}: want a vector")
    if dev.type == "cpu":
        check_rising(t.tolist(), n, name)


def _check_schedule(order, level_bounds, n, dev):
    _check_i32("order", order, dev)
    if order.dim() != 1 or order.shape[0] != n:
        raise ValueError(f"order {tuple(order.shape)}: want [n={n}]")
    _check_vector("level_bounds", level_bounds, n, dev)
    if dev.type == "cpu" and \
            not torch.equal(order.sort().values.long(), torch.arange(n)):
        raise ValueError("order is not a permutation of the n jobs")


def _launch_levels(name, fn, meta, n, order, level_bounds, grid, luma,
                   chroma, res_l, res_c, bd):
    """One cooperative launch of level-parallel kernel `name` on the
    current stream; counts it on the wrapper `fn`."""
    lib = kernels.load(name, _ARGTYPES)
    with torch.cuda.device(luma.device):
        limit = ctypes.c_int(0)
        rc = getattr(lib, f"{name}_max_grid")(ctypes.byref(limit))
        if rc != 0:
            raise RuntimeError(f"{name}: occupancy query failed: "
                               f"cudaError_t {rc}")
        if grid is None:
            sms = torch.cuda.get_device_properties(luma.device) \
                .multi_processor_count
            grid = min(sms, limit.value)
        if not 1 <= grid <= limit.value:
            raise ValueError(f"{name}: grid {grid} outside 1..{limit.value} "
                             f"co-resident blocks")
        done = torch.zeros(1, dtype=torch.int32, device=luma.device)
        rc = getattr(lib, f"{name}_launch")(
            meta.data_ptr(), meta.shape[1], n, order.data_ptr(),
            level_bounds.data_ptr(), level_bounds.shape[0] - 1,
            done.data_ptr(), grid, luma.data_ptr(), luma.shape[1],
            chroma.data_ptr(), chroma.shape[1], chroma.shape[2],
            res_l.data_ptr(), res_c.data_ptr(), bd,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    fn.launches += 1
    fn.last_grid = grid


def intra_fused(meta, n, luma, chroma, res_l, res_c, bd, order,
                level_bounds, grid=None):
    """Run the first n jobs of meta [16, npad] int32 over the padded
    planes luma [hl, wl] and chroma [2, hc, wc] (int32, updated IN PLACE)
    with residual planes of the same shapes, level by level as `order`
    int32 [n] and `level_bounds` int32 [n_levels + 1] say
    (`level_schedule`); returns (luma, chroma).

    CUDA tensors make ONE cooperative launch of csrc/intra_fused.cu on
    the current stream (on `grid` blocks, by default one per SM; more
    than are co-resident raises) and count it; nothing is read back, so
    the values of the schedule are not checked there: make them with
    `level_schedule` (the kernel clamps what it reads from them, so a
    wrong schedule gives wrong samples, not a wild access). CPU tensors
    are checked in full and run `intra_fused_ref` in level order."""
    _check(meta, n, luma, chroma, res_l, res_c, bd)
    _check_schedule(order, level_bounds, n, luma.device)
    if luma.device.type == "cpu":
        return intra_fused_ref(meta, n, luma, chroma, res_l, res_c, bd,
                               order, level_bounds)
    if n:
        _launch_levels("intra_fused", intra_fused, meta, n, order,
                       level_bounds, grid, luma, chroma, res_l, res_c, bd)
    return luma, chroma


intra_fused.launches = 0


def intra_fused_banded(meta, bounds, n, luma, chroma, res_l, res_c, bd,
                       order, level_bounds, grid=None):
    """Banded twin of `intra_fused` for band-sorted meta
    (`sort_meta_by_band`) over planes of `band_plan`'s dims (updated IN
    PLACE); returns (luma, chroma). bounds: int32 [nbands + 1], band k
    holding the jobs bounds[k]..bounds[k+1]; `order` and `level_bounds`:
    the `level_schedule` of the band-sorted jobs (level, then band, then
    decode order). The levels run frame-wide, across the bands.

    CUDA tensors make ONE cooperative launch of
    csrc/intra_fused_banded.cu on the current stream and count it.
    Nothing is read back from the device: check `bounds` on the host
    before the upload (`check_rising`), as `TorchEngine.prepare` does.
    CPU tensors are checked in full and run `intra_fused_banded_ref` in
    level order."""
    _check(meta, n, luma, chroma, res_l, res_c, bd)
    _check_vector("bounds", bounds, n, luma.device)
    if bounds.shape[0] < 2:
        raise ValueError(f"bounds {tuple(bounds.shape)}: want [nbands + 1]")
    _check_schedule(order, level_bounds, n, luma.device)
    if luma.device.type == "cpu":
        return intra_fused_banded_ref(meta, bounds, n, luma, chroma, res_l,
                                      res_c, bd, order, level_bounds)
    if n:
        _launch_levels("intra_fused_banded", intra_fused_banded, meta, n,
                       order, level_bounds, grid, luma, chroma, res_l,
                       res_c, bd)
    return luma, chroma


intra_fused_banded.launches = 0


def intra_fused_serial(meta, n, luma, chroma, res_l, res_c, bd):
    """The first n jobs one after the other in meta order (decode order,
    or band order on band-sorted meta), planes updated IN PLACE: the
    yardstick that the level-parallel kernels are held against on whole
    frames. For checking only; no decode path calls it.

    CUDA tensors launch the one-warp kernel of csrc/intra_fused.cu and
    count it; CPU tensors run `intra_fused_ref` in meta order."""
    _check(meta, n, luma, chroma, res_l, res_c, bd)
    if luma.device.type == "cpu":
        return intra_fused_ref(meta, n, luma, chroma, res_l, res_c, bd)
    if n:
        lib = kernels.load("intra_fused", _ARGTYPES)
        with torch.cuda.device(luma.device):
            rc = lib.intra_fused_serial_launch(
                meta.data_ptr(), meta.shape[1], n,
                luma.data_ptr(), luma.shape[1],
                chroma.data_ptr(), chroma.shape[1], chroma.shape[2],
                res_l.data_ptr(), res_c.data_ptr(), bd,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"intra_fused_serial launch failed: "
                               f"cudaError_t {rc}")
        intra_fused_serial.launches += 1
    return luma, chroma


intra_fused_serial.launches = 0

# the C functions' argument types (`kernels.load`)
_P, _I = ctypes.c_void_p, ctypes.c_int
_PLANES = [_P, _I, _P, _I, _I, _P, _P, _I, _P]   # luma .. bd, stream
_LEVELS = [_P, _I, _I, _P, _P, _I, _P, _I] + _PLANES
_ARGTYPES = {
    "intra_fused_launch": _LEVELS,
    "intra_fused_banded_launch": _LEVELS,
    "intra_fused_serial_launch": [_P, _I, _I] + _PLANES,
    "intra_fused_max_grid": [ctypes.POINTER(_I)],
    "intra_fused_banded_max_grid": [ctypes.POINTER(_I)],
}
