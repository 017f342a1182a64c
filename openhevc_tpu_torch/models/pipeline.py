"""PyTorch reconstruction pipeline (the device half of the decoder).

Counterpart of the JAX package's models/pipeline.py main path
(`JaxEngine.reconstruct` -> `_run_fused` -> `_inter_prefill` /
`_frame_fused`): for each parsed picture

  1. one host->device copy of the packed residual arenas, the intra job
     meta with each job's wavefront level (`host_pack`) and, where the
     picture has them, the cross-component scale map, the sparse motion
     deltas (`motion_diff2`), the weighted-prediction grids and the
     in-loop filters' named arrays (`plan.arrays` of the picture's filter
     plan, `ops/filters.py::plan_filters`: control arrays and, on a
     deblocked picture, the parser's per-4x4 grids, from which one
     launch right after the upload makes the per-edge boundary strengths
     and beta / tc, `plan.args`), each array by name (`upload`);
  2. level rebuild from the scan-prefix payload (`_arena_levels`);
  3. dequant + inverse transform per TU size (ops/idct.py) and the slot
     scatter into residual planes (`_residual_acc`);
  4. the starting planes: zeros, the PCM samples, or, on an inter
     picture, the inter prediction (`_inter_prefill`: motion grids from
     the deltas, two-stage MC over the stage-1 planes of the
     device-resident references, uni / bi / weighted combine + residual;
     ops/mc.py);
  5. kernel meta derivation, the level schedule (`level_schedule`, on
     the device) and ONE launch of a fused intra kernel that runs every
     intra TU, wavefront level by level (ops/intra_fused.py): the
     whole-frame kernel (csrc/intra_fused.cu) when the padded planes fit
     the JAX package's whole-frame gate, else the banded one
     (csrc/intra_fused_banded.cu) on band-sorted meta
     (`TorchEngine.fused_plan`). A picture with no intra job launches
     nothing. Everything runs on one stream, in this order: an intra TU
     beside inter samples reads them from the finished prefill;
  6. whole-frame deblocking + SAO where the picture wants them
     (`plan.apply`: on a card at most three launches of
     csrc/loop_filters.cu);
  7. crop + downcast into one flat uint8 (uint16 above 8 bits) tensor
     that stays on the device as the DPB entry (`TorchPlanes` fetches it
     to the host lazily); later pictures predict from it there.

Chroma formats 4:2:0, 4:2:2 and 4:4:4 and equal bit depths of 8 to 12
run this path (the chroma shifts `hs` / `vs` and the depth come from the
SPS). A picture with scaling lists has no native pack: the Python packer
(`_res_buckets`, `_pack_arena`, `host_pack`) writes the same byte format
with the scaling matrices behind each bucket's sideband, and
`_arena_levels` hands them to the dequant. Cross-component prediction
(4:4:4) couples the chroma residual to the luma residual once a picture
(`ccp_scale_map` rides in the upload, `_apply_ccp` runs after step 3), so
both the inter prefill and the kernel's residual planes see it.

Every picture the JAX package's decoder takes runs this path, with the
route chosen by what the picture is, before any launch:
  - a picture of the Python parser (`fs.native_raw is None`) is packed
    from its objects (`_res_buckets_objects`, `meta6_objects`: each
    job's wavefront level by the native parser's rule);
  - an inter picture none of whose references is at hand starts from
    zeros (its inter blocks stay 0, as in the JAX package's packed
    path), and PCM samples are written over whatever the starting planes
    hold;
  - a frame with no band plan takes the whole-frame kernel
    (`TorchEngine.fused_plan`);
  - a picture whose filter plan takes the host route (its filters fall
    outside the whole-frame device model) is fetched unfiltered after
    the kernel and filtered on the host on the reference's CTB schedule
    (ops/filters_sched.py, the "host_filters" stage); it stays a host
    picture, uploaded where a later picture predicts from it.
Monochrome, unequal luma / chroma depths and depths outside 8-12 bits
raise NotImplementedError (`check_slice`).

A tile shard of a picture (parallel/mesh.py, the tile axis of a device
mesh: `prepare(shard=(gmap, g))`, then `launch`) runs steps 1-5 with the
residual TUs and intra jobs of tile group g only and stops before step
6: the mesh combines the shards, then filters them by the same plan.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..ops.filters import plan_filters
from ..ops.filters_sched import apply_loop_filters
from ..ops.idct import residual_bucket
from ..ops.intra_fused import (OY, OX, band_plan, check_rising,
                               derive_meta16, intra_fused,
                               intra_fused_banded, level_schedule,
                               meta6_native, meta6_objects,
                               meta6_tile_group, padded_dims,
                               sort_meta_by_band, tile_group_of)
from ..ops.mc import (combine_plane, combine_plane_w, mc_hprefilter,
                      mc_prefilter_pairs, mc_put_core, mc_put_pairs_core,
                      stage1_shape)
from ..ops.tables import SCAN, SIZES, TABLES
from ..symbols import FrameSymbols
from ..utils import trace


# ---- the Python packer (pictures the native packer leaves out) ------------

def _sm_for(sl, s, mid, tskip):
    """Per-TU dequant scaling matrices [n, s, s] int32, or None when
    scaling lists are off. Table row 6 is the flat 16 that transform-skip
    TUs above 4x4 take (the hevc_cabac.c:1484 gate)."""
    if sl is None:
        return None
    log2s = s.bit_length() - 1
    table = np.stack([sl.matrix(log2s, m) for m in range(6)] +
                     [np.full((s, s), 16, np.int32)])
    return table[np.where(tskip, 6, mid) if log2s > 2 else mid]


def _res_buckets(fs: FrameSymbols):
    """Residual TUs of a picture by size: {s: dict(levels [n, s, s], qp,
    flags [n, 5] (dst, tskip, bypass, rdpcm vertical, rdpcm on), plane,
    x, y (plane coordinates), sm)} from the native parser's raw arrays
    (`fs.native_raw`) or, for a picture of the Python parser, from its
    `CoeffBlock` list. The JAX package's function of this name pads
    every bucket to a geometric row count with far-away coordinates, to
    bound the number of programs it compiles; nothing here compiles per
    shape, so exactly the n rows are packed."""
    raw = fs.native_raw
    if raw is None:
        return _res_buckets_objects(fs)
    cm, arena = raw["cb_meta"], raw["cb_levels"]
    sl = fs.active_scaling()
    out = {}
    for s in SIZES:
        sel = np.nonzero(cm[:, 3] == s.bit_length() - 1)[0]
        if not len(sel):
            continue
        gather = cm[sel, 6][:, None] + np.arange(s * s)[None, :]
        fl = cm[sel, 5]
        flags = np.stack([(fl & 1) != 0, (fl & 2) != 0, (fl & 4) != 0,
                          (fl & 16) != 0, (fl & 8) != 0], axis=1)
        mid = 3 * ((fl & 32) != 0) + cm[sel, 0]
        out[s] = dict(levels=arena[gather].reshape(-1, s, s).astype(np.int32),
                      qp=cm[sel, 4].astype(np.int32), flags=flags,
                      plane=cm[sel, 0].astype(np.int32),
                      x=cm[sel, 1].astype(np.int32),
                      y=cm[sel, 2].astype(np.int32),
                      sm=_sm_for(sl, s, mid, flags[:, 1]))
    return out


def _res_buckets_objects(fs: FrameSymbols):
    """`_res_buckets` over the Python parser's `fs.coeff_blocks`."""
    sl = fs.active_scaling()
    by_size = {s: [] for s in SIZES}
    for cb in fs.coeff_blocks:
        by_size[1 << cb.log2_size].append(cb)
    out = {}
    for s, blocks in by_size.items():
        if not blocks:
            continue
        cols = np.array([(cb.qp, cb.plane, cb.x, cb.y, cb.matrix_id)
                         for cb in blocks], np.int32)
        flags = np.array([(cb.is_dst, cb.transform_skip,
                           cb.transquant_bypass, cb.rdpcm_mode == 1,
                           cb.rdpcm_mode >= 0) for cb in blocks], bool)
        out[s] = dict(levels=np.stack([cb.levels for cb in blocks])
                      .astype(np.int32), qp=cols[:, 0], flags=flags,
                      plane=cols[:, 1], x=cols[:, 2], y=cols[:, 3],
                      sm=_sm_for(sl, s, cols[:, 4], flags[:, 1]))
    return out


def _pack_arena(buckets):
    """Pack the residual buckets of every size into the upload format
    `_arena_levels` reads (the native packer's, byte for byte): per TU
    only the scan-order prefix up to the last significant coefficient, as
    4-bit biased nibbles (|level| <= 7) or 8-bit biased bytes, whichever
    costs fewer bytes once escapes are counted; levels outside the stored
    range ride as int32 (bucket-local raster index, delta) escape pairs
    that the device adds back. Sideband: 4 int16 a TU (x, y,
    qp<<7 | flags<<2 | plane, prefix length | byte mode<<12), then the
    bucket's scaling matrices where the picture has them.

    Returns (arena4 uint8, arena16 int16, esc int32, caps) with caps =
    ((s, n, has_sm, n_esc), ...) for the four sizes. Exactly the bytes
    there are: no tail padding of the payload and no padding escape pairs
    (the JAX package pads both to bound its program count)."""
    pay, p16, pesc, caps = [], [], [], []
    for s in SIZES:
        b = buckets.get(s)
        if b is None or len(b["qp"]) == 0:
            caps.append((s, 0, 0, 0))
            continue
        cap = len(b["qp"])
        sm = b.get("sm")
        ss = s * s
        scan = SCAN[s]
        lvs = b["levels"].reshape(cap, ss)[:, scan]    # scan domain
        nz = lvs != 0
        cnt = np.where(nz.any(1), ss - np.argmax(nz[:, ::-1], 1),
                       0).astype(np.int32)             # last significant + 1
        k = np.arange(ss, dtype=np.int32)[None, :]
        inpfx = k < cnt[:, None]
        c4, c8 = np.clip(lvs, -8, 7), np.clip(lvs, -128, 127)
        esc_nib = ((lvs != c4) & inpfx).sum(1)
        esc_byt = ((lvs != c8) & inpfx).sum(1)
        byte_mode = (cnt + 8 * esc_byt) < ((cnt + 1) // 2 + 8 * esc_nib)
        pay_len = np.where(byte_mode, cnt, (cnt + 1) // 2)
        # payload byte matrix [cap, ss]: row j's first pay_len[j] bytes
        B = np.zeros((cap, ss), np.uint8)
        n4 = (c4 + 8).astype(np.uint8)
        B[byte_mode] = (c8 + 128).astype(np.uint8)[byte_mode]
        nib = n4[:, 0::2] | (n4[:, 1::2] << 4)
        B[~byte_mode, :ss // 2] = nib[~byte_mode]
        pay.append(B[k < pay_len[:, None]])
        diff = np.where(inpfx, lvs - np.where(byte_mode[:, None], c8, c4), 0)
        er, ec = np.nonzero(diff)
        if len(er):
            pesc.append(np.stack([er * ss + scan[ec], diff[er, ec]], axis=1)
                        .astype(np.int32).reshape(-1))
        caps.append((s, cap, 0 if sm is None else 1, len(er)))
        fl = b["flags"].astype(np.int32)
        qpf = (b["qp"].astype(np.int32) << 7) | (fl[:, 0] << 2) | \
            (fl[:, 1] << 3) | (fl[:, 2] << 4) | (fl[:, 3] << 5) | \
            (fl[:, 4] << 6) | b["plane"]
        cw = (cnt | (byte_mode.astype(np.int32) << 12)).astype(np.int16)
        p16 += [b["x"].astype(np.int16), b["y"].astype(np.int16),
                qpf.astype(np.int16), cw]
        if sm is not None:
            p16.append(sm.reshape(-1).astype(np.int16))
    arena4 = np.concatenate(pay) if pay else np.zeros(0, np.uint8)
    if not arena4.size:               # the reader's gather needs a byte
        arena4 = np.zeros(1, np.uint8)
    arena16 = np.concatenate(p16) if p16 else np.zeros(1, np.int16)
    esc = np.concatenate(pesc) if pesc else np.zeros(2, np.int32)
    return arena4, arena16, esc, tuple(caps)


def ccp_scale_map(fs: FrameSymbols):
    """RExt cross-component prediction: the per-sample res_scale_val map
    [2, Hc, Wc] int8 over the chroma planes (0 where a TU does not use
    it), from the natively parsed TU records (flags bits 6-10 of
    cb_meta hold res_scale_val + 9, 0 for none) or the Python parser's
    `CoeffBlock.cross_scale`. None when the PPS flag is off or no TU uses
    it. 4:4:4 only, the one format that allows it."""
    if not getattr(fs.pps, "cross_component_prediction_enabled", 0):
        return None
    if fs.native_raw is None:
        blocks = [cb for cb in fs.coeff_blocks
                  if cb.plane and cb.cross_scale]
        rec = np.array([(cb.plane, cb.x, cb.y, cb.log2_size, cb.cross_scale)
                        for cb in blocks], np.int32).reshape(-1, 5)
    else:
        cm = fs.native_raw["cb_meta"]
        code = cm[:, 5] >> 6
        sel = (cm[:, 0] > 0) & (code != 0) & ((code & 31) != 9)
        rec = np.concatenate([cm[sel, :4], ((code[sel] & 31) - 9)[:, None]],
                             axis=1)
    if not len(rec):
        return None
    sps = fs.sps
    smap = np.zeros((2, sps.height >> sps.vshift1, sps.width >> sps.hshift1),
                    np.int8)
    for s in SIZES:
        rows = rec[rec[:, 3] == s.bit_length() - 1]
        if not len(rows):
            continue
        ar = np.arange(s)
        smap[(rows[:, 0] - 1)[:, None, None],
             rows[:, 2][:, None, None] + ar[None, :, None],
             rows[:, 1][:, None, None] + ar[None, None, :]] = \
            rows[:, 4][:, None, None]
    return smap


def _apply_ccp(acc_l, acc_c, smap):
    """Couple the chroma residual to the co-located luma residual:
    r_c += (res_scale_val * r_l) >> 3 where the map is not 0, with the
    reference's int16 wrap-around of the sum (hevc.c:1295-1362). acc_l
    [H, W], acc_c [2, H, W] int32 (4:4:4), smap [2, H, W] int8."""
    s32 = smap.to(torch.int32)
    tot = acc_c + ((s32 * acc_l[None]) >> 3)
    wrapped = ((tot + (1 << 15)) & 0xFFFF) - (1 << 15)
    return torch.where(s32 != 0, wrapped, acc_c)


def _arena_levels(arena4, arena16, escs, caps):
    """Rebuild per-bucket raster levels from the scan-prefix payload
    (JAX package: pipeline.py _arena_levels; byte format: `_pack_arena` /
    native hevc_pack_frame, one reader for both packers). Yields (s, cap,
    x, y, qpf, sm, levels [cap, s, s] int32) per non-empty bucket; sm is
    the bucket's scaling matrices [cap, s, s] (int64) where the picture
    has scaling lists, else None.

    torch indexing neither clamps nor drops out-of-range indices, so the
    payload gather clamps its offsets explicitly (offsets past the last
    TU's payload only feed positions beyond the prefix, which are zeroed)
    and the (-1, -1) escape padding pairs are masked to a zero add."""
    pay = arena4.to(torch.int64)
    a = arena16.to(torch.int64)
    esc = escs.to(torch.int64).reshape(-1, 2)
    segs = []
    off = 0
    for s, cap, has_sm, n_esc in caps:
        if cap == 0:
            segs.append(None)
            continue
        x, y, qpf, cw = (a[off + i * cap:off + (i + 1) * cap]
                         for i in range(4))
        off += 4 * cap
        sm = None
        if has_sm:
            sm = a[off:off + cap * s * s].reshape(cap, s, s)
            off += cap * s * s
        segs.append((x, y, qpf, cw & 0xFFF, (cw >> 12) & 1, sm))
    lens = [torch.where(g[4] == 1, g[3], (g[3] + 1) >> 1)
            for g in segs if g is not None]
    if not lens:
        return
    all_len = torch.cat(lens)
    all_off = all_len.cumsum(0) - all_len          # exclusive
    eoff = boff = 0
    last = pay.shape[0] - 1
    for (s, cap, _sm, n_esc), seg in zip(caps, segs):
        if seg is None:
            continue
        x, y, qpf, cnt, mode, sm = seg
        offs = all_off[boff:boff + cap]
        boff += cap
        ss = s * s
        k = torch.arange(ss, device=pay.device)[None, :]
        bidx = offs[:, None] + torch.where(mode[:, None] == 1, k, k >> 1)
        raw = pay[bidx.clamp(0, last)]
        nib = torch.where((k & 1) == 1, raw >> 4, raw & 15) - 8
        lvs = torch.where(mode[:, None] == 1, raw - 128, nib)
        lvs = torch.where(k < cnt[:, None], lvs, 0)
        inv = TABLES[f"INV_SCAN{s}"].to(pay.device)
        lvf = lvs[:, inv].reshape(-1)                 # scan -> raster
        if n_esc:
            e = esc[eoff:eoff + n_esc]
            eoff += n_esc
            keep = e[:, 0] >= 0
            lvf = lvf.index_add(0, torch.where(keep, e[:, 0], 0),
                                torch.where(keep, e[:, 1], 0))
        yield s, cap, x, y, qpf, sm, lvf.reshape(cap, s, s).to(torch.int32)


def _residual_acc(arena4, arena16, escs, *, caps, H, W, Hc, Wc, bd,
                  group=None):
    """Residual planes of one picture: (acc_l [H, W], acc_c [2, Hc, Wc])
    int32, or (None, None) when it has no residual. TUs of size s are
    s-aligned, so each lands in one cell of a [hg * wg, s, s] slot grid;
    rows that belong to another plane, and the packers' padding rows
    (FAR coordinates), are masked to a zero add at slot 0 instead of
    JAX's dropped out-of-range scatter. group: (gmap [ctbs_h, ctbs_w]
    on the device, g, log2_ctb, hs, vs) keeps only the TUs of tile group
    g (`tile_group_of`), as a tile shard of parallel/mesh.py wants."""
    acc_l = acc_c = None
    for s, cap, x, y, qpf, sm, lv in _arena_levels(arena4, arena16, escs,
                                                   caps):
        plane = qpf & 3
        qp = qpf >> 7
        r = residual_bucket(lv, qp, (qpf >> 2) & 1 != 0, (qpf >> 3) & 1 != 0,
                            (qpf >> 4) & 1 != 0, (qpf >> 5) & 1 != 0,
                            (qpf >> 6) & 1 != 0, s=s, bit_depth=bd, sm=sm)
        inside = (x >= 0) & (y >= 0)
        if group is not None:
            gmap, g, log2_ctb, hs, vs = group
            inside = inside & (tile_group_of(gmap, plane, x, y, log2_ctb,
                                             hs, vs) == g)
        for c in range(3):
            ph, pw = (H, W) if c == 0 else (Hc, Wc)
            hg, wg = -(-ph // s), -(-pw // s)
            slot = (y // s) * wg + x // s
            ok = inside & (plane == c) & (slot < hg * wg)
            g = torch.zeros((hg * wg, s, s), dtype=torch.int32,
                            device=r.device)
            g.index_add_(0, torch.where(ok, slot, 0),
                         torch.where(ok[:, None, None], r, 0))
            g = g.reshape(hg, wg, s, s).permute(0, 2, 1, 3) \
                .reshape(hg * s, wg * s)[:ph, :pw]
            if c == 0:
                acc_l = g if acc_l is None else acc_l + g
            else:
                if acc_c is None:
                    acc_c = torch.zeros((2, Hc, Wc), dtype=torch.int32,
                                        device=r.device)
                acc_c[c - 1] += g
    return acc_l, acc_c


def motion_diff2(pf4, slot, mv):
    """Lossless sparse encoding of the dense per-4x4 motion grids for
    the upload: the 2-D second difference of a field that is constant on
    PU rectangles is nonzero only at PU corners, so the seven fields
    (pf, slot0/1, mv l0/l1 x/y) ship as (flat index, 7 x int16) pairs:
    ~18 B per corner instead of ~18 B per 4x4 block. Device inverse:
    scatter + two int32 cumsums + int16 wrap (`_motion_grids_dev`);
    wrapping int16 differences are exact under mod-2^16 arithmetic.
    Exactly the n nonzero deltas are returned (idx int32 [n], vals
    int16 [n, 7]): nothing here compiles per shape, so there is no
    padding to a cap."""
    h4, w4 = pf4.shape
    F = np.empty((7, h4, w4), np.int16)
    F[0] = pf4
    F[1] = slot[0]
    F[2] = slot[1]
    F[3] = mv[:, :, 0, 0]
    F[4] = mv[:, :, 0, 1]
    F[5] = mv[:, :, 1, 0]
    F[6] = mv[:, :, 1, 1]
    D = F.copy()
    D[:, 1:, :] -= F[:, :-1, :]
    D2 = D.copy()
    D2[:, :, 1:] -= D[:, :, :-1]
    flat = D2.reshape(7, -1)
    nz = np.nonzero(np.any(flat != 0, axis=0))[0]
    return dict(idx=nz.astype(np.int32),
                vals=np.ascontiguousarray(flat[:, nz].T), h4=h4, w4=w4)


def _motion_grids_dev(midx, mvals, h4: int, w4: int):
    """Device inverse of `motion_diff2`: (pf4 [h4, w4], mv [h4, w4, 2,
    2], slot [2, h4, w4]) int32 grids. The cumsums stay int32 (torch
    would widen them to int64); the indices are unique, so the scatter
    is a plain indexed copy."""
    G = torch.zeros((7, h4 * w4), dtype=torch.int32, device=midx.device)
    G.index_copy_(1, midx.long(), mvals.T.to(torch.int32))
    G = G.reshape(7, h4, w4).cumsum(1, dtype=torch.int32) \
        .cumsum(2, dtype=torch.int32)
    G = ((G + (1 << 15)) & 0xFFFF) - (1 << 15)   # int16 wrap = exact
    mv = torch.stack([torch.stack([G[3], G[4]], dim=-1),
                      torch.stack([G[5], G[6]], dim=-1)], dim=-2)
    return G[0], mv, G[1:3]


def weight_grids(fs):
    """Per-4x4 weighted-prediction grids from ref_idx: {wg, og
    [2, 3, h4, w4] int16, denoms (luma, chroma)}, the weighted uni/bi
    combine inputs. None when the picture carries no prediction-weight
    table."""
    if fs.weights is None:
        return None
    mc = fs.motion
    wt = fs.weights
    h4, w4 = mc.pred_flag.shape
    ridx = np.asarray(mc.ref_idx, np.int32)   # [h4,w4,2]
    wg = np.zeros((2, 3, h4, w4), np.int16)
    og = np.zeros((2, 3, h4, w4), np.int16)
    for lx, key in enumerate(("l0", "l1")):
        entries = wt.get(key)
        if not entries:
            continue
        r = np.clip(ridx[:, :, lx], 0, len(entries) - 1)
        for c in range(3):
            wl = np.array([e[0] if c == 0 else e[2][c - 1]
                           for e in entries], np.int32)
            ol = np.array([e[1] if c == 0 else e[3][c - 1]
                           for e in entries], np.int32)
            wg[lx, c] = wl[r]
            og[lx, c] = ol[r]
    return dict(wg=wg, og=og, denoms=(wt["luma_log2_denom"],
                                      wt["chroma_log2_denom"]))


def _slice_plane(flat, c: int, H: int, W: int, Hc: int, Wc: int):
    """Plane c of a decoded picture's device-resident flat output
    (uint8 / uint16 concat of Y, Cb, Cr) as an int32 [h, w] tensor: the
    device-resident DPB's read path (no host round trip). The conversion
    comes first: uint16 tensors support little else."""
    if c == 0:
        return flat[:H * W].to(torch.int32).reshape(H, W)
    off = H * W + (c - 1) * Hc * Wc
    return flat[off:off + Hc * Wc].to(torch.int32).reshape(Hc, Wc)


def _prefill_from_acc(acc_l, acc_c, pf4, mv, slot, hfs, wt, *, H, W, Hc,
                      Wc, hl, wl, hc, wc, bd, hs, vs, denoms, pairs,
                      stage=contextlib.nullcontext):
    """Two-stage MC + (weighted) uni/bi combine + residual add over
    already assembled residual maps; returns the padded prefill buffers
    (luma [hl, wl], chroma [2, hc, wc]) int32, intra pixels 0.
    `stage(name)` is entered around "mc_stage2" and "combine"."""
    put_fn = mc_put_pairs_core if pairs else mc_put_core
    luma = torch.zeros((hl, wl), dtype=torch.int32, device=pf4.device)
    chroma = torch.zeros((2, hc, wc), dtype=torch.int32, device=pf4.device)
    for c in range(3):
        is_luma = c == 0
        ph, pw = (H, W) if is_luma else (Hc, Wc)
        reph = 4 if is_luma else 4 >> hs
        repv = 4 if is_luma else 4 >> vs
        with stage("mc_stage2"):
            puts = [put_fn(hfs[c], mv[:, :, lx], slot[lx], bit_depth=bd,
                           is_luma=is_luma, hs=hs, vs=vs, H=ph, W=pw)
                    for lx in range(2)]
        with stage("combine"):
            def up(a):
                return a.to(torch.int32).repeat_interleave(repv, 0) \
                    .repeat_interleave(reph, 1)[:ph, :pw]

            if acc_l is None:
                res = torch.zeros((ph, pw), dtype=torch.int32,
                                  device=pf4.device)
            else:
                res = acc_l if is_luma else acc_c[c - 1]
            if wt is not None:
                wg, og = wt
                out = combine_plane_w(
                    puts[0], puts[1], up(pf4), res, up(wg[0, c]),
                    up(og[0, c]), up(wg[1, c]), up(og[1, c]), bit_depth=bd,
                    denom=denoms[0 if is_luma else 1])
            else:
                out = combine_plane(puts[0], puts[1], up(pf4), res,
                                    bit_depth=bd)
            dst = luma if is_luma else chroma[c - 1]
            dst[OY:OY + ph, OX:OX + pw] = out
    return luma, chroma


def _inter_prefill(acc_l, acc_c, midx, mvals, hf0, hf1, hf2, wt=None, *,
                   H, W, Hc, Wc, hl, wl, hc, wc, bd, hs, vs, h4, w4,
                   denoms=None, pairs=False,
                   stage=contextlib.nullcontext):
    """Inter-prediction prefill of one picture, all on the device: the
    dense motion grids rebuilt from the sparse PU-corner deltas
    (`motion_diff2`), two-stage MC from the stage-1 planes hf0 / hf1 /
    hf2 of the device-resident references ([R, ...], one per plane),
    uni / bi (weighted) combine and residual add. Returns (luma [hl, wl],
    chroma [2, hc, wc]) int32 padded buffers to hand to the fused intra
    kernel as its starting planes: intra pixels are 0. acc_l / acc_c are
    the picture's residual maps (`_residual_acc`, which the engine
    computes once for this and for the intra kernel; the JAX package's
    function of this name rebuilds them from the arenas)."""
    pf4, mv, slot = _motion_grids_dev(midx, mvals, h4, w4)
    return _prefill_from_acc(acc_l, acc_c, pf4, mv, slot, (hf0, hf1, hf2),
                             wt, H=H, W=W, Hc=Hc, Wc=Wc, hl=hl, wl=wl,
                             hc=hc, wc=wc, bd=bd, hs=hs, vs=vs,
                             denoms=denoms, pairs=pairs, stage=stage)


def upload(arrays: dict, device) -> dict:
    """ONE host->device copy for {name: numpy array}: the arrays are
    packed into one byte buffer (16-byte aligned segments) and viewed
    back as typed tensors on the device, {name: tensor}. No arrays, no
    copy."""
    if not arrays:
        return {}
    offs, off = {}, 0
    for k, a in arrays.items():
        offs[k] = off
        off += (a.nbytes + 15) & ~15
    host = np.zeros(max(off, 16), np.uint8)
    for k, a in arrays.items():
        host[offs[k]:offs[k] + a.nbytes] = \
            np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    dev = torch.from_numpy(host).to(device)
    return {k: dev[offs[k]:offs[k] + a.nbytes]
            .view(getattr(torch, a.dtype.name)).reshape(a.shape)
            for k, a in arrays.items()}


def crop_pack(luma, chroma, H, W, Hc, Wc, bd):
    """Padded int32 planes -> flat [Y | Cb | Cr], uint8 for bd <= 8 and
    uint16 above (the JAX package's _crop_pack)."""
    dt = torch.uint8 if bd <= 8 else torch.uint16
    return torch.cat([luma[OY:OY + H, OX:OX + W].reshape(-1),
                      chroma[:, OY:OY + Hc, OX:OX + Wc].reshape(-1)]) \
        .to(dt)


def pack_planes(y, cb, cr, bd):
    """Un-padded int32 planes -> flat [Y | Cb | Cr] (`crop_pack`'s
    dtypes)."""
    dt = torch.uint8 if bd <= 8 else torch.uint16
    return torch.cat([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)]).to(dt)


def host_filtered(fs: FrameSymbols, flat, H, W, Hc, Wc):
    """The unfiltered flat output `flat` of a picture fetched, filtered
    on the host on the reference's CTB schedule (ops/filters_sched.py)
    and kept there: a filter plan's host route (the picture's filters
    lie outside the whole-frame device model)."""
    planes = TorchPlanes(flat, H, W, Hc, Wc).get()
    out = apply_loop_filters(planes, fs)
    host = np.concatenate([p.reshape(-1) for p in out]) \
        .astype(planes[0].dtype)
    return TorchPlanes(torch.from_numpy(host), H, W, Hc, Wc)


def check_slice(fs: FrameSymbols):
    """Raise NotImplementedError for a picture outside the ported path."""
    sps = fs.sps
    why = None
    if sps.chroma_format_idc not in (1, 2, 3):
        # the residual, the kernels' planes and the filters all assume
        # two chroma planes
        why = ("monochrome (4:0:0): outside what this decoder supports "
               "(4:2:0, 4:2:2 and 4:4:4)")
    elif sps.bit_depth_chroma != sps.bit_depth:
        # both fused kernels and the residual take one bit depth for all
        # three planes
        why = (f"unequal luma / chroma bit depths {sps.bit_depth}/"
               f"{sps.bit_depth_chroma}: outside what this decoder "
               f"supports (equal depths of 8 to 12 bits)")
    elif not 8 <= sps.bit_depth <= 12:
        why = (f"bit depth {sps.bit_depth}: outside what this decoder "
               f"supports (equal depths of 8 to 12 bits)")
    if why:
        raise NotImplementedError(f"POC {fs.poc}: {why}")


def host_pack(fs: FrameSymbols) -> dict:
    """The picture's residual arenas, intra job meta and number of
    wavefront levels (`n_levels`) for the upload: the native packer's
    (`fs.native_pack`) where it ran, else the Python packer's, in the
    same byte format and with the same six-row meta, over the native
    parser's raw arrays (a picture with scaling lists) or the Python
    parser's objects (its levels by `object_levels`)."""
    if fs.native_pack is not None:
        return fs.native_pack
    raw = fs.native_raw
    arena4, arena16, esc, caps = _pack_arena(_res_buckets(fs))
    if raw is not None:
        meta6, n_levels = meta6_native(raw), raw["n_levels"]
    else:
        meta6, n_levels = meta6_objects(fs.intra_jobs, fs.sps.height,
                                        fs.sps.width)
    return dict(arena4=arena4, arena16=arena16, esc=esc, caps=caps,
                meta6=meta6, n=meta6.shape[1], n_levels=n_levels)


def pcm_scatter(fs: FrameSymbols, wl: int, wc: int, hc: int):
    """The PCM samples of a picture as flat (index, value) pairs into
    the padded planes: (idx_l int32, val_l int16, idx_c int32, val_c
    int16), chroma indices into the [2, hc, wc] stack. The starting
    planes (zeros or the inter prediction) take them with one indexed
    store a plane; PCM blocks carry no residual and no intra job."""
    sps = fs.sps
    hs, vs = sps.hshift1, sps.vshift1
    il, vl, ic, vc = [], [], [], []
    for p in fs.pcm_blocks:
        s = p.size
        yy, xx = np.mgrid[0:s, 0:s]
        il.append(((OY + p.y + yy) * wl + OX + p.x + xx).reshape(-1))
        vl.append(np.asarray(p.samples_y).reshape(-1))
        cy, cx = np.mgrid[0:s >> vs, 0:s >> hs]
        base = (OY + (p.y >> vs) + cy) * wc + OX + (p.x >> hs) + cx
        for k, smp in enumerate((p.samples_cb, p.samples_cr)):
            ic.append((k * hc * wc + base).reshape(-1))
            vc.append(np.asarray(smp).reshape(-1))
    return (np.concatenate(il).astype(np.int32),
            np.concatenate(vl).astype(np.int16),
            np.concatenate(ic).astype(np.int32),
            np.concatenate(vc).astype(np.int16))


class TorchPlanes:
    """A decoded picture whose flat output (uint8, or uint16 above 8
    bits: `crop_pack`) stays on the device (the DPB entry, which later
    pictures predict from: `TorchEngine._ref_plane_dev`); `get()`
    fetches it to the host once and splits it into [Y, Cb, Cr] arrays of
    that dtype. Quacks like the [Y, Cb, Cr] list the decoder expects.
    device_filtered: the in-loop filters ran on the device. pid: the
    decoder's picture id, which the `fetch` span carries."""

    pid = None

    def __init__(self, flat: torch.Tensor, H, W, Hc, Wc,
                 device_filtered=False):
        self._dev = flat
        self._dims = (H, W, Hc, Wc)
        self._mat = None
        self.device_filtered = device_filtered

    def get(self):
        if self._mat is None:
            H, W, Hc, Wc = self._dims
            with trace.span("fetch", pic=self.pid):
                host = self._dev.cpu().numpy()
            self._mat = [host[:H * W].reshape(H, W),
                         host[H * W:H * W + Hc * Wc].reshape(Hc, Wc),
                         host[H * W + Hc * Wc:].reshape(Hc, Wc)]
        return self._mat

    def __getitem__(self, i):
        return self.get()[i]

    def __iter__(self):
        return iter(self.get())

    def __len__(self):
        return 3


class Stage1Cache:
    """Stage-1 MC planes of reference pictures in one mode (tap or
    pair). The planes of every cached picture lie side by side:
    `bufs[c]` is ONE tensor [S, *stage1_shape] per plane c, and a
    picture owns the same slot in all three, so stage 2 gathers by
    (slot, ...) and nothing is stacked per predicted picture. A
    reference is filtered once, however many pictures read it.

    Entries are keyed by the reference's planes object: weakly where the
    object allows it (a reused id is caught by the identity test), else
    by a strong reference that the entry's eviction drops. Slots are
    freed, in this order, when their object has died, when it is no
    longer among the pictures the decoder still holds as references
    (`live`), and least recently used first once `max_slots` is reached:
    at least the slots this picture needs, and as many more as the byte
    budget allows, at most MAX_REFS."""

    MAX_REFS = 17          # a full DPB (16 pictures) and one more

    def __init__(self, pairs: bool, budget: int):
        self.pairs = pairs
        self.budget = budget
        self.sig = None
        self.bufs = None
        self.entries = OrderedDict()     # id(obj) -> (ref() -> obj, slot)
        self.hits = self.misses = 0

    def nbytes(self):
        return sum(b.numel() * b.element_size() for b in self.bufs or ())

    def _shapes(self, dims):
        H, W, Hc, Wc = dims
        return (stage1_shape(H, W, True, self.pairs),
                stage1_shape(Hc, Wc, False, self.pairs),
                stage1_shape(Hc, Wc, False, self.pairs))

    def _take_slot(self, wanted, live, max_slots, shapes, device):
        used = {slot for _ref, slot in self.entries.values()}
        n = 0 if self.bufs is None else self.bufs[0].shape[0]
        for slot in range(n):
            if slot not in used:
                return slot
        drop = [k for k, (ref, _s) in self.entries.items()
                if ref() is None or k not in live]
        if not drop and n >= max_slots:
            drop = [k for k in self.entries if k not in wanted]
        if drop:
            return self.entries.pop(drop[0])[1]
        grown = [torch.empty((n + 1,) + sh, dtype=torch.int16, device=device)
                 for sh in shapes]
        if n:
            for g, b in zip(grown, self.bufs):
                g[:n] = b
        self.bufs = grown
        return n

    def slots(self, objs, dims, bd, plane_of, live, device):
        """Slots of the reference objects `objs` (their stage-1 planes
        computed now where missing, from `plane_of(obj, c)` -> int32
        plane on the device). Returns (bufs, [slot per object])."""
        sig = (dims, bd, torch.device(device))
        if sig != self.sig:
            self.sig, self.bufs = sig, None
            self.entries.clear()
        shapes = self._shapes(dims)
        per_ref = 2 * sum(int(np.prod(sh)) for sh in shapes)
        wanted = {id(o) for o in objs}
        max_slots = max(len(wanted),
                        min(self.MAX_REFS, self.budget // per_ref))
        fn = mc_prefilter_pairs if self.pairs else mc_hprefilter
        out = []
        for o in objs:
            key = id(o)
            hit = self.entries.get(key)
            if hit is not None and hit[0]() is o:
                self.entries.move_to_end(key)
                self.hits += 1
                out.append(hit[1])
                continue
            if hit is not None:              # a dead object's id, reused
                slot = self.entries.pop(key)[1]
            else:
                slot = self._take_slot(wanted, live, max_slots, shapes,
                                       device)
            for c in range(3):
                fn(plane_of(o, c), bd, c == 0, out=self.bufs[c][slot])
            try:
                ref = weakref.ref(o)
            except TypeError:                # a plain list of host planes
                ref = (lambda o=o: o)
            self.entries[key] = (ref, slot)
            self.misses += 1
            out.append(slot)
        return self.bufs, out


class TorchEngine:
    """Reconstructs parsed pictures on one torch device."""

    # The JAX package's whole-frame gate (pipeline.py FUSED_VMEM_BUDGET):
    # frames whose padded int32 recon + residual planes exceed it take
    # the banded kernel, as they take `_build_banded` there.
    FUSED_VMEM_BUDGET = 12 * 2 ** 20
    # The JAX package's rule for the MC mode (pipeline.py
    # MC_PAIRS_MAX_PIXELS), kept as the default: pictures up to this many
    # luma samples (4K included) take the all-phase-pair stage 1 and the
    # one-gather stage 2, larger ones the tap mode. Both modes give the
    # same samples; chip_smoke.py times both (PERF.md).
    MC_PAIRS_MAX_PIXELS = 8_500_000

    def __init__(self, device="cuda", sync_timers=False):
        """sync_timers: synchronise around every stage and add up its
        wall time in `stage_ms` (diagnosis only: it serialises host and
        device). Every stage is also a span of utils/trace.py, recorded
        while a profiler records. `h2d_bytes` counts the bytes this
        engine copies from host memory: the one upload a picture, and
        reference planes that lie on the host (a concealment frame; on a
        card, a picture kept on the host). A plane already on a card is
        not counted, whatever its index."""
        self.device = torch.device(device)
        self.sync_timers = sync_timers
        self.stage_ms = {}
        self.h2d_bytes = 0
        # byte budget of the stage-1 cache: a quarter of the card's memory
        # (1 GiB on the CPU)
        budget = 2 ** 30 if self.device.type != "cuda" else \
            torch.cuda.get_device_properties(self.device).total_memory // 4
        self._stage1 = {pairs: Stage1Cache(pairs, budget)
                        for pairs in (False, True)}

    @contextlib.contextmanager
    def _stage(self, name):
        with trace.span(name):
            if not self.sync_timers:
                yield
                return
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize(self.device)
                self.stage_ms[name] = self.stage_ms.get(name, 0.0) + \
                    (time.perf_counter() - t0) * 1e3

    def fused_plan(self, fs: FrameSymbols):
        """("whole", (hl, wl, hc, wc)) when the padded planes fit the
        whole-frame gate, else ("banded", (hl, wl, hc, wc), band_h,
        nbands) at `band_plan`'s dims (the JAX package's `_fused_plan`),
        else, where `band_plan` finds no band (4:2:2 UHD at CTB 64, 4:4:4
        from 2440 wide, 8K 4:2:0), ("no_band_plan", (hl, wl, hc, wc)):
        the whole-frame kernel on the padded frame.

        Both gates are the TPU's: the whole-frame one is a VMEM limit and
        `band_plan` sizes bands for 9 MiB of VMEM scratch. Both CUDA
        kernels keep the planes in global memory, so the whole-frame
        kernel takes a frame of any size; the gates are kept where a band
        plan exists so that every stream takes the kernel the JAX package
        would, and the last case takes the whole-frame kernel, whose
        output equals the JAX package's packed path there."""
        sps = fs.sps
        H, W = sps.height, sps.width
        Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
        hl, wl = padded_dims(H, W)
        hc, wc = padded_dims(Hc, Wc)
        if (hl * wl + 2 * hc * wc) * 4 * 2 <= self.FUSED_VMEM_BUDGET:
            return ("whole", (hl, wl, hc, wc))
        plan = band_plan(H, W, Hc, Wc, sps.ctb_size, sps.vshift1)
        if plan is None:
            return ("no_band_plan", (hl, wl, hc, wc))
        band_h, nb, hl, wl, hc, wc = plan
        return ("banded", (hl, wl, hc, wc), band_h, nb)

    # ---- inter prediction: references and motion -------------------------

    def _ref_plane_dev(self, planes_obj, c):
        """Plane c of a reference picture as an int32 tensor on this
        engine's device. A decoded picture (`TorchPlanes`) is sliced from
        its flat output where it lies (uploaded if that is the host: a
        picture of the host-filter route); a host-only picture (the
        mid-grey concealment frame of a missing reference) is uploaded.
        Either upload happens once per stay in the stage-1 cache."""
        flat = getattr(planes_obj, "_dev", None)
        if flat is not None:
            plane = _slice_plane(flat, c, *planes_obj._dims)
            if plane.device.type == "cpu" and self.device.type != "cpu":
                self.h2d_bytes += plane.nbytes
            return plane.to(self.device)
        src = np.ascontiguousarray(planes_obj[c], np.int32)
        self.h2d_bytes += src.nbytes
        return torch.from_numpy(src).to(self.device)

    def _hf_stack(self, pocs, ref_planes, dims, bd, pairs):
        """Stage-1 planes of the listed reference pictures: (bufs, slots)
        with bufs[c] [S, P, Hp, wn] (tap mode) or [S, Py, Px, hn, wn]
        (pair mode) for plane c and slots[i] the slot of pocs[i] in all
        three (`Stage1Cache`). The span carries the cache's hits and
        misses in it."""
        live = {id(o) for o in ref_planes.values()}
        cache = self._stage1[pairs]
        hits, misses = cache.hits, cache.misses
        with self._stage("mc_stage1"):
            out = cache.slots([ref_planes[p] for p in pocs], dims, bd,
                              self._ref_plane_dev, live, self.device)
            trace.annotate(hits=cache.hits - hits,
                           misses=cache.misses - misses)
        return out

    def pairs_mode(self, fs: FrameSymbols) -> bool:
        """Whether this picture's MC takes the all-phase-pair mode."""
        return fs.sps.height * fs.sps.width <= self.MC_PAIRS_MAX_PIXELS

    def _pack_inter(self, fs: FrameSymbols, ref_planes, dims):
        """The picture's motion for the device MC: the stage-1 planes of
        its references (`hf`), the sparse deltas of the per-4x4 grids
        pred_flag / reference slot / MV (`md`), the weight grids (`wt`,
        None without a weight table). None when no reference picture of
        its lists is at hand."""
        mc = fs.motion
        pocs = sorted({p for p in set(fs.ref_poc_l0) | set(fs.ref_poc_l1)
                       if p in ref_planes})
        if not pocs:
            return None
        pairs = self.pairs_mode(fs)
        hf, slots = self._hf_stack(pocs, ref_planes, dims, fs.sps.bit_depth,
                                   pairs)
        h4, w4 = mc.pred_flag.shape
        # poc -> cache slot via one searchsorted per list (pocs sorted);
        # a poc whose picture is not at hand maps to the first one's
        keys, slot_of = np.asarray(pocs), np.asarray(slots)
        slot = np.zeros((2, h4, w4), np.uint8)
        for lx in range(2):
            pocg = np.asarray(mc.refpoc[:, :, lx])
            idx = np.clip(np.searchsorted(keys, pocg), 0, len(keys) - 1)
            slot[lx] = np.where(keys[idx] == pocg, slot_of[idx], slot_of[0])
        # qpel MVs are spec-bounded to +-2^15: exact in int16
        md = motion_diff2(np.asarray(mc.pred_flag, np.uint8), slot,
                          np.asarray(mc.mv, np.int16))
        return dict(hf=hf, pairs=pairs, md=md, wt=weight_grids(fs))

    # ---- one picture ---------------------------------------------------------

    def reconstruct(self, fs: FrameSymbols,
                    ref_planes=None) -> TorchPlanes:
        """Reconstruct one parsed picture; the output stays on the
        device and nothing is read back from it, bar a picture whose
        filter plan takes the host route: its unfiltered planes are
        fetched, filtered on the host on the reference's CTB schedule
        (ops/filters_sched.py) and the result stays on the host (timed as
        "host_filters"). ref_planes: {poc: planes} of the pictures the
        decoder holds as references (decoded pictures as `TorchPlanes`,
        read where they lie; host-only concealment frames as [Y, Cb, Cr]
        arrays). Returns a `TorchPlanes`."""
        k = self.prepare(fs, ref_planes)
        self.launch(k)
        return self.finish(fs, k)

    def launch(self, k: dict):
        """The fused intra kernel on `prepare`'s arguments k (planes
        updated in place): whole-frame or banded, as k's plan says."""
        tail = (k["luma"], k["chroma"], k["res_l"], k["res_c"], k["bd"],
                k["order"], k["level_bounds"])
        with self._stage("kernel"):
            if k["bounds"] is None:
                intra_fused(k["meta"], k["n"], *tail)
            else:
                intra_fused_banded(k["meta"], k["bounds"], k["n"], *tail)

    def finish(self, fs: FrameSymbols, k: dict) -> TorchPlanes:
        """Steps 6-7 after `launch`: the in-loop filters on the un-padded
        views as the picture's filter plan says (on the device, or the
        host route), crop, downcast."""
        H, W, Hc, Wc = k["dims"]
        bd, f = k["bd"], k["filters"]
        if f is not None and f.route == "host":
            with self._stage("host_filters"):
                return host_filtered(fs, crop_pack(k["luma"], k["chroma"], H,
                                                   W, Hc, Wc, bd), H, W, Hc,
                                     Wc)
        if f is None:
            with self._stage("crop_pack"):
                flat = crop_pack(k["luma"], k["chroma"], H, W, Hc, Wc, bd)
        else:
            y, cb, cr = f.apply(k["luma"][OY:OY + H, OX:OX + W],
                                k["chroma"][0, OY:OY + Hc, OX:OX + Wc],
                                k["chroma"][1, OY:OY + Hc, OX:OX + Wc],
                                k["filter_args"], stage=self._stage)
            with self._stage("crop_pack"):
                flat = pack_planes(y, cb, cr, bd)
        return TorchPlanes(flat, H, W, Hc, Wc, device_filtered=f is not None)

    def prepare(self, fs: FrameSymbols, ref_planes=None, shard=None) -> dict:
        """Steps 1-5 up to the intra kernel: the kernel's arguments
        (meta, n, luma, chroma, res_l, res_c, bd, order, level_bounds,
        and bounds, None for the whole-frame kernel) plus the frame dims
        (H, W, Hc, Wc), `filters` (the picture's filter plan,
        `plan_filters`, or None) and `filter_args` (on the plan's device
        route its arguments, `plan.args`; else None), all on this
        engine's device. For a banded plan the meta is band sorted (its
        bounds checked here, on the host) and the planes have
        `band_plan`'s dims. The level schedule is made on the device from
        the uploaded level row.

        The starting planes luma / chroma hold, by what the picture is:
        on an inter picture with a reference at hand, the inter
        prediction + residual; without one (none of its references is
        among ref_planes), zeros, as the JAX package's packed path leaves
        inter blocks then; on any picture, its PCM samples written over
        that; elsewhere 0. Intra pixels are 0.

        shard=(gmap, g) (one tile shard, parallel/mesh.py): the meta is
        cut to group g's jobs on the host before the upload
        (`meta6_tile_group`: levels renumbered densely; band sorted after
        the cut on a banded plan), gmap rides in the upload and the
        residual keeps group g's TUs only; no filter plan is made
        (`filters` None): the mesh filters the combined picture."""
        check_slice(fs)
        sps = fs.sps
        H, W = sps.height, sps.width
        hs, vs = sps.hshift1, sps.vshift1
        Hc, Wc = H >> vs, W >> hs
        bd = sps.bit_depth
        plan = self.fused_plan(fs)
        hl, wl, hc, wc = plan[1]

        # ---- host side: everything that rides in the one upload ----------
        with self._stage("host_pack"):
            npk = host_pack(fs)
            n, meta6, n_levels = npk["n"], npk["meta6"], npk["n_levels"]
            if shard is not None:
                gmap, g = shard
                meta6, n, n_levels = meta6_tile_group(
                    meta6, n, gmap, g, sps.log2_ctb, hs, vs)
            host = dict(arena4=npk["arena4"], arena16=npk["arena16"],
                        esc=npk["esc"], meta6=meta6)
            if shard is not None:
                host["gmap"] = np.ascontiguousarray(gmap, np.int32)
            smap = ccp_scale_map(fs)
            if smap is not None:
                host["ccp"] = smap
            if plan[0] == "banded":
                host["meta6"], host["bounds"] = sort_meta_by_band(
                    meta6, n, plan[2], vs, plan[3])
                check_rising(host["bounds"], n, "bounds")
            filters = None if shard is not None else plan_filters(fs)
            on_device = filters is not None and filters.route == "device"
            if on_device:
                host.update(filters.arrays)
            if fs.pcm_blocks:
                host.update(zip(("pcm_il", "pcm_vl", "pcm_ic", "pcm_vc"),
                                pcm_scatter(fs, wl, wc, hc)))
        inter = None
        if fs.inter_pbs:
            inter = self._pack_inter(fs, ref_planes or {}, (H, W, Hc, Wc))
        if inter is not None:
            md, wt = inter["md"], inter["wt"]
            host.update(md_idx=md["idx"], md_vals=md["vals"])
            if wt is not None:
                host.update(wt_w=wt["wg"], wt_o=wt["og"])
        with self._stage("upload"):
            dev = upload(host, self.device)
            self.h2d_bytes += dev["arena4"].untyped_storage().nbytes()
        meta6 = dev["meta6"]
        filter_args = filters.args(dev, self._stage) if on_device else None

        with self._stage("residual"):
            group = None if shard is None else \
                (dev["gmap"], shard[1], sps.log2_ctb, hs, vs)
            acc_l, acc_c = _residual_acc(dev["arena4"], dev["arena16"],
                                         dev["esc"],
                                         caps=npk["caps"], H=H, W=W, Hc=Hc,
                                         Wc=Wc, bd=bd, group=group)
            if "ccp" in dev and acc_l is not None:
                acc_c = _apply_ccp(acc_l, acc_c, dev["ccp"])
            res_l = torch.zeros((hl, wl), dtype=torch.int32,
                                device=self.device)
            res_c = torch.zeros((2, hc, wc), dtype=torch.int32,
                                device=self.device)
            if acc_l is not None:
                res_l[OY:OY + H, OX:OX + W] = acc_l
                res_c[:, OY:OY + Hc, OX:OX + Wc] = acc_c

        # ---- starting planes (inter prediction or zeros; PCM samples) ----
        if inter is not None:
            luma, chroma = _inter_prefill(
                acc_l, acc_c, dev["md_idx"], dev["md_vals"], *inter["hf"],
                wt=(dev["wt_w"], dev["wt_o"]) if wt else None,
                H=H, W=W, Hc=Hc, Wc=Wc, hl=hl, wl=wl, hc=hc, wc=wc, bd=bd,
                hs=hs, vs=vs, h4=md["h4"], w4=md["w4"],
                denoms=tuple(wt["denoms"]) if wt else None,
                pairs=inter["pairs"], stage=self._stage)
        else:
            luma = torch.zeros((hl, wl), dtype=torch.int32,
                               device=self.device)
            chroma = torch.zeros((2, hc, wc), dtype=torch.int32,
                                 device=self.device)
        if fs.pcm_blocks:
            luma.view(-1)[dev["pcm_il"].long()] = dev["pcm_vl"].to(torch.int32)
            chroma.view(-1)[dev["pcm_ic"].long()] = \
                dev["pcm_vc"].to(torch.int32)

        with self._stage("meta_schedule"):
            order, level_bounds = level_schedule(meta6[5], n, n_levels)
            meta16 = derive_meta16(
                meta6[:5],
                sdis=bool(getattr(sps, "intra_smoothing_disabled", 0)),
                c444=sps.chroma_format_idc == 3,
                strong=bool(sps.strong_intra_smoothing))
        return dict(meta=meta16, n=n, bounds=dev.get("bounds"), order=order,
                    level_bounds=level_bounds, luma=luma, chroma=chroma,
                    res_l=res_l, res_c=res_c, bd=bd, dims=(H, W, Hc, Wc),
                    hs=hs, vs=vs, filters=filters, filter_args=filter_args)
