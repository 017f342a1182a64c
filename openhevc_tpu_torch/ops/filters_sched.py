"""The in-loop filters on the reference's exact CTB schedule, run on
the host (numpy): the route of pictures whose in-loop filters fall
outside the whole-frame device model (the host route of their filter
plan, `ops/filters.py::plan_filters`). TorchEngine and a mesh's tile
axis fetch such a picture's unfiltered planes, run `apply_loop_filters`
here and keep the result on the host.

The reference interleaves deblocking and SAO in a one-CTB-lagged pipeline
(ff_hevc_hls_filters / ff_hevc_hls_filter, hevc_filter.c:1027-1064) with
per-CTB snapshot buffering for SAO (sao_filter_CTB, :197). The observable
output differs from the spec's whole-frame deblock-then-SAO at a handful of
halo samples per CTB (deferred chroma horizontal chunks, boundary-CTB call
reordering), so for bit-exactness against the oracle we reproduce the
schedule itself:

  per parsed CTB (raster): hls_filters(x, y); after the last CTB:
  hls_filter(x_last, y_last). hls_filter = deblock(CTB) then SAO of up-left
  (and boundary variants). SAO reads a per-CTB snapshot of the deblocked
  frame captured at its own call time (halo copy rules included).

Own copy of the JAX package's ops/filters_sched.py, with the pieces it
took from that package's scalar deblocking and SAO modules (the edge
segment filters, the SAO edge-class tables) copied in; the boundary
strengths and the no-filter mask are ops/filters.py's.
"""
from __future__ import annotations

import numpy as np

from ..symbols import FrameSymbols
from ..bitstream.syntax import chroma_qp
from .filters import _no_filter_mask, boundary_strengths_vec
from .tables import BETA_TABLE, TC_TABLE

# SAO edge class -> (neighbour a, neighbour b) offsets (dx, dy)
EO_NEIGHBORS = {
    0: ((-1, 0), (1, 0)),
    1: ((0, -1), (0, 1)),
    2: ((-1, -1), (1, 1)),
    3: ((1, -1), (-1, 1)),
}
# edgeIdx (2 + sign + sign) -> offset slot (0 = unchanged)
EDGE_IDX_MAP = (1, 2, 0, 3, 4)
APPLIED = 4


def apply_loop_filters(planes, fs: FrameSymbols):
    sps = fs.sps
    do_deblock = not fs.deblock_disabled
    do_sao = fs.sao_luma or fs.sao_chroma
    if not do_deblock and not do_sao:
        return planes
    frame = [np.array(p, np.int64) for p in planes]
    snap = [p.copy() for p in frame]
    ctb = 1 << sps.log2_ctb
    W, H = sps.width, sps.height
    if do_deblock:
        vbs, hbs = boundary_strengths_vec(fs)
    else:
        vbs = hbs = None
    nf = _no_filter_mask(fs)
    state = fs.sao[:, :, :, 0].astype(np.int32).copy()  # mutates to APPLIED

    def hls_filters(x, y):
        x_end = x >= W - ctb
        y_end = y >= H - ctb
        if y and x:
            hls_filter(x - ctb, y - ctb)
        if y and x_end:
            hls_filter(x, y - ctb)
        if x and y_end:
            hls_filter(x - ctb, y)

    def hls_filter(x, y):
        if do_deblock:
            _deblock_ctb(frame, fs, vbs, hbs, nf, x, y)
        if do_sao:
            x_end = x >= W - ctb
            y_end = y >= H - ctb
            if y and x:
                _sao_ctb(x - ctb, y - ctb)
            if x and y_end:
                _sao_ctb(x - ctb, y)
            if y and x_end:
                _sao_ctb(x, y - ctb)
            if x_end and y_end:
                _sao_ctb(x, y)

    def _sao_ctb(x, y):
        rx, ry = x >> sps.log2_ctb, y >> sps.log2_ctb
        edges = (rx == 0, ry == 0,
                 rx == sps.ctbs_w - 1, ry == sps.ctbs_h - 1)
        n_planes = 3 if sps.chroma_format_idc else 1
        for c in range(n_planes):
            t = int(fs.sao[ry, rx, c, 0])
            if t == 0:
                continue
            hs = sps.hshift1 if c else 0
            vs = sps.vshift1 if c else 0
            pw, ph = frame[c].shape[1], frame[c].shape[0]
            x0, y0 = x >> hs, y >> vs
            width = min(ctb >> hs, pw - x0)
            height = min(ctb >> vs, ph - y0)
            fr, sn = frame[c], snap[c]
            if t == 1:  # band
                sn[y0:y0 + height, x0:x0 + width] = \
                    fr[y0:y0 + height, x0:x0 + width]
                self_band(fr, sn, fs, ry, rx, c, x0, y0, width, height)
            else:
                # halo copies into the snapshot (sao_filter_CTB rules)
                left_pixels = (not edges[0]) and \
                    state[ry, rx - 1, c] != APPLIED
                if not edges[1]:
                    top_left = (not edges[0]) and \
                        state[ry - 1, rx - 1, c] != APPLIED
                    top_right = (not edges[2]) and \
                        state[ry - 1, rx + 1, c] != APPLIED
                    if state[ry - 1, rx, c] == 0:
                        xs = x0 - (1 if top_left else 0)
                        xe = min(x0 + width + (1 if top_right else 0), pw)
                        sn[y0 - 1, xs:xe] = fr[y0 - 1, xs:xe]
                    else:
                        if top_left:
                            sn[y0 - 1, x0 - 1] = fr[y0 - 1, x0 - 1]
                        if top_right and x0 + width < pw:
                            sn[y0 - 1, x0 + width] = fr[y0 - 1, x0 + width]
                if not edges[3]:
                    bottom_left = (not edges[0]) and \
                        state[ry + 1, rx - 1, c] != APPLIED
                    xs = x0 - (1 if bottom_left else 0)
                    xe = min(x0 + width + 1, pw)
                    sn[y0 + height, xs:xe] = fr[y0 + height, xs:xe]
                xs = x0 - (1 if left_pixels else 0)
                xe = min(x0 + width + 1, pw)
                sn[y0:y0 + height, xs:xe] = fr[y0:y0 + height, xs:xe]
                self_edge(fr, sn, fs, ry, rx, c, x0, y0, width, height,
                          edges)
            _restore_ctb(fr, sn, nf, x, y, width, height, hs, vs)
            state[ry, rx, c] = APPLIED

    def self_band(fr, sn, fs, ry, rx, c, x0, y0, width, height):
        bd = sps.bit_depth if c == 0 else sps.bit_depth_chroma
        maxv = (1 << bd) - 1
        offs = fs.sao[ry, rx, c, 2:6].astype(np.int64)
        band_pos = int(fs.sao[ry, rx, c, 1])
        table = np.zeros(32, np.int64)
        for k in range(4):
            table[(band_pos + k) & 31] = offs[k]
        blk = sn[y0:y0 + height, x0:x0 + width]
        fr[y0:y0 + height, x0:x0 + width] = \
            np.clip(blk + table[blk >> (bd - 5)], 0, maxv)

    def self_edge(fr, sn, fs, ry, rx, c, x0, y0, width, height, edges):
        bd = sps.bit_depth if c == 0 else sps.bit_depth_chroma
        maxv = (1 << bd) - 1
        offs = fs.sao[ry, rx, c, 2:6].astype(np.int64)
        eo = int(fs.sao[ry, rx, c, 1])
        (ax, ay), (bx, by) = EO_NEIGHBORS[eo]
        # picture-border restrictions along the class axis
        sx0 = x0 + (1 if (edges[0] and min(ax, bx) < 0) else 0)
        sy0 = y0 + (1 if (edges[1] and min(ay, by) < 0) else 0)
        sx1 = x0 + width - (1 if (edges[2] and max(ax, bx) > 0) else 0)
        sy1 = y0 + height - (1 if (edges[3] and max(ay, by) > 0) else 0)
        if sx0 >= sx1 or sy0 >= sy1:
            return
        cc = sn[sy0:sy1, sx0:sx1]
        a = sn[sy0 + ay:sy1 + ay, sx0 + ax:sx1 + ax]
        b = sn[sy0 + by:sy1 + by, sx0 + bx:sx1 + bx]
        idx = 2 + np.sign(cc - a) + np.sign(cc - b)
        table = np.zeros(5, np.int64)
        for k in range(5):
            slot = EDGE_IDX_MAP[k]
            table[k] = 0 if slot == 0 else offs[slot - 1]
        fr[sy0:sy1, sx0:sx1] = np.clip(cc + table[idx], 0, maxv)

    def _restore_ctb(fr, sn, nf, x, y, width, height, hs, vs):
        """restore_tqb_pixels behavior (hevc_filter.c:163) — NOTE the
        reference passes the *plane-unit* width/height with luma x/y, so
        for chroma only the top-left quadrant of the CTB is restored; we
        reproduce that faithfully."""
        if nf is None:
            return
        x4a, y4a = x >> 2, y >> 2
        x4b = min((x + width) >> 2, nf.shape[1])
        y4b = min((y + height) >> 2, nf.shape[0])
        ys, xs = np.nonzero(nf[y4a:y4b, x4a:x4b])
        for yy, xx in zip(ys + y4a, xs + x4a):
            py, px = (yy * 4) >> vs, (xx * 4) >> hs
            n = 4 >> hs
            nv = 4 >> vs
            fr[py:py + nv, px:px + n] = sn[py:py + nv, px:px + n]

    cs = ctb
    if fs.ctb_order is not None:
        order = fs.ctb_order
    else:
        order = [(rx * cs, ry * cs) for ry in range(sps.ctbs_h)
                 for rx in range(sps.ctbs_w)]
    for (x, y) in order:
        hls_filters(x, y)
    hls_filter(*order[-1])
    return frame


def _deblock_ctb(planes, fs: FrameSymbols, vbs, hbs, nf, x0, y0):
    """deblocking_filter_CTB behavior (hevc_filter.c:345): this CTB's
    vertical edges, then horizontal edges with the right-column deferral."""
    sps = fs.sps
    bd = sps.bit_depth
    ctb = 1 << sps.log2_ctb
    W, H = sps.width, sps.height
    beta_off, tc_off = fs.beta_offset, fs.tc_offset
    qp4 = fs.qp_y4.astype(np.int32)
    ypl = planes[0]
    x_end = min(x0 + ctb, W)
    y_end = min(y0 + ctb, H)
    x_end2 = x_end

    def get_nf(x4, y4):
        return bool(nf[y4, x4]) if nf is not None else False

    # vertical luma
    for y in range(y0, y_end, 8):
        for x in range(x0 if x0 else 8, x_end, 8):
            for sub in (0, 4):
                yy = y + sub
                if yy >= y_end:
                    continue
                bs = vbs[yy >> 2, x >> 3]
                if not bs:
                    continue
                qp = (int(qp4[yy >> 2, (x - 1) >> 2]) +
                      int(qp4[yy >> 2, x >> 2]) + 1) >> 1
                beta = int(BETA_TABLE[np.clip(qp + beta_off, 0, 51)]) \
                    << (bd - 8)
                tc = int(TC_TABLE[np.clip(qp + 2 * (bs - 1) + tc_off,
                                          0, 53)]) << (bd - 8)
                _luma_edge_seg(ypl, x, yy, True, beta, tc,
                               get_nf((x - 1) >> 2, yy >> 2),
                               get_nf(x >> 2, yy >> 2), bd)
    # vertical chroma (hevc_filter.c:423-432: steps of 8*h / 8*v luma
    # samples, two 4-chroma-line segments per step)
    if sps.chroma_format_idc:
        bdc = sps.bit_depth_chroma
        ch, cv = 1 << sps.hshift1, 1 << sps.vshift1
        for c_idx in (1, 2):
            pl = planes[c_idx]
            off = fs.pps.cb_qp_offset if c_idx == 1 else fs.pps.cr_qp_offset
            for y in range(y0, y_end, 8 * cv):
                for x in range(x0 if x0 else 8 * ch, x_end, 8 * ch):
                    for sub in (0, 4 * cv):
                        yy = y + sub
                        if yy >= y_end:
                            continue
                        bs = vbs[yy >> 2, x >> 3]
                        if bs != 2:
                            continue
                        qp_l = (int(qp4[yy >> 2, (x - 1) >> 2]) +
                                int(qp4[yy >> 2, x >> 2]) + 1) >> 1
                        qpc = chroma_qp(qp_l, off, sps.chroma_format_idc, 0)
                        tc = int(TC_TABLE[np.clip(qpc + 2 + tc_off,
                                                  0, 53)]) << (bdc - 8)
                        _chroma_edge_seg(pl, x >> sps.hshift1,
                                         yy >> sps.vshift1, True, tc,
                                         get_nf((x - 1) >> 2, yy >> 2),
                                         get_nf(x >> 2, yy >> 2), bdc)
    # horizontal luma (defer last 8 columns unless at picture edge)
    if x_end != W:
        x_end -= 8
    for y in range(y0 if y0 else 8, y_end, 8):
        for x in range(x0 - 8 if x0 else 0, x_end, 8):
            for sub in (0, 4):
                xx = x + sub
                if xx >= x_end2 or xx >= W:
                    continue
                bs = hbs[y >> 3, xx >> 2]
                if not bs:
                    continue
                qp = (int(qp4[(y - 1) >> 2, xx >> 2]) +
                      int(qp4[y >> 2, xx >> 2]) + 1) >> 1
                beta = int(BETA_TABLE[np.clip(qp + beta_off, 0, 51)]) \
                    << (bd - 8)
                tc = int(TC_TABLE[np.clip(qp + 2 * (bs - 1) + tc_off,
                                          0, 53)]) << (bd - 8)
                _luma_edge_seg(ypl, xx, y, False, beta, tc,
                               get_nf(xx >> 2, (y - 1) >> 2),
                               get_nf(xx >> 2, y >> 2), bd)
    # horizontal chroma
    if sps.chroma_format_idc:
        bdc = sps.bit_depth_chroma
        ch, cv = 1 << sps.hshift1, 1 << sps.vshift1
        if x_end2 != W:
            x_end = x_end2 - 8 * ch
        else:
            x_end = x_end2
        for c_idx in (1, 2):
            pl = planes[c_idx]
            off = fs.pps.cb_qp_offset if c_idx == 1 else fs.pps.cr_qp_offset
            for y in range(y0 if y0 else 8 * cv, y_end, 8 * cv):
                for x in range(x0 - 8 * ch if x0 else 0, x_end, 8 * ch):
                    for sub in (0, 4 * ch):
                        xx = x + sub
                        if xx >= W:
                            continue
                        bs = hbs[y >> 3, xx >> 2]
                        if bs != 2:
                            continue
                        qp_l = (int(qp4[(y - 1) >> 2, xx >> 2]) +
                                int(qp4[y >> 2, xx >> 2]) + 1) >> 1
                        qpc = chroma_qp(qp_l, off, sps.chroma_format_idc, 0)
                        tc = int(TC_TABLE[np.clip(qpc + 2 + tc_off,
                                                  0, 53)]) << (bdc - 8)
                        _chroma_edge_seg(pl, xx >> sps.hshift1,
                                         y >> sps.vshift1, False, tc,
                                         get_nf(xx >> 2, (y - 1) >> 2),
                                         get_nf(xx >> 2, y >> 2), bdc)


def _luma_edge_seg(pl, x, y, vertical, beta, tc, no_p, no_q, bd):
    """Filter one 4-line luma segment at edge (x,y)."""
    if tc == 0:
        return
    maxv = (1 << bd) - 1

    def P(i, line):  # p_i of given line
        if vertical:
            return int(pl[y + line, x - 1 - i])
        return int(pl[y - 1 - i, x + line])

    def Q(i, line):
        if vertical:
            return int(pl[y + line, x + i])
        return int(pl[y + i, x + line])

    def setP(i, line, v):
        if vertical:
            pl[y + line, x - 1 - i] = v
        else:
            pl[y - 1 - i, x + line] = v

    def setQ(i, line, v):
        if vertical:
            pl[y + line, x + i] = v
        else:
            pl[y + i, x + line] = v

    dp0 = abs(P(2, 0) - 2 * P(1, 0) + P(0, 0))
    dq0 = abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0))
    dp3 = abs(P(2, 3) - 2 * P(1, 3) + P(0, 3))
    dq3 = abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3))
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    if d0 + d3 >= beta:
        return
    strong = True
    for line, d in ((0, d0), (3, d3)):
        if not (2 * d < (beta >> 2) and
                abs(P(3, line) - P(0, line)) + abs(Q(0, line) - Q(3, line))
                < (beta >> 3) and
                abs(P(0, line) - Q(0, line)) < ((5 * tc + 1) >> 1)):
            strong = False
            break
    if strong:
        for line in range(4):
            p3, p2, p1, p0 = (P(3, line), P(2, line), P(1, line), P(0, line))
            q0, q1, q2, q3 = (Q(0, line), Q(1, line), Q(2, line), Q(3, line))
            if not no_p:
                setP(0, line, np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4)
                                      >> 3, p0 - 2 * tc, p0 + 2 * tc))
                setP(1, line, np.clip((p2 + p1 + p0 + q0 + 2) >> 2,
                                      p1 - 2 * tc, p1 + 2 * tc))
                setP(2, line, np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4)
                                      >> 3, p2 - 2 * tc, p2 + 2 * tc))
            if not no_q:
                setQ(0, line, np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4)
                                      >> 3, q0 - 2 * tc, q0 + 2 * tc))
                setQ(1, line, np.clip((p0 + q0 + q1 + q2 + 2) >> 2,
                                      q1 - 2 * tc, q1 + 2 * tc))
                setQ(2, line, np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4)
                                      >> 3, q2 - 2 * tc, q2 + 2 * tc))
    else:
        nd_p = dp0 + dp3 < ((beta + (beta >> 1)) >> 3)
        nd_q = dq0 + dq3 < ((beta + (beta >> 1)) >> 3)
        for line in range(4):
            p2, p1, p0 = P(2, line), P(1, line), P(0, line)
            q0, q1, q2 = Q(0, line), Q(1, line), Q(2, line)
            delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta0) >= 10 * tc:
                continue
            delta = int(np.clip(delta0, -tc, tc))
            if not no_p:
                setP(0, line, np.clip(p0 + delta, 0, maxv))
                if nd_p:
                    dp = int(np.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1,
                                     -(tc >> 1), tc >> 1))
                    setP(1, line, np.clip(p1 + dp, 0, maxv))
            if not no_q:
                setQ(0, line, np.clip(q0 - delta, 0, maxv))
                if nd_q:
                    dq = int(np.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1,
                                     -(tc >> 1), tc >> 1))
                    setQ(1, line, np.clip(q1 + dq, 0, maxv))


def _chroma_edge_seg(pl, cx, cy, vertical, tc, no_p, no_q, bd):
    if tc == 0:
        return
    maxv = (1 << bd) - 1
    for line in range(4):
        if vertical:
            p1, p0 = int(pl[cy + line, cx - 2]), int(pl[cy + line, cx - 1])
            q0, q1 = int(pl[cy + line, cx]), int(pl[cy + line, cx + 1])
        else:
            p1, p0 = int(pl[cy - 2, cx + line]), int(pl[cy - 1, cx + line])
            q0, q1 = int(pl[cy, cx + line]), int(pl[cy + 1, cx + line])
        delta = int(np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc))
        np0 = np.clip(p0 + delta, 0, maxv)
        nq0 = np.clip(q0 - delta, 0, maxv)
        if vertical:
            if not no_p:
                pl[cy + line, cx - 1] = np0
            if not no_q:
                pl[cy + line, cx] = nq0
        else:
            if not no_p:
                pl[cy - 1, cx + line] = np0
            if not no_q:
                pl[cy, cx + line] = nq0
