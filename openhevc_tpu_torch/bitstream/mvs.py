"""Motion vector prediction: spatial merge + AMVP candidate derivation.

Shared by the slice parser (decode side) and the inter test-stream encoder
(both must derive identical candidate lists). Behavior parity:
hevc_mvs.c (derive_spatial_merge_candidates :299, ff_hevc_luma_mv_merge_mode
:511, ff_hevc_luma_mv_mvp_mode :623) with TEST_MV_POC comparisons
(hevc.h:73) — candidates compare reference POCs, not ref indices.

Temporal MVP is not derived yet (sps_temporal_mvp_enabled unsupported).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

PF_INTRA, PF_L0, PF_L1, PF_BI = 0, 1, 2, 3

# combined bi-pred candidate order (l0_l1_cand_idx)
_COMB = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
         (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


@dataclass
class MvField:
    pred_flag: int = PF_INTRA
    mv: tuple = ((0, 0), (0, 0))
    ref_idx: tuple = (0, 0)
    poc: tuple = (0, 0)        # POC of the referenced picture per list

    def mv_of(self, lx):
        return self.mv[lx]


def _trunc_div(a, b):
    return int(math.trunc(a / b))


def clip_int8(v):
    return max(-128, min(127, v))


def clip_int16(v):
    return max(-32768, min(32767, v))


def mv_scale(mv, td, tb):
    """POC-distance MV scaling (8.5.3.2.8; hevc_mvs.c:128)."""
    td = clip_int8(td)
    tb = clip_int8(tb)
    tx = _trunc_div(0x4000 + abs(_trunc_div(td, 2)), td)
    sf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    x = clip_int16((sf * mv[0] + 127 + (1 if sf * mv[0] < 0 else 0)) >> 8)
    y = clip_int16((sf * mv[1] + 127 + (1 if sf * mv[1] < 0 else 0)) >> 8)
    return (x, y)


class MotionContext:
    """Per-frame motion state: the tab_mvf analogue as dense per-4x4 grids
    plus slice-level reference lists."""

    def __init__(self, sps, zscan, poc, slice_type, max_merge_cand,
                 ref_list, parallel_merge_log2=2):
        h4 = (sps.ctbs_h << sps.log2_ctb) >> 2
        w4 = (sps.ctbs_w << sps.log2_ctb) >> 2
        self.sps = sps
        self.zscan = zscan
        self.poc = poc
        self.slice_type = slice_type  # 0 B, 1 P, 2 I
        self.max_merge = max_merge_cand
        # ref_list[lx] = list of (poc, is_long_term)
        self.ref_list = ref_list
        self.plevel = parallel_merge_log2
        self.pred_flag = np.zeros((h4, w4), np.uint8)
        self.mv = np.zeros((h4, w4, 2, 2), np.int32)
        self.ref_idx = np.zeros((h4, w4, 2), np.int8)
        self.refpoc = np.zeros((h4, w4, 2), np.int32)

    # ---- grid maintenance -------------------------------------------------
    def set_pu(self, x0, y0, w, h, f: MvField):
        x4, y4 = x0 >> 2, y0 >> 2
        n4w, n4h = max(1, w >> 2), max(1, h >> 2)
        self.pred_flag[y4:y4 + n4h, x4:x4 + n4w] = f.pred_flag
        for lx in range(2):
            self.mv[y4:y4 + n4h, x4:x4 + n4w, lx, 0] = f.mv[lx][0]
            self.mv[y4:y4 + n4h, x4:x4 + n4w, lx, 1] = f.mv[lx][1]
            self.ref_idx[y4:y4 + n4h, x4:x4 + n4w, lx] = f.ref_idx[lx]
            self.refpoc[y4:y4 + n4h, x4:x4 + n4w, lx] = f.poc[lx]

    def set_intra(self, x0, y0, size):
        x4, y4 = x0 >> 2, y0 >> 2
        n4 = max(1, size >> 2)
        self.pred_flag[y4:y4 + n4, x4:x4 + n4] = PF_INTRA
        self.mv[y4:y4 + n4, x4:x4 + n4] = 0
        self.ref_idx[y4:y4 + n4, x4:x4 + n4] = 0
        self.refpoc[y4:y4 + n4, x4:x4 + n4] = 0

    def tab(self, x, y) -> MvField:
        """MvField at luma sample coords."""
        x4, y4 = x >> 2, y >> 2
        return MvField(
            pred_flag=int(self.pred_flag[y4, x4]),
            mv=((int(self.mv[y4, x4, 0, 0]), int(self.mv[y4, x4, 0, 1])),
                (int(self.mv[y4, x4, 1, 0]), int(self.mv[y4, x4, 1, 1]))),
            ref_idx=(int(self.ref_idx[y4, x4, 0]),
                     int(self.ref_idx[y4, x4, 1])),
            poc=(int(self.refpoc[y4, x4, 0]), int(self.refpoc[y4, x4, 1])))

    # ---- availability -----------------------------------------------------
    def _neighbour_flags(self, x0, y0, w, h):
        sps = self.sps
        ctb = 1 << sps.log2_ctb
        x0b = x0 & (ctb - 1)
        y0b = y0 & (ctb - 1)
        cand_up = bool(y0 > 0) if not y0b else True
        cand_left = bool(x0 > 0) if not x0b else True
        if y0 == 0:
            cand_up = False
        if x0 == 0:
            cand_left = False
        if not x0b and not y0b:
            cand_up_left = x0 > 0 and y0 > 0
        else:
            cand_up_left = cand_left and cand_up
        if (x0b + w) == ctb:
            cand_up_right_sap = (y0 > 0) and not y0b
        else:
            cand_up_right_sap = cand_up
        cand_bottom_left = 0 if (y0 + h) >= sps.height else cand_left
        return (cand_left, cand_up, cand_up_left, cand_up_right_sap,
                cand_bottom_left)

    def _zscan_avail(self, x_cur, y_cur, xn, yn):
        """6.4.1 z-scan availability (z_scan_block_avail behavior)."""
        sps = self.sps
        if (yn >> sps.log2_ctb) < (y_cur >> sps.log2_ctb) or \
           (xn >> sps.log2_ctb) < (x_cur >> sps.log2_ctb):
            return True
        return self.zscan[yn >> 2, xn >> 2] <= self.zscan[y_cur >> 2,
                                                          x_cur >> 2]

    region4 = None       # per-4x4 slice/tile region ids (multi-slice)
    _cur_reg = 0

    def set_region4(self, region4):
        """Per-4x4 region map (slice_no x tile) gating neighbour PU
        availability (6.4.1: candidates in another slice segment/tile
        are unavailable; reference gates via ctb_*_flag in
        hls_decode_neighbour, hevc.c:2592)."""
        self.region4 = region4

    def _enter_pu(self, x0, y0):
        if self.region4 is not None:
            self._cur_reg = int(self.region4[y0 >> 2, x0 >> 2])

    def _avail_pu(self, cand_flag, x, y):
        if not cand_flag:
            return False
        if self.region4 is not None:
            h4, w4 = self.region4.shape
            if self.region4[min(y >> 2, h4 - 1),
                            min(x >> 2, w4 - 1)] != self._cur_reg:
                return False
        return self.tab(x, y).pred_flag != PF_INTRA

    def _diff_mer(self, xn, yn, xp, yp):
        p = self.plevel
        return (xn >> p) == (xp >> p) and (yn >> p) == (yp >> p)

    # ---- merge ------------------------------------------------------------
    # ---- TMVP (8.5.3.1.7/8; temporal_luma_motion_vector,
    # hevc_mvs.c:227, derive_temporal_colocated_mvs :172) --------------
    col = None                   # (col_poc, pred_flag4, mv4, refpoc4)
    colloc_from_l0 = 1           # sh collocated_from_l0 flag
    col_lt_map: dict = {}
    temporal_mvp = False

    def set_col_motion(self, col_poc, pred_flag, mv, refpoc,
                       colloc_from_l0=1, lt_map=None):
        """lt_map: {poc: is_long_term} of the collocated picture's
        reference lists (the refPicList saved per HEVCFrame that
        derive_temporal_colocated_mvs consults for colIsLt)."""
        self.col = (col_poc, pred_flag, mv, refpoc)
        self.colloc_from_l0 = colloc_from_l0
        self.col_lt_map = lt_map or {}
        self.temporal_mvp = True

    def _derive_col_mv(self, pf, mvs2, rps2, ref_idx, X, col_poc):
        """derive_temporal_colocated_mvs: pick the col list, then copy or
        POC-scale (no long-term refs yet -> lt flags all false)."""
        if not (pf & 1):
            l = 1
        elif pf == 1:
            l = 0
        else:                     # BI
            has_future = any(p > self.poc for lst in self.ref_list
                             for (p, _lt) in lst)
            if not has_future:
                l = X
            else:
                # collocated from L1 -> use col's L0 MVs and vice versa
                l = 0 if self.colloc_from_l0 == 0 else 1
        cur_ref_poc, cur_lt = self.ref_list[X][ref_idx]
        col_ref_poc = int(rps2[l])
        col_lt = bool(self.col_lt_map.get(col_ref_poc, False))
        if col_lt != bool(cur_lt):
            return None              # 8.5.3.2.8: LT/ST mismatch -> unavail
        mv_col = (int(mvs2[l, 0]), int(mvs2[l, 1]))
        if cur_lt:
            return mv_col            # long-term: never scaled
        col_poc_diff = col_poc - col_ref_poc
        cur_poc_diff = self.poc - cur_ref_poc
        if col_poc_diff == cur_poc_diff or col_poc_diff == 0:
            return mv_col
        return mv_scale(mv_col, col_poc_diff, cur_poc_diff)

    def temporal_mv(self, x0, y0, w, h, ref_idx, X):
        """-> (available, mv): bottom-right candidate (same CTB row,
        in-picture), else the center candidate; positions 16-aligned."""
        if self.col is None:
            return 0, (0, 0)
        col_poc, cpf, cmv, crp = self.col
        ctb = self.sps.log2_ctb
        cands = []
        xbr, ybr = x0 + w, y0 + h
        if (y0 >> ctb) == (ybr >> ctb) and ybr < self.sps.height and \
                xbr < self.sps.width:
            cands.append((xbr, ybr))
        cands.append((x0 + (w >> 1), y0 + (h >> 1)))
        for (x, y) in cands:
            x = (x >> 4) << 4
            y = (y >> 4) << 4
            px, py = x >> 2, y >> 2
            pf = int(cpf[py, px])
            if pf == 0:
                continue
            mv = self._derive_col_mv(pf, cmv[py, px], crp[py, px],
                                     ref_idx, X, col_poc)
            if mv is None:
                continue
            return 1, mv
        return 0, (0, 0)

    def merge_mode(self, x0, y0, w, h, log2_cb, part_mode, part_idx,
                   merge_idx, cu_x, cu_y) -> MvField:
        """ff_hevc_luma_mv_merge_mode behavior (incl. 8x4/4x8 bi->L0)."""
        self._enter_pu(x0, y0)
        w2, h2 = w, h
        single_mcl = False
        if self.plevel > 2 and (1 << log2_cb) == 8:
            single_mcl = True
            x0, y0 = cu_x, cu_y
            w = h = 1 << log2_cb
            part_idx = 0
        cand = self._spatial_merge(x0, y0, w, h, part_mode, part_idx,
                                   single_mcl, merge_idx)
        if cand.pred_flag == PF_BI and (w2 + h2) == 12:
            cand = MvField(PF_L0, cand.mv, cand.ref_idx, cand.poc)
        return cand

    def _spatial_merge(self, x0, y0, w, h, part_mode, part_idx, single_mcl,
                       merge_idx) -> MvField:
        (cand_left, cand_up, cand_up_left, cand_up_right,
         cand_bottom_left) = self._neighbour_flags(x0, y0, w, h)
        xa1, ya1 = x0 - 1, y0 + h - 1
        xb1, yb1 = x0 + w - 1, y0 - 1
        xb0, yb0 = x0 + w, y0 - 1
        xa0, ya0 = x0 - 1, y0 + h
        xb2, yb2 = x0 - 1, y0 - 1
        nb_refs = (len(self.ref_list[0]) if self.slice_type == 1 else
                   min(len(self.ref_list[0]), len(self.ref_list[1])))
        lst = []

        def tabf(x, y):
            return self.tab(x, y)

        def same(a: MvField, b: MvField):
            if a.pred_flag != b.pred_flag:
                return False
            if a.pred_flag == PF_BI:
                return a.poc == b.poc and a.mv == b.mv
            lx = 0 if a.pred_flag == PF_L0 else 1
            return a.poc[lx] == b.poc[lx] and a.mv[lx] == b.mv[lx]

        # A1
        av_a1 = False
        if not ((not single_mcl and part_idx == 1 and
                 part_mode in (2, 6, 7)) or
                self._diff_mer(xa1, ya1, x0, y0)):
            av_a1 = self._avail_pu(cand_left, xa1, ya1)
            if av_a1:
                lst.append(tabf(xa1, ya1))
                if merge_idx == 0:
                    return lst[0]
        # B1
        av_b1 = False
        if not ((not single_mcl and part_idx == 1 and
                 part_mode in (1, 4, 5)) or
                self._diff_mer(xb1, yb1, x0, y0)):
            av_b1 = self._avail_pu(cand_up, xb1, yb1)
            if av_b1 and not (av_a1 and same(tabf(xb1, yb1),
                                             tabf(xa1, ya1))):
                lst.append(tabf(xb1, yb1))
                if merge_idx == len(lst) - 1:
                    return lst[-1]
        # B0
        av_b0 = (xb0 < self.sps.width and
                 self._avail_pu(cand_up_right, xb0, yb0) and
                 self._zscan_avail(x0, y0, xb0, yb0) and
                 not self._diff_mer(xb0, yb0, x0, y0))
        if av_b0 and not (av_b1 and same(tabf(xb0, yb0), tabf(xb1, yb1))):
            lst.append(tabf(xb0, yb0))
            if merge_idx == len(lst) - 1:
                return lst[-1]
        # A0
        av_a0 = (ya0 < self.sps.height and
                 self._avail_pu(cand_bottom_left, xa0, ya0) and
                 self._zscan_avail(x0, y0, xa0, ya0) and
                 not self._diff_mer(xa0, ya0, x0, y0))
        if av_a0 and not (av_a1 and same(tabf(xa0, ya0), tabf(xa1, ya1))):
            lst.append(tabf(xa0, ya0))
            if merge_idx == len(lst) - 1:
                return lst[-1]
        # B2
        av_b2 = (self._avail_pu(cand_up_left, xb2, yb2) and
                 not self._diff_mer(xb2, yb2, x0, y0))
        if av_b2 and len(lst) != 4 and \
                not (av_a1 and same(tabf(xb2, yb2), tabf(xa1, ya1))) and \
                not (av_b1 and same(tabf(xb2, yb2), tabf(xb1, yb1))):
            lst.append(tabf(xb2, yb2))
            if merge_idx == len(lst) - 1:
                return lst[-1]
        # temporal merge candidate (hevc_mvs.c:418-447)
        if self.temporal_mvp and len(lst) < self.max_merge:
            av_l0, mv_l0 = self.temporal_mv(x0, y0, w, h, 0, 0)
            av_l1, mv_l1 = (self.temporal_mv(x0, y0, w, h, 0, 1)
                            if self.slice_type == 0 else (0, (0, 0)))
            if av_l0 or av_l1:
                poc0 = self.ref_list[0][0][0] if av_l0 else 0
                poc1 = self.ref_list[1][0][0] if av_l1 else 0
                lst.append(MvField(av_l0 + (av_l1 << 1),
                                   (tuple(mv_l0), tuple(mv_l1)),
                                   (0, 0), (poc0, poc1)))
                if merge_idx == len(lst) - 1:
                    return lst[-1]
        n_orig = len(lst)
        # combined bi-predictive candidates (B slices)
        if self.slice_type == 0 and n_orig > 1 and n_orig < self.max_merge:
            for (i0, i1) in _COMB[:n_orig * (n_orig - 1)]:
                if len(lst) >= self.max_merge:
                    break
                c0, c1 = lst[i0], lst[i1]
                if (c0.pred_flag & PF_L0) and (c1.pred_flag & PF_L1) and \
                        (c0.poc[0] != c1.poc[1] or c0.mv[0] != c1.mv[1]):
                    lst.append(MvField(PF_BI, (c0.mv[0], c1.mv[1]),
                                       (c0.ref_idx[0], c1.ref_idx[1]),
                                       (c0.poc[0], c1.poc[1])))
                    if merge_idx == len(lst) - 1:
                        return lst[-1]
        # zero candidates
        zero_idx = 0
        while len(lst) < self.max_merge:
            ri = zero_idx if zero_idx < nb_refs else 0
            pf = PF_L0 + (2 if self.slice_type == 0 else 0)
            poc0 = self.ref_list[0][ri][0] if self.ref_list[0] else 0
            poc1 = (self.ref_list[1][ri][0]
                    if self.slice_type == 0 and self.ref_list[1] else 0)
            lst.append(MvField(pf, ((0, 0), (0, 0)), (ri, ri), (poc0, poc1)))
            if merge_idx == len(lst) - 1:
                return lst[-1]
            zero_idx += 1
        return lst[min(merge_idx, len(lst) - 1)]

    # ---- AMVP -------------------------------------------------------------
    def amvp(self, x0, y0, w, h, lx, ref_idx, mvp_flag) -> tuple:
        """ff_hevc_luma_mv_mvp_mode behavior. Returns the predictor MV."""
        self._enter_pu(x0, y0)
        (cand_left, cand_up, cand_up_left, cand_up_right,
         cand_bottom_left) = self._neighbour_flags(x0, y0, w, h)
        cur_ref_poc, cur_ref_lt = self.ref_list[lx][ref_idx]
        pf_l0, pf_l1 = lx, 1 - lx

        def mp_mx(x, y, pli):
            f = self.tab(x, y)
            if (f.pred_flag & (1 << pli)) and f.poc[pli] == cur_ref_poc:
                return f.mv[pli]
            return None

        def mp_mx_lt(x, y, pli):
            f = self.tab(x, y)
            if f.pred_flag & (1 << pli):
                col_lt = self._is_lt_poc(pli, f)
                if col_lt == cur_ref_lt:
                    mv = f.mv[pli]
                    if not cur_ref_lt:
                        # dist_scale
                        elist_poc = f.poc[pli]
                        if elist_poc != cur_ref_poc:
                            td = self.poc - elist_poc
                            if td == 0:
                                td = 1
                            mv = mv_scale(mv, td, self.poc - cur_ref_poc)
                    return mv
            return None

        xa0, ya0 = x0 - 1, y0 + h
        xa1, ya1 = x0 - 1, y0 + h - 1
        av_a0 = (ya0 < self.sps.height and
                 self._avail_pu(cand_bottom_left, xa0, ya0) and
                 self._zscan_avail(x0, y0, xa0, ya0))
        av_a1 = self._avail_pu(cand_left, xa1, ya1)
        is_scaled = av_a0 or av_a1
        mxa = None
        for (av, x, y) in ((av_a0, xa0, ya0), (av_a1, xa1, ya1)):
            if av and mxa is None:
                mxa = mp_mx(x, y, pf_l0) or mp_mx(x, y, pf_l1)
        if mxa is None:
            for (av, x, y) in ((av_a0, xa0, ya0), (av_a1, xa1, ya1)):
                if av and mxa is None:
                    mxa = mp_mx_lt(x, y, pf_l0) or mp_mx_lt(x, y, pf_l1)
        av_lxa = mxa is not None
        if av_lxa and mvp_flag == 0:
            return mxa
        # B candidates
        xb0, yb0 = x0 + w, y0 - 1
        xb1, yb1 = x0 + w - 1, y0 - 1
        xb2, yb2 = x0 - 1, y0 - 1
        av_b0 = (xb0 < self.sps.width and
                 self._avail_pu(cand_up_right, xb0, yb0) and
                 self._zscan_avail(x0, y0, xb0, yb0))
        av_b1 = self._avail_pu(cand_up, xb1, yb1)
        av_b2 = self._avail_pu(cand_up_left, xb2, yb2)
        mxb = None
        for (av, x, y) in ((av_b0, xb0, yb0), (av_b1, xb1, yb1),
                           (av_b2, xb2, yb2)):
            if av and mxb is None:
                mxb = mp_mx(x, y, pf_l0) or mp_mx(x, y, pf_l1)
        av_lxb = mxb is not None
        if not is_scaled:
            if av_lxb:
                av_lxa, mxa = True, mxb
            av_lxb = False
            mxb = None
            for (av, x, y) in ((av_b0, xb0, yb0), (av_b1, xb1, yb1),
                               (av_b2, xb2, yb2)):
                if av and mxb is None:
                    mxb = mp_mx_lt(x, y, pf_l0) or mp_mx_lt(x, y, pf_l1)
            av_lxb = mxb is not None
        cands = []
        if av_lxa:
            cands.append(mxa)
        if av_lxb and (not av_lxa or mxa != mxb):
            cands.append(mxb)
        # temporal AMVP candidate (hevc_mvs.c:807-815)
        if len(cands) < 2 and self.temporal_mvp:
            av_col, mv_col = self.temporal_mv(x0, y0, w, h, ref_idx, lx)
            if av_col:
                cands.append(tuple(mv_col))
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[mvp_flag]

    def _is_lt_poc(self, lx, f: MvField):
        """Long-term flag of the picture f references in list lx (POC
        lookup against the slice ref list)."""
        for (poc, lt) in self.ref_list[lx]:
            if poc == f.poc[lx]:
                return lt
        return False
