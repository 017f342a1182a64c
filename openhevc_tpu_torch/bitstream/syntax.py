"""Slice-data syntax layer: CTB scan, CU quadtree, intra PU modes, transform
tree, residual coding, PCM — emitting FrameSymbols.

Python reference implementation of the host parse core (the C++ native core
mirrors this). Parity targets: hls_decode_entry/hls_coding_quadtree/
hls_coding_unit/hls_transform_tree (hevc.c:2644,2508,2347,1443) and
ff_hevc_hls_residual_coding (hevc_cabac.c:1372) — re-expressed, not
translated: this parser performs *no* reconstruction; it resolves syntax
into dense grids and device-ready job lists.
"""
from __future__ import annotations

import numpy as np

from ..symbols import FrameSymbols, CoeffBlock, IntraJob, PcmBlock, InterPb


def _wrap16(v: int) -> int:
    """MV component wraparound (8.5.3.2.9)."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v
from .bits import BitReader
from .cabac import CabacDecoder
from .ctx_tables import CTX_OFFSET, init_states
from .ps import SPS, PPS
from .slice import SliceHeader, I_SLICE, P_SLICE, B_SLICE

MODE_INTER, MODE_INTRA, MODE_SKIP = 0, 1, 2
PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN = 0, 1, 2, 3
PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N = 4, 5, 6, 7
SCAN_DIAG, SCAN_HORIZ, SCAN_VERT = 0, 1, 2


# ---------------------------------------------------------------------------
# Scan order tables (6.5.3)
# ---------------------------------------------------------------------------

def _diag_scan(n: int):
    """Up-right diagonal scan: list of (x, y) in scan order."""
    out = []
    x = y = 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return out


def _horiz_scan(n: int):
    return [(x, y) for y in range(n) for x in range(n)]


def _vert_scan(n: int):
    return [(x, y) for x in range(n) for y in range(n)]


_SCANS_4 = {SCAN_DIAG: _diag_scan(4), SCAN_HORIZ: _horiz_scan(4),
            SCAN_VERT: _vert_scan(4)}
_CG_SCANS = {}
for _n in (1, 2, 4, 8):
    _CG_SCANS[(SCAN_DIAG, _n)] = _diag_scan(_n)
    _CG_SCANS[(SCAN_HORIZ, _n)] = _horiz_scan(_n)
    _CG_SCANS[(SCAN_VERT, _n)] = _vert_scan(_n)

# inverse maps: (x, y) -> scan index
_SCANS_4_INV = {k: {xy: i for i, xy in enumerate(v)}
                for k, v in _SCANS_4.items()}
_CG_SCANS_INV = {k: {xy: i for i, xy in enumerate(v)}
                 for k, v in _CG_SCANS.items()}

# sig_coeff_flag ctxIdxMap (9.3.4.2.5); row 0: 4x4 TBs, rows 1-3: by
# prevCsbf, row 4: prevCsbf==3
SIG_CTX_MAP = (
    (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8),
    (1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0),
    (2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0),
    (2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2),
)

CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def chroma_qp(qp_y: int, offset: int, chroma_array_type: int,
              qp_bd_offset: int) -> int:
    """Chroma QP mapping (8.7.1; behavior of hevc_cabac.c:1427-1480)."""
    qp_i = max(-qp_bd_offset, min(57, qp_y + offset))
    if chroma_array_type == 1:
        if qp_i < 30:
            q = qp_i
        elif qp_i > 43:
            q = qp_i - 6
        else:
            q = CHROMA_QP_TABLE[qp_i - 30]
    else:
        q = min(qp_i, 51)
    return q


_ZSCAN_CACHE: dict = {}


def zscan_grid(sps: SPS, rs_to_ts=None) -> np.ndarray:
    """z-scan order index per 4x4 block [H4, W4] (decode-order comparisons;
    same role as the reference's min_tb_addr_zs map, hevc_ps.c PPS deriv).
    With tiles, CTBs are ranked by tile-scan order (rs_to_ts).
    Geometry-static per (SPS, tile map): cached (it was ~7 ms/frame)."""
    key = (sps.log2_ctb, sps.ctbs_w, sps.ctbs_h,
           None if rs_to_ts is None else bytes(np.asarray(rs_to_ts).data))
    hit = _ZSCAN_CACHE.get(key)
    if hit is not None:
        return hit
    _ZSCAN_CACHE[key] = out = _zscan_grid(sps, rs_to_ts)
    return out


def _zscan_grid(sps: SPS, rs_to_ts=None) -> np.ndarray:
    w4 = (sps.ctbs_w << sps.log2_ctb) >> 2
    h4 = (sps.ctbs_h << sps.log2_ctb) >> 2
    ys, xs = np.mgrid[0:h4, 0:w4]
    n4 = 1 << (sps.log2_ctb - 2)      # 4x4 blocks per CTB side
    ctb_idx = (ys // n4) * sps.ctbs_w + (xs // n4)
    if rs_to_ts is not None:
        ctb_idx = np.asarray(rs_to_ts)[ctb_idx]
    lx = xs % n4
    ly = ys % n4
    morton = np.zeros_like(lx)
    for b in range(sps.log2_ctb - 2):
        morton |= ((lx >> b) & 1) << (2 * b)
        morton |= ((ly >> b) & 1) << (2 * b + 1)
    return ctb_idx * (n4 * n4) + morton


def avail_mask(zscan: np.ndarray, pred_mode: np.ndarray, constrained: bool,
               x: int, y: int, size: int, hs: int, vs: int,
               W: int, H: int, tile4: np.ndarray | None = None) -> np.ndarray:
    """Reference-sample availability for a TB at plane coords (x, y) with
    chroma subsampling shifts (hs, vs). Layout matches ops/intra_np.py.
    Availability = in-picture AND earlier in z-scan decode order AND (if
    constrained intra) intra-coded. (Role of ff_hevc_set_neighbour_available
    + z-scan checks, hevc_mvs.c:41/:63.)"""
    lx0, ly0 = x << hs, y << vs
    zc = zscan[ly0 >> 2, lx0 >> 2]
    tid = tile4[ly0 >> 2, lx0 >> 2] if tile4 is not None else 0
    n = 4 * size + 1
    avail = np.zeros(n, bool)

    def ok(lx, ly):
        if lx < 0 or ly < 0 or lx >= W or ly >= H:
            return False
        if zscan[ly >> 2, lx >> 2] >= zc:
            return False
        if tile4 is not None and tile4[ly >> 2, lx >> 2] != tid:
            return False
        if constrained and pred_mode[ly >> 2, lx >> 2] != MODE_INTRA:
            return False
        return True

    for i in range(2 * size):
        avail[i] = ok((x - 1) << hs, (y + 2 * size - 1 - i) << vs)
    avail[2 * size] = ok((x - 1) << hs, (y - 1) << vs)
    for j in range(2 * size):
        avail[2 * size + 1 + j] = ok((x + j) << hs, (y - 1) << vs)
    return avail


PRED_L0, PRED_L1, PRED_BI = 0, 1, 2

# 4:2:2 chroma intra mode mapping (8.4.4.2.3 Table 8-3; hevc.c:2252)
TAB_MODE_IDX_422 = (
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31)


class SliceDataParser:
    def __init__(self, rbsp: bytes, sps: SPS, pps: PPS, sh: SliceHeader,
                 nal_type: int, poc: int, ref_list=None, col_motion=None,
                 start_ts: int = 0, shared: dict | None = None,
                 dep_ctx=None, slice_no: int = 0):
        """One slice segment. For pictures with multiple slice segments,
        `shared` carries the picture-wide state (frame symbols, motion
        grids, region maps) from the previous segment's parser, start_ts
        is the segment address in tile-scan CTBs, slice_no identifies the
        independent slice (dependent segments keep their parent's), and
        dep_ctx is the CABAC context table saved at the end of the
        previous segment (dependent slice segments resume it,
        ff_hevc_cabac_init hevc_cabac.c:606)."""
        self.sps, self.pps, self.sh = sps, pps, sh
        # initType (9.3.2.2): I->0, P->1, B->2; cabac_init_flag swaps P/B
        init_type = (0 if sh.slice_type == I_SLICE else
                     (1 if sh.slice_type == P_SLICE else 2))
        if pps.cabac_init_present and sh.cabac_init_flag and \
                sh.slice_type != I_SLICE:
            init_type = 3 - init_type  # swap 1<->2
        if dep_ctx is not None:
            ctx0, stat0 = dep_ctx        # dependent segment resumes state
            self.ctx = list(ctx0)
            self.stat_coeff = list(stat0)
        else:
            self.ctx = init_states(init_type, max(0, min(51, sh.qp)))
            self.stat_coeff = [0, 0, 0, 0]
        self.rbsp = rbsp
        self.cab = CabacDecoder(rbsp, sh.data_start_byte * 8)
        self.init_type = init_type
        self.start_ts = start_ts
        self.slice_no = slice_no
        self.end_ts = None               # set by decode()
        self.final_ctx = None
        w4 = (sps.ctbs_w << sps.log2_ctb) >> 2
        h4 = (sps.ctbs_h << sps.log2_ctb) >> 2
        self.w4, self.h4 = w4, h4
        self.tiles = bool(pps.tiles_enabled)
        self.wpp = bool(pps.entropy_coding_sync)
        if self.tiles:
            from .ps import ctb_tile_maps
            rs_to_ts, ts_order, tile_id, col_bd, row_bd = \
                ctb_tile_maps(pps, sps)
            self.ts_order = ts_order
            self.tile_id = tile_id
            self.col_bd, self.row_bd = col_bd, row_bd
            n4c = 1 << (sps.log2_ctb - 2)
            self.tile4 = np.repeat(np.repeat(tile_id, n4c, 0), n4c, 1)
            self.zscan = zscan_grid(sps, rs_to_ts)
        else:
            self.ts_order = np.arange(sps.ctbs_w * sps.ctbs_h)
            self.tile_id = np.zeros((sps.ctbs_h, sps.ctbs_w), np.int32)
            self.col_bd = np.array([0, sps.ctbs_w])
            self.row_bd = np.array([0, sps.ctbs_h])
            self.tile4 = None
            self.zscan = zscan_grid(sps)
        if shared is not None:
            # continue the picture started by an earlier slice segment
            if self.tiles or self.wpp:
                raise ValueError(
                    "multi-slice pictures with tiles/WPP not supported")
            fs = shared["fs"]
            self.fs = fs
            self.ct_depth = shared["ct_depth"]
            self.skip_grid = shared["skip_grid"]
            self.region4 = shared["region4"]
            self.region_ctb = shared["region_ctb"]
            self.n_regions = shared["n_regions"]
            self.ctb_order = shared["ctb_order"]
            self.tile4 = self.region4
            self.mc = fs.motion
            self.mc.set_region4(self.region4)
            self.ref_list = self.mc.ref_list
            self.shared = shared
        else:
            fs = FrameSymbols(sps=sps, pps=pps, poc=poc,
                              slice_type=sh.slice_type, slice_qp=sh.qp,
                              nal_type=nal_type)
            fs.ipm = np.full((h4, w4), 255, np.uint8)
            fs.pred_mode = np.full((h4, w4), MODE_INTRA, np.uint8)
            fs.is_pcm = np.zeros((h4, w4), np.uint8)
            fs.tqb = np.zeros((h4, w4), np.uint8)
            fs.cbf_luma4 = np.zeros((h4, w4), np.uint8)
            fs.bounds_v = np.zeros((h4, w4), np.uint8)
            fs.bounds_h = np.zeros((h4, w4), np.uint8)
            fs.qp_y4 = np.full((h4, w4), sh.qp, np.int8)
            fs.sao = np.zeros((sps.ctbs_h, sps.ctbs_w, 3, 6), np.int16)
            fs.mvf = np.zeros((h4 // 2, w4 // 2, 2, 4), np.int32)
            fs.weights = sh.weighted_pred_table
            fs.deblock_disabled = bool(sh.deblocking_filter_disabled)
            fs.beta_offset = sh.beta_offset
            fs.tc_offset = sh.tc_offset
            fs.sao_luma = bool(sh.sao_luma)
            fs.sao_chroma = bool(sh.sao_chroma)
            self.fs = fs
            self.ct_depth = np.zeros((h4, w4), np.int8)
            self.skip_grid = np.zeros((h4, w4), np.uint8)
            # region map: slice_no x tile id per 4x4 / per CTB — the
            # 6.4.1 in-picture-prediction gate (neighbours in another
            # slice segment or tile are unavailable)
            self.n_regions = int(self.tile_id.max()) + 1
            self.region_ctb = self.tile_id.astype(np.int32).copy()
            n4c = 1 << (sps.log2_ctb - 2)
            self.region4 = np.repeat(np.repeat(self.region_ctb, n4c, 0),
                                     n4c, 1)[:h4, :w4].copy()
            self.tile4 = self.region4 if self.tiles else None
            self.ctb_order = []
            from .mvs import MotionContext
            self.ref_list = ref_list or [[], []]
            fs.ref_poc_l0 = [p for p, _ in self.ref_list[0]]
            fs.ref_poc_l1 = [p for p, _ in self.ref_list[1]]
            self.mc = MotionContext(
                sps, self.zscan, poc, sh.slice_type, sh.max_num_merge_cand,
                self.ref_list, pps.log2_parallel_merge_level)
            if col_motion is not None and sh.temporal_mvp:
                # (col_poc, pred_flag4, mv4, refpoc4[, lt_map]) of the
                # collocated picture
                self.mc.set_col_motion(*col_motion[:4],
                                       colloc_from_l0=sh.collocated_list,
                                       lt_map=(col_motion[4] if
                                               len(col_motion) > 4
                                               else None))
            fs.motion = self.mc
            self.shared = dict(fs=fs, ct_depth=self.ct_depth,
                               skip_grid=self.skip_grid,
                               region4=self.region4,
                               region_ctb=self.region_ctb,
                               n_regions=self.n_regions,
                               ctb_order=self.ctb_order)
        # per-CU state
        self.cu_qp = sh.qp
        self.cu_tqb = 0
        # cu_qp_delta state (lc->qp_y / qPy_pred / first_qp_group,
        # hevc.c:1085,2489-2500; get_qPy_pred hevc_filter.c:91)
        self.qp_y = sh.qp
        self.qPy_pred = sh.qp
        self.first_qp_group = dep_ctx is None      # !dependent
        self.is_qp_coded = 0
        # cu_chroma_qp_offset state (lc->tu.cu_qp_offset_cb/cr,
        # hevc.c:1091-1092, reset per slice; coded-flag resets per
        # chroma QG, hevc.c:2531-2534)
        self.is_cqo_coded = 0
        self.cu_qp_offset_cb = 0
        self.cu_qp_offset_cr = 0
        self.qg_delta = 0
        self.qg_mask = 0
        if pps.cu_qp_delta_enabled:
            self.qg_mask = (1 << (sps.log2_ctb -
                                  pps.diff_cu_qp_delta_depth)) - 1
        if shared is not None and dep_ctx is not None and \
                "qp_state" in shared:
            self.qp_y, self.qPy_pred = shared["qp_state"]
            self.cu_qp = self.qp_y
        self.cu_pred_mode = MODE_INTRA
        self.cu_part_mode = PART_2Nx2N
        self.pu_intra_modes = [1, 1, 1, 1]
        self.intra_mode_c = 1
        self.pu_chroma_modes = [1, 1, 1, 1]

    def _same_tile4(self, xa4, ya4, xb4, yb4):
        if self.tile4 is None:
            return True
        return self.tile4[ya4, xa4] == self.tile4[yb4, xb4]

    # -- CABAC shorthands ---------------------------------------------------
    def bin(self, elem: str, inc: int = 0) -> int:
        return self.cab.decode_bin(self.ctx, CTX_OFFSET[elem] + inc)

    def bypass(self) -> int:
        return self.cab.decode_bypass()

    def bypass_bits(self, n: int) -> int:
        return self.cab.decode_bypass_bits(n)

    def terminate(self) -> int:
        return self.cab.decode_terminate()

    def _tile_width_of(self, rs):
        rx = rs % self.sps.ctbs_w
        c = int(np.searchsorted(self.col_bd, rx, side="right")) - 1
        return int(self.col_bd[c + 1] - self.col_bd[c])

    # -- top level ----------------------------------------------------------
    def decode(self) -> FrameSymbols:
        sps = self.sps
        cs = 1 << sps.log2_ctb
        n4c = cs >> 2
        n_ctb = sps.ctbs_w * sps.ctbs_h
        ctb_tile_rs = 0
        saved_ctx = None
        ctb_order = self.ctb_order
        h4, w4 = self.region4.shape
        for ts in range(self.start_ts, n_ctb):
            rs = int(self.ts_order[ts])
            x0 = (rs % sps.ctbs_w) * cs
            y0 = (rs // sps.ctbs_w) * cs
            ctb_order.append((x0, y0))
            # paint this CTB's region (slice_no x tile) before any
            # neighbour-availability query can touch it
            if self.slice_no:
                ry, rx = rs // sps.ctbs_w, rs % sps.ctbs_w
                reg = self.slice_no * self.n_regions + \
                    int(self.tile_id[ry, rx])
                self.region_ctb[ry, rx] = reg
                self.region4[ry * n4c:min((ry + 1) * n4c, h4),
                             rx * n4c:min((rx + 1) * n4c, w4)] = reg
            tw = self._tile_width_of(rs)
            if ts > self.start_ts:
                prev_rs = int(self.ts_order[ts - 1])
                new_tile = self.tiles and \
                    self.tile_id.flat[rs] != self.tile_id.flat[prev_rs]
                if new_tile:
                    ctb_tile_rs = 0
                    # end_of_subset_one_bit consumed implicitly (terminate-1
                    # bins consume no bits); byte-align and reset contexts
                    self.cab.reinit(self.cab.consumed_bytes() * 8)
                    self.ctx = init_states(self.init_type,
                                           max(0, min(51, self.sh.qp)))
                    self.stat_coeff = [0, 0, 0, 0]
                    self.first_qp_group = True
                if self.wpp and ctb_tile_rs % tw == 0 and not new_tile:
                    self.first_qp_group = True
                    end = self.terminate()   # end_of_subset_one_bit
                    if end != 1:
                        raise ValueError("missing end_of_subset")
                    self.cab.reinit(self.cab.consumed_bytes() * 8)
                    if tw == 1:
                        self.ctx = init_states(self.init_type,
                                               max(0, min(51, self.sh.qp)))
                        self.stat_coeff = [0, 0, 0, 0]
                    else:
                        # load_states copies the CABAC contexts ONLY:
                        # StatCoeff carries over serially across WPP
                        # rows (hevc_cabac.c:562, never restored from
                        # the row snapshot)
                        self.ctx = list(saved_ctx[0])
            if sps.sao_enabled and (self.sh.sao_luma or self.sh.sao_chroma):
                self._sao_params(x0, y0)
            self._coding_quadtree(x0, y0, sps.log2_ctb, 0)
            ctb_tile_rs += 1
            if self.wpp and (ctb_tile_rs % tw == 2 or
                             (tw == 2 and ctb_tile_rs % tw == 0)):
                saved_ctx = (list(self.ctx), list(self.stat_coeff))
            end = self.terminate()
            if end:
                # end_of_slice_segment_flag: this segment is done; the
                # picture continues with the next VCL NAL (decoder
                # accumulates segments until all CTBs are covered)
                self.end_ts = ts + 1
                break
            if ts == n_ctb - 1:
                raise ValueError("missing end_of_slice")
        else:
            self.end_ts = n_ctb
        self.final_ctx = (list(self.ctx), list(self.stat_coeff))
        self.shared["qp_state"] = (self.qp_y, self.qPy_pred)
        self.fs.ctb_order = ctb_order
        return self.fs

    # -- SAO ----------------------------------------------------------------
    def _sao_params(self, x0: int, y0: int):
        sps, sh, fs = self.sps, self.sh, self.fs
        rx, ry = x0 >> sps.log2_ctb, y0 >> sps.log2_ctb
        # merge candidates must be in the same slice segment AND tile
        # (sao_merge_left/up availability, 7.3.8.3)
        if x0 > 0 and self.region_ctb[ry, rx] == self.region_ctb[ry, rx - 1]:
            if self.bin("sao_merge_flag"):
                fs.sao[ry, rx] = fs.sao[ry, rx - 1]
                return
        if y0 > 0 and self.region_ctb[ry, rx] == self.region_ctb[ry - 1, rx]:
            if self.bin("sao_merge_flag"):
                fs.sao[ry, rx] = fs.sao[ry - 1, rx]
                return
        shift = sps.bit_depth - min(sps.bit_depth, 10)
        for c_idx in range(3):
            if (c_idx == 0 and not sh.sao_luma) or \
               (c_idx == 1 and not sh.sao_chroma):
                continue
            if c_idx == 2:
                # type copied from Cb; offsets parsed separately
                sao_type = int(fs.sao[ry, rx, 1, 0])
            else:
                if not self.bin("sao_type_idx"):
                    sao_type = 0
                else:
                    sao_type = 1 if not self.bypass() else 2
            fs.sao[ry, rx, c_idx, 0] = sao_type
            if sao_type == 0:
                continue
            offsets = []
            length = (1 << (min(sps.bit_depth, 10) - 5)) - 1
            for _ in range(4):
                v = 0
                while v < length and self.bypass():
                    v += 1
                offsets.append(v)
            if sao_type == 1:  # band
                for i in range(4):
                    if offsets[i] and self.bypass():  # sao_offset_sign
                        offsets[i] = -offsets[i]
                band_pos = self.bypass_bits(5)
                fs.sao[ry, rx, c_idx, 1] = band_pos
            else:  # edge
                offsets = offsets[:2] + [-offsets[2], -offsets[3]]
                if c_idx == 2:
                    eo = int(fs.sao[ry, rx, 1, 1])
                else:
                    eo = self.bypass_bits(2)
                fs.sao[ry, rx, c_idx, 1] = eo
            for i in range(4):
                fs.sao[ry, rx, c_idx, 2 + i] = offsets[i]

    # -- quadtree -----------------------------------------------------------
    def _coding_quadtree(self, x0, y0, log2_cb, depth):
        sps = self.sps
        cb = 1 << log2_cb
        boundary = x0 + cb > sps.width or y0 + cb > sps.height
        if not boundary and log2_cb > sps.log2_min_cb:
            inc = 0
            x4, y4 = x0 >> 2, y0 >> 2
            if x0 > 0 and self._same_tile4(x4, y4, x4 - 1, y4) and \
                    self.ct_depth[y4, x4 - 1] > depth:
                inc += 1
            if y0 > 0 and self._same_tile4(x4, y4, x4, y4 - 1) and \
                    self.ct_depth[y4 - 1, x4] > depth:
                inc += 1
            split = self.bin("split_cu_flag", inc)
        else:
            split = 1 if (log2_cb > sps.log2_min_cb) else 0
            if boundary and log2_cb == sps.log2_min_cb:
                split = 0
        if self.pps.cu_qp_delta_enabled and \
                log2_cb >= sps.log2_ctb - self.pps.diff_cu_qp_delta_depth:
            # new quantization group (hevc.c:2527)
            self.is_qp_coded = 0
            self.qg_delta = 0
        if self.sh.cu_chroma_qp_offset_enabled and \
                log2_cb >= sps.log2_ctb - \
                self.pps.diff_cu_chroma_qp_offset_depth:
            self.is_cqo_coded = 0        # hevc.c:2531-2534
        if split:
            h = cb >> 1
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._coding_quadtree(x1, y1, log2_cb - 1, depth + 1)
            if self.pps.cu_qp_delta_enabled and \
                    ((x0 + cb) & self.qg_mask) == 0 and \
                    ((y0 + cb) & self.qg_mask) == 0:
                self.qPy_pred = self.qp_y      # hevc.c:2565
        else:
            self._coding_unit(x0, y0, log2_cb, depth)

    # -- coding unit --------------------------------------------------------
    def _coding_unit(self, x0, y0, log2_cb, depth):
        self._coding_unit_body(x0, y0, log2_cb, depth)
        if self.pps.cu_qp_delta_enabled:
            # CU tail (hevc.c:2489-2500): derive the (possibly
            # prediction-only) QP, paint it, update decode-order pred
            if not self.is_qp_coded:
                self._set_qPy(x0, y0)
            cb = 1 << log2_cb
            x4, y4 = x0 >> 2, y0 >> 2
            n4 = cb >> 2
            self.fs.qp_y4[y4:y4 + n4, x4:x4 + n4] = self.qp_y
            if ((x0 + cb) & self.qg_mask) == 0 and \
                    ((y0 + cb) & self.qg_mask) == 0:
                self.qPy_pred = self.qp_y

    def _set_qPy(self, x_base, y_base):
        """ff_hevc_set_qPy + get_qPy_pred (hevc_filter.c:91-143)."""
        sps, sh = self.sps, self.sh
        ctb_mask = (1 << sps.log2_ctb) - 1
        x_qg = x_base - (x_base & self.qg_mask)
        y_qg = y_base - (y_base & self.qg_mask)
        avail_a = (x_base & ctb_mask) and (x_qg & ctb_mask)
        avail_b = (y_base & ctb_mask) and (y_qg & ctb_mask)
        if self.first_qp_group or (x_qg == 0 and y_qg == 0):
            self.first_qp_group = not self.is_qp_coded
            pred = sh.qp
        else:
            pred = self.qPy_pred
        qa = int(self.fs.qp_y4[y_qg >> 2, (x_qg - 1) >> 2]) \
            if avail_a else pred
        qb = int(self.fs.qp_y4[(y_qg - 1) >> 2, x_qg >> 2]) \
            if avail_b else pred
        qp = (qa + qb + 1) >> 1
        if self.qg_delta != 0:
            off = sps.qp_bd_offset
            qp = (qp + self.qg_delta + 52 + 2 * off) % (52 + off) - off
        self.qp_y = qp
        self.cu_qp = qp

    def _cu_qp_delta_abs(self) -> int:
        """9.3.3.10 (ff_hevc_cu_qp_delta_abs, hevc_cabac.c:731): TU
        prefix (<=5, ctx 0 then 1) + EG0 bypass suffix."""
        prefix = 0
        inc = 0
        while prefix < 5 and self.bin("cu_qp_delta", inc):
            prefix += 1
            inc = 1
        if prefix < 5:
            return prefix
        k = 0
        suffix = 0
        while self.bypass():
            suffix += 1 << k
            k += 1
        while k:
            k -= 1
            suffix += self.bypass() << k
        return prefix + suffix

    def _coding_unit_body(self, x0, y0, log2_cb, depth):
        sps, pps, fs = self.sps, self.pps, self.fs
        cb = 1 << log2_cb
        x4, y4 = x0 >> 2, y0 >> 2
        n4 = cb >> 2
        self.ct_depth[y4:y4 + n4, x4:x4 + n4] = depth
        self.cu_x0, self.cu_y0, self.cu_log2 = x0, y0, log2_cb
        self.cu_tqb = 0
        self.cu_qp = self.qp_y if pps.cu_qp_delta_enabled else self.sh.qp
        fs.qp_y4[y4:y4 + n4, x4:x4 + n4] = self.cu_qp
        if pps.transquant_bypass_enabled:
            self.cu_tqb = self.bin("cu_transquant_bypass_flag")
            fs.tqb[y4:y4 + n4, x4:x4 + n4] = self.cu_tqb
        if self.sh.slice_type != I_SLICE:
            inc = 0
            if x0 > 0 and self._same_tile4(x4, y4, x4 - 1, y4) and \
                    self.skip_grid[y4, x4 - 1]:
                inc += 1
            if y0 > 0 and self._same_tile4(x4, y4, x4, y4 - 1) and \
                    self.skip_grid[y4 - 1, x4]:
                inc += 1
            skip = self.bin("cu_skip_flag", inc)
            if skip:
                self.skip_grid[y4:y4 + n4, x4:x4 + n4] = 1
                self.cu_pred_mode = MODE_INTER
                fs.pred_mode[y4:y4 + n4, x4:x4 + n4] = MODE_INTER
                cb_l = 1 << log2_cb
                self._prediction_unit(x0, y0, cb_l, cb_l, PART_2Nx2N, 0,
                                      log2_cb, x0, y0, is_skip=True)
                fs.bounds_v[y4:y4 + n4, x4] = 1
                fs.bounds_h[y4, x4:x4 + n4] = 1
                return
            if not self.bin("pred_mode_flag"):
                return self._inter_cu(x0, y0, log2_cb, depth)
        self.cu_pred_mode = MODE_INTRA
        fs.pred_mode[y4:y4 + n4, x4:x4 + n4] = MODE_INTRA
        self.mc.set_intra(x0, y0, 1 << log2_cb)
        part_mode = PART_2Nx2N
        if log2_cb == sps.log2_min_cb:
            if not self.bin("part_mode"):
                part_mode = PART_NxN
        self.cu_part_mode = part_mode
        pcm = 0
        if (sps.pcm_enabled and part_mode == PART_2Nx2N and
                sps.log2_min_pcm_cb <= log2_cb <= sps.log2_max_pcm_cb):
            pcm = self.terminate()
        if pcm:
            self._pcm_sample(x0, y0, log2_cb)
            fs.is_pcm[y4:y4 + n4, x4:x4 + n4] = 1
            fs.ipm[y4:y4 + n4, x4:x4 + n4] = 1  # DC for neighbor derivation
            fs.bounds_v[y4:y4 + n4, x4] = 1
            fs.bounds_h[y4, x4:x4 + n4] = 1
            return
        self._intra_prediction_unit(x0, y0, log2_cb, part_mode)
        intra_split = 1 if part_mode == PART_NxN else 0
        max_depth = sps.max_transform_hierarchy_depth_intra + intra_split
        self._transform_tree(x0, y0, x0, y0, log2_cb, 0, 0, max_depth,
                             intra_split, log2_cb, ((1, 1), (1, 1)))

    # -- inter CU -----------------------------------------------------------
    def _inter_cu(self, x0, y0, log2_cb, depth):
        sps, fs = self.sps, self.fs
        cb = 1 << log2_cb
        x4, y4 = x0 >> 2, y0 >> 2
        n4 = cb >> 2
        self.cu_pred_mode = MODE_INTER
        self.cu_depth = depth
        fs.pred_mode[y4:y4 + n4, x4:x4 + n4] = MODE_INTER
        part_mode = self._part_mode_inter(log2_cb)
        self.cu_part_mode = part_mode
        pus = self._pu_geometry(x0, y0, cb, part_mode)
        first_merge = False
        for idx, (px, py, pw, ph) in enumerate(pus):
            mf = self._prediction_unit(px, py, pw, ph, part_mode, idx,
                                       log2_cb, x0, y0, is_skip=False)
            if idx == 0:
                first_merge = mf
        # rqt_root_cbf
        rqt_root_cbf = 1
        if not (part_mode == PART_2Nx2N and first_merge):
            rqt_root_cbf = self.bin("rqt_root_cbf")
        if rqt_root_cbf:
            inter_split = (sps.max_transform_hierarchy_depth_inter == 0 and
                           part_mode != PART_2Nx2N)
            max_depth = (sps.max_transform_hierarchy_depth_inter +
                         (1 if inter_split else 0))
            self._transform_tree(x0, y0, x0, y0, log2_cb, 0, 0, max_depth,
                                 1 if inter_split else 0, log2_cb, ((1, 1), (1, 1)))
        else:
            fs.bounds_v[y4:y4 + n4, x4] = 1
            fs.bounds_h[y4, x4:x4 + n4] = 1

    def _part_mode_inter(self, log2_cb):
        """ff_hevc_part_mode_decode behavior for inter CUs."""
        sps = self.sps
        if self.bin("part_mode", 0):
            return PART_2Nx2N
        if log2_cb == sps.log2_min_cb:
            if self.bin("part_mode", 1):
                return PART_2NxN
            if log2_cb == 3:
                return PART_Nx2N
            if self.bin("part_mode", 2):
                return PART_Nx2N
            return PART_NxN
        if not sps.amp_enabled:
            if self.bin("part_mode", 1):
                return PART_2NxN
            return PART_Nx2N
        if self.bin("part_mode", 1):
            if self.bin("part_mode", 3):
                return PART_2NxN
            if self.bypass():
                return PART_2NxnD
            return PART_2NxnU
        if self.bin("part_mode", 3):
            return PART_Nx2N
        if self.bypass():
            return PART_nRx2N
        return PART_nLx2N

    @staticmethod
    def _pu_geometry(x0, y0, cb, part_mode):
        h = cb >> 1
        q = cb >> 2
        if part_mode == PART_2Nx2N:
            return [(x0, y0, cb, cb)]
        if part_mode == PART_2NxN:
            return [(x0, y0, cb, h), (x0, y0 + h, cb, h)]
        if part_mode == PART_Nx2N:
            return [(x0, y0, h, cb), (x0 + h, y0, h, cb)]
        if part_mode == PART_NxN:
            return [(x0, y0, h, h), (x0 + h, y0, h, h),
                    (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)]
        if part_mode == PART_2NxnU:
            return [(x0, y0, cb, q), (x0, y0 + q, cb, cb - q)]
        if part_mode == PART_2NxnD:
            return [(x0, y0, cb, cb - q), (x0, y0 + cb - q, cb, q)]
        if part_mode == PART_nLx2N:
            return [(x0, y0, q, cb), (x0 + q, y0, cb - q, cb)]
        return [(x0, y0, cb - q, cb), (x0 + cb - q, y0, q, cb)]

    def _prediction_unit(self, x0, y0, w, h, part_mode, part_idx, log2_cb,
                         cu_x, cu_y, is_skip):
        """Returns True if this PU used merge. (hls_prediction_unit)"""
        from .mvs import MvField, PF_L0, PF_L1, PF_BI
        sh = self.sh
        merge = True
        if is_skip:
            merge_idx = self._merge_idx()
            f = self.mc.merge_mode(x0, y0, w, h, log2_cb, part_mode,
                                   part_idx, merge_idx, cu_x, cu_y)
        elif self.bin("merge_flag"):
            merge_idx = self._merge_idx()
            f = self.mc.merge_mode(x0, y0, w, h, log2_cb, part_mode,
                                   part_idx, merge_idx, cu_x, cu_y)
        else:
            merge = False
            if sh.slice_type == B_SLICE:
                idc = self._inter_pred_idc(w, h)
            else:
                idc = PRED_L0
            mv = [(0, 0), (0, 0)]
            ref = [0, 0]
            poc = [0, 0]
            if idc != PRED_L1:
                ref[0] = self._ref_idx(sh.num_ref_idx[0])
                mvd0 = self._mvd_coding()
                mvp0 = self.bin("mvp_l0_flag")
                pred = self.mc.amvp(x0, y0, w, h, 0, ref[0], mvp0)
                mv[0] = (_wrap16(pred[0] + mvd0[0]),
                         _wrap16(pred[1] + mvd0[1]))
                poc[0] = self.ref_list[0][ref[0]][0]
            if idc != PRED_L0:
                ref[1] = self._ref_idx(sh.num_ref_idx[1])
                if sh.mvd_l1_zero and idc == PRED_BI:
                    mvd1 = (0, 0)
                else:
                    mvd1 = self._mvd_coding()
                mvp1 = self.bin("mvp_l0_flag")
                pred = self.mc.amvp(x0, y0, w, h, 1, ref[1], mvp1)
                mv[1] = (_wrap16(pred[0] + mvd1[0]),
                         _wrap16(pred[1] + mvd1[1]))
                poc[1] = self.ref_list[1][ref[1]][0]
            pf = (PF_BI if idc == PRED_BI else
                  (PF_L0 if idc == PRED_L0 else PF_L1))
            f = MvField(pf, (tuple(mv[0]), tuple(mv[1])),
                        (ref[0], ref[1]), (poc[0], poc[1]))
        self.mc.set_pu(x0, y0, w, h, f)
        self.fs.inter_pbs.append(InterPb(
            x=x0, y=y0, w=w, h=h,
            l0=(f.mv[0][0], f.mv[0][1], f.poc[0]) if f.pred_flag & 1 else None,
            l1=(f.mv[1][0], f.mv[1][1], f.poc[1]) if f.pred_flag & 2 else None,
            r0=f.ref_idx[0], r1=f.ref_idx[1]))
        return merge

    def _merge_idx(self):
        if self.sh.max_num_merge_cand <= 1:
            return 0
        i = self.bin("merge_idx")
        if i:
            while i < self.sh.max_num_merge_cand - 1 and self.bypass():
                i += 1
        return i

    def _inter_pred_idc(self, w, h):
        if w + h == 12:
            return PRED_L1 if self.bin("inter_pred_idc", 4) else PRED_L0
        if self.bin("inter_pred_idc", self.cu_depth):
            return PRED_BI
        return PRED_L1 if self.bin("inter_pred_idc", 4) else PRED_L0

    def _ref_idx(self, num_ref):
        i = 0
        mx = num_ref - 1
        max_ctx = min(mx, 2)
        while i < max_ctx and self.bin("ref_idx_l0", i):
            i += 1
        if i == 2:
            while i < mx and self.bypass():
                i += 1
        return i

    def _mvd_coding(self):
        gx = self.bin("abs_mvd_greater0_flag", 0)
        gy = self.bin("abs_mvd_greater0_flag", 0)
        if gx:
            gx += self.bin("abs_mvd_greater1_flag", 1)
        if gy:
            gy += self.bin("abs_mvd_greater1_flag", 1)
        mvd = [0, 0]
        for k, g in ((0, gx), (1, gy)):
            if g == 2:
                v = 2
                kk = 1
                while kk < 32 and self.bypass():
                    v += 1 << kk
                    kk += 1
                while kk:
                    kk -= 1
                    v += self.bypass() << kk
                mvd[k] = -v if self.bypass() else v
            elif g == 1:
                mvd[k] = -1 if self.bypass() else 1
        return tuple(mvd)

    def _pcm_sample(self, x0, y0, log2_cb):
        sps, fs = self.sps, self.fs
        cb = 1 << log2_cb
        end_byte = self.cab.consumed_bytes()
        r = BitReader(self.rbsp, end_byte * 8)
        bd, bdc = sps.pcm_bit_depth, sps.pcm_bit_depth_chroma
        ys = np.array([r.read(bd) for _ in range(cb * cb)],
                      np.int32).reshape(cb, cb)
        csz = cb >> sps.hshift1
        csz_v = cb >> sps.vshift1
        cbs = np.array([r.read(bdc) for _ in range(csz * csz_v)],
                       np.int32).reshape(csz_v, csz)
        crs = np.array([r.read(bdc) for _ in range(csz * csz_v)],
                       np.int32).reshape(csz_v, csz)
        # pcm samples scale up to bit depth (put_pcm behavior)
        ys = ys << (sps.bit_depth - bd)
        cbs = cbs << (sps.bit_depth_chroma - bdc)
        crs = crs << (sps.bit_depth_chroma - bdc)
        fs.pcm_blocks.append(PcmBlock(x0, y0, cb, ys, cbs, crs))
        assert r.pos % 8 == 0
        self.cab.reinit(r.pos)

    # -- intra modes --------------------------------------------------------
    def _intra_prediction_unit(self, x0, y0, log2_cb, part_mode):
        fs = self.fs
        n_pu = 4 if part_mode == PART_NxN else 1
        pb = (1 << log2_cb) >> (1 if part_mode == PART_NxN else 0)
        prev_flags = [self.bin("prev_intra_luma_pred_flag")
                      for _ in range(n_pu)]
        modes = []
        for i in range(n_pu):
            px = x0 + (i & 1) * pb
            py = y0 + (i >> 1) * pb
            cands = self._mpm_candidates(px, py)
            if prev_flags[i]:
                idx = 0
                while idx < 2 and self.bypass():
                    idx += 1
                mode = cands[idx]
            else:
                rem = self.bypass_bits(5)
                sc = sorted(cands)
                mode = rem
                for c in sc:
                    if mode >= c:
                        mode += 1
            modes.append(mode)
            p4, n4 = pb >> 2, pb >> 2
            fs.ipm[py >> 2:(py >> 2) + n4, px >> 2:(px >> 2) + n4] = mode
        self.pu_intra_modes = (modes * 4)[:4]
        # chroma mode: per PU for 4:4:4, single otherwise (7.3.8.5)
        n_cpu = n_pu if self.sps.chroma_format_idc == 3 else 1
        cmodes = []
        self.pu_chroma_idx = []
        for i in range(n_cpu):
            if not self.bin("intra_chroma_pred_mode"):
                cmodes.append(modes[i])
                self.pu_chroma_idx.append(4)      # derived (DM)
            else:
                idx = self.bypass_bits(2)
                table = (0, 26, 10, 1)
                m = table[idx]
                cmodes.append(34 if m == modes[i] else m)
                self.pu_chroma_idx.append(idx)
        if self.sps.chroma_format_idc == 2:
            # 4:2:2: mode mapped through Table 8-3 (hevc.c:2310)
            cmodes = [TAB_MODE_IDX_422[m] for m in cmodes]
        self.intra_mode_c = cmodes[0]
        self.pu_chroma_modes = (cmodes * 4)[:4]
        self.pu_chroma_idx = (self.pu_chroma_idx * 4)[:4]

    def _mpm_candidates(self, x0, y0):
        sps, fs = self.sps, self.fs
        x4, y4 = x0 >> 2, y0 >> 2
        zc = self.zscan[y4, x4]
        # left (x0-1, y0)
        cand_a = 1
        if x0 > 0 and self._same_tile4(x4, y4, x4 - 1, y4) and \
                self.zscan[y4, x4 - 1] < zc and \
                fs.pred_mode[y4, x4 - 1] == MODE_INTRA and \
                not fs.is_pcm[y4, x4 - 1]:
            cand_a = int(fs.ipm[y4, x4 - 1])
        # above (x0, y0-1); outside CTB -> DC
        cand_b = 1
        if y0 > 0 and (y0 % (1 << sps.log2_ctb)) != 0 and \
                self._same_tile4(x4, y4, x4, y4 - 1) and \
                self.zscan[y4 - 1, x4] < zc and \
                fs.pred_mode[y4 - 1, x4] == MODE_INTRA and \
                not fs.is_pcm[y4 - 1, x4]:
            cand_b = int(fs.ipm[y4 - 1, x4])
        if cand_a == cand_b:
            if cand_a < 2:
                return [0, 1, 26]
            return [cand_a,
                    2 + ((cand_a + 29) % 32),
                    2 + ((cand_a - 2 + 1) % 32)]
        lst = [cand_a, cand_b]
        if cand_a != 0 and cand_b != 0:
            lst.append(0)
        elif cand_a + cand_b < 2:
            lst.append(26)
        else:
            lst.append(1)
        return lst

    # -- transform tree -----------------------------------------------------
    def _transform_tree(self, x0, y0, x_base, y_base, log2_tr, depth, blk_idx,
                        max_depth, intra_split, log2_cb, parent_cbf_c):
        """cbf_cb/cbf_cr are 2-vectors: [1] is the second (lower) chroma
        TB of a 4:2:2 pair (hls_transform_tree, hevc.c:1452/1495)."""
        sps = self.sps
        cbf_cb = list(parent_cbf_c[0])
        cbf_cr = list(parent_cbf_c[1])
        is422 = sps.chroma_format_idc == 2
        split = 0
        if (log2_tr <= sps.log2_max_tb and log2_tr > sps.log2_min_tb and
                depth < max_depth and not (intra_split and depth == 0)):
            split = self.bin("split_transform_flag", 5 - log2_tr)
        else:
            if log2_tr > sps.log2_max_tb or (intra_split and depth == 0):
                split = 1
        if log2_tr > 2 or sps.chroma_format_idc == 3:
            if depth == 0 or cbf_cb[0]:
                cbf_cb[0] = self.bin("cbf_cbcr", depth)
                if is422 and (not split or log2_tr == 3):
                    cbf_cb[1] = self.bin("cbf_cbcr", depth)
            else:
                cbf_cb = [0, 0]
            if depth == 0 or cbf_cr[0]:
                cbf_cr[0] = self.bin("cbf_cbcr", depth)
                if is422 and (not split or log2_tr == 3):
                    cbf_cr[1] = self.bin("cbf_cbcr", depth)
            else:
                cbf_cr = [0, 0]
        if split:
            h = 1 << (log2_tr - 1)
            for i, (dx, dy) in enumerate(((0, 0), (h, 0), (0, h), (h, h))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2_tr - 1,
                                     depth + 1, i, max_depth, intra_split,
                                     log2_cb, (cbf_cb, cbf_cr))
            return
        cbf_luma = 1
        if self.cu_pred_mode == MODE_INTRA or depth != 0 or \
                cbf_cb[0] or cbf_cr[0] or \
                (is422 and (cbf_cb[1] or cbf_cr[1])):
            cbf_luma = self.bin("cbf_luma", 0 if depth else 1)
        self._transform_unit(x0, y0, x_base, y_base, log2_tr, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    def _transform_unit(self, x0, y0, x_base, y_base, log2_tr, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr):
        sps, fs = self.sps, self.fs
        is422 = sps.chroma_format_idc == 2
        any_cbf = (cbf_luma or cbf_cb[0] or cbf_cr[0] or
                   (is422 and (cbf_cb[1] or cbf_cr[1])))
        if any_cbf and self.pps.cu_qp_delta_enabled and \
                not self.is_qp_coded:
            d = self._cu_qp_delta_abs()
            if d and self.bypass():    # cu_qp_delta_sign_flag
                d = -d
            self.qg_delta = d
            self.is_qp_coded = 1
            self._set_qPy(self.cu_x0, self.cu_y0)
        cbf_chroma = (cbf_cb[0] or cbf_cr[0] or
                      (is422 and (cbf_cb[1] or cbf_cr[1])))
        if self.sh.cu_chroma_qp_offset_enabled and cbf_chroma and \
                not self.cu_tqb and not self.is_cqo_coded:
            # cu_chroma_qp_offset_flag/_idx (hevc.c:1247-1263)
            flag = self.bin("cu_chroma_qp_offset_flag", 0)
            idx = 0
            if flag and len(self.pps.cb_qp_offset_list) > 1:
                # TR-coded idx, all bins on context 0; cMax is
                # max(5, len-1) — the reference's exact behavior
                # (ff_hevc_cu_chroma_qp_offset_idx, hevc_cabac.c:768)
                n = max(5, len(self.pps.cb_qp_offset_list) - 1)
                while idx < n and self.bin("cu_chroma_qp_offset_idx", 0):
                    idx += 1
            if flag:
                self.cu_qp_offset_cb = self.pps.cb_qp_offset_list[idx]
                self.cu_qp_offset_cr = self.pps.cr_qp_offset_list[idx]
            else:
                self.cu_qp_offset_cb = 0
                self.cu_qp_offset_cr = 0
            self.is_cqo_coded = 1
        n4 = 1 << max(0, log2_tr - 2)
        x4, y4 = x0 >> 2, y0 >> 2
        fs.bounds_v[y4:y4 + n4, x4] = 1
        fs.bounds_h[y4, x4:x4 + n4] = 1
        if cbf_luma:
            fs.cbf_luma4[y4:y4 + n4, x4:x4 + n4] = 1
        is444 = self.sps.chroma_format_idc == 3
        if self.cu_pred_mode == MODE_INTRA:
            # luma intra prediction for this TB (decode-order job)
            mode = self._luma_mode_at(x0, y0)
            size = 1 << log2_tr
            self._emit_intra_job(0, x0, y0, size, mode)
        if cbf_luma:
            mode = self._luma_mode_at(x0, y0) \
                if self.cu_pred_mode == MODE_INTRA else -1
            self._residual(x0, y0, log2_tr, 0, mode)
        mode_c = self._chroma_mode_at(x0, y0)
        hs, vs = sps.hshift1, sps.vshift1
        n_c = 2 if sps.chroma_format_idc == 2 else 1   # 4:2:2 TB pairs
        if log2_tr > 2 or is444:
            # chroma TB log2 = luma - hshift (hevc.c:1210); 4:2:2 codes a
            # vertical pair of square TBs per component (hevc.c:1302)
            clog2 = log2_tr - hs
            csz = 1 << clog2
            cx, cy0 = x0 >> hs, y0 >> vs
            # cross-component prediction (RExt, hevc.c:1295): active for
            # 4:4:4 when luma has residual and the CU is inter or the
            # chroma mode is derived-from-luma
            cross_pf = bool(
                getattr(self.pps, "cross_component_prediction_enabled", 0)
                and cbf_luma and
                (self.cu_pred_mode == MODE_INTER or
                 self._chroma_idx_at(x0, y0) == 4))
            for plane, cbf in ((1, cbf_cb), (2, cbf_cr)):
                scale = 0
                if cross_pf:
                    scale = self._res_scale(plane - 1)
                for i in range(n_c):
                    cy = cy0 + (i << clog2)
                    if self.cu_pred_mode == MODE_INTRA:
                        self._emit_intra_job(plane, cx, cy, csz, mode_c)
                    if cbf[i]:
                        self._residual(cx, cy, clog2, plane, mode_c,
                                       cross_scale=scale)
                    elif scale:
                        # zero-cbf chroma still receives the scaled luma
                        # residual (hevc.c:1315-1329)
                        self.fs.coeff_blocks.append(CoeffBlock(
                            plane=plane, x=cx, y=cy, log2_size=clog2,
                            qp=0, is_dst=False, transform_skip=False,
                            transquant_bypass=True, rdpcm_mode=-1,
                            levels=np.zeros((csz, csz), np.int32),
                            cross_scale=scale))
        elif blk_idx == 3:
            # chroma handled at the last 4x4 luma TB of the parent 8x8
            cx, cy0 = x_base >> hs, y_base >> vs
            for plane, cbf in ((1, cbf_cb), (2, cbf_cr)):
                for i in range(n_c):
                    cy = cy0 + (i << 2)
                    if self.cu_pred_mode == MODE_INTRA:
                        self._emit_intra_job(plane, cx, cy, 4, mode_c)
                    if cbf[i]:
                        self._residual(cx, cy, 2, plane, mode_c)

    def _chroma_idx_at(self, x0, y0):
        """Coded intra_chroma_pred_mode index of the PU containing this
        TB (4 = derived; lc->tu.chroma_mode_c, hevc.c:1465-1474)."""
        if (self.sps.chroma_format_idc == 3 and
                self.cu_part_mode == PART_NxN):
            half = 1 << (self.cu_log2 - 1)
            bi = (2 if (y0 - self.cu_y0) >= half else 0) + \
                 (1 if (x0 - self.cu_x0) >= half else 0)
            return self.pu_chroma_idx[bi]
        return self.pu_chroma_idx[0]

    def _chroma_mode_at(self, x0, y0):
        """tu.intra_pred_mode_c selection (hevc.c:1460-1475): per-PU
        chroma modes apply for NxN in 4:4:4, chosen by the depth-1
        quadrant containing this TB."""
        if (self.sps.chroma_format_idc == 3 and
                self.cu_part_mode == PART_NxN):
            half = 1 << (self.cu_log2 - 1)
            bi = (2 if (y0 - self.cu_y0) >= half else 0) + \
                 (1 if (x0 - self.cu_x0) >= half else 0)
            return self.pu_chroma_modes[bi]
        return self.intra_mode_c

    def _luma_mode_at(self, x0, y0):
        return int(self.fs.ipm[y0 >> 2, x0 >> 2])

    # -- intra job emission (availability resolved here) --------------------
    def _emit_intra_job(self, plane, x, y, size, mode):
        sps = self.sps
        hs = sps.hshift1 if plane else 0
        vs = sps.vshift1 if plane else 0
        avail = avail_mask(self.zscan, self.fs.pred_mode,
                           bool(self.pps.constrained_intra_pred),
                           x, y, size, hs, vs, sps.width, sps.height,
                           tile4=self.tile4)
        filt = ((plane == 0 or sps.chroma_format_idc == 3) and
                not getattr(sps, "intra_smoothing_disabled", 0))
        self.fs.intra_jobs.append(
            IntraJob(plane, x, y, size, mode, avail, filt))

    # -- residual coding ----------------------------------------------------
    def _residual(self, x0, y0, log2_tr, c_idx, pred_mode_intra,
                  cross_scale=0):
        sps, pps, fs = self.sps, self.pps, self.fs
        size = 1 << log2_tr
        levels = np.zeros((size, size), np.int32)
        transform_skip = 0
        if (not self.cu_tqb and pps.transform_skip_enabled and
                log2_tr <= pps.log2_max_transform_skip_block_size):
            transform_skip = self.bin("transform_skip_flag", 1 if c_idx else 0)
        # scan selection (7.4.9.11)
        scan_idx = SCAN_DIAG
        if self.cu_pred_mode == MODE_INTRA and (
                log2_tr == 2 or (log2_tr == 3 and c_idx == 0) or
                (log2_tr == 3 and sps.chroma_format_idc == 3)):
            if 6 <= pred_mode_intra <= 14:
                scan_idx = SCAN_VERT
            elif 22 <= pred_mode_intra <= 30:
                scan_idx = SCAN_HORIZ
        explicit_rdpcm = -1       # -1 absent, else dir (0 horiz, 1 vert)
        if (self.cu_pred_mode == MODE_INTER and
                getattr(sps, "explicit_rdpcm_enabled", 0) and
                (transform_skip or self.cu_tqb)):
            if self.bin("explicit_rdpcm_flag", 1 if c_idx else 0):
                explicit_rdpcm = self.bin("explicit_rdpcm_dir_flag",
                                          1 if c_idx else 0)
        last_x = self._last_sig_prefix(c_idx, log2_tr, "last_sig_coeff_x_prefix")
        last_y = self._last_sig_prefix(c_idx, log2_tr, "last_sig_coeff_y_prefix")
        if last_x > 3:
            n = (last_x >> 1) - 1
            suffix = self.bypass_bits(n)
            last_x = (1 << n) * (2 + (last_x & 1)) + suffix
        if last_y > 3:
            n = (last_y >> 1) - 1
            suffix = self.bypass_bits(n)
            last_y = (1 << n) * (2 + (last_y & 1)) + suffix
        if scan_idx == SCAN_VERT:
            last_x, last_y = last_y, last_x
        ncg = size >> 2
        cg_scan = _CG_SCANS[(scan_idx, ncg)] if ncg > 1 else [(0, 0)]
        cg_inv = _CG_SCANS_INV[(scan_idx, ncg)] if ncg > 1 else {(0, 0): 0}
        off_scan = _SCANS_4[scan_idx]
        off_inv = _SCANS_4_INV[scan_idx]
        x_cg_last, y_cg_last = last_x >> 2, last_y >> 2
        num_coeff = off_inv[(last_x & 3, last_y & 3)]
        num_coeff += cg_inv[(x_cg_last, y_cg_last)] << 4
        num_coeff += 1
        num_last_subset = (num_coeff - 1) >> 4
        csbf = np.zeros((8, 8), np.uint8)
        greater1_ctx_carry = 1
        sign_hiding = pps.sign_data_hiding
        for i in range(num_last_subset, -1, -1):
            x_cg, y_cg = cg_scan[i]
            offset = i << 4
            implicit_nz = 0
            if i < num_last_subset and i > 0:
                ctx_cg = 0
                if x_cg < ncg - 1:
                    ctx_cg += csbf[x_cg + 1, y_cg]
                if y_cg < ncg - 1:
                    ctx_cg += csbf[x_cg, y_cg + 1]
                inc = min(int(ctx_cg), 1) + (2 if c_idx else 0)
                csbf[x_cg, y_cg] = self.bin("coded_sub_block_flag", inc)
                implicit_nz = 1
            else:
                csbf[x_cg, y_cg] = int(
                    (x_cg == x_cg_last and y_cg == y_cg_last) or
                    (x_cg == 0 and y_cg == 0))
            last_scan_pos = num_coeff - offset - 1
            sig_idx = []
            if i == num_last_subset:
                n_end = last_scan_pos - 1
                sig_idx.append(last_scan_pos)
            else:
                n_end = 15
            prev_sig = 0
            if x_cg < (size - 1) >> 2:
                prev_sig = int(csbf[x_cg + 1, y_cg])
            if y_cg < (size - 1) >> 2:
                prev_sig += int(csbf[x_cg, y_cg + 1]) << 1
            if csbf[x_cg, y_cg] and n_end >= 0:
                if c_idx == 0:
                    base_off = 0
                    if log2_tr == 2:
                        map_row = 0
                    else:
                        map_row = prev_sig + 1
                        if x_cg > 0 or y_cg > 0:
                            base_off += 3
                        base_off += (9 if scan_idx == SCAN_DIAG else 15) \
                            if log2_tr == 3 else 21
                else:
                    base_off = 27
                    if log2_tr == 2:
                        map_row = 0
                    else:
                        map_row = prev_sig + 1
                        base_off += 9 if log2_tr == 3 else 12
                for n in range(n_end, 0, -1):
                    xc, yc = off_scan[n]
                    inc = SIG_CTX_MAP[map_row][(yc << 2) + xc] + base_off
                    if self.bin("sig_coeff_flag", inc):
                        sig_idx.append(n)
                        implicit_nz = 0
                # DC of the sub-block
                if implicit_nz == 0:
                    if i == 0:
                        dc_off = 0 if c_idx == 0 else 27
                    else:
                        dc_off = 2 + base_off
                    if self.bin("sig_coeff_flag", dc_off):
                        sig_idx.append(0)
                else:
                    sig_idx.append(0)
            n_sig = len(sig_idx)
            if n_sig == 0:
                continue
            # greater1 / greater2
            ctx_set = 2 if (i > 0 and c_idx == 0) else 0
            if i != num_last_subset and greater1_ctx_carry == 0:
                ctx_set += 1
            g1 = 1
            gt1_flags = []
            first_g1 = -1
            for m in range(min(n_sig, 8)):
                inc = (ctx_set << 2) + g1 + (16 if c_idx else 0)
                f = self.bin("coeff_abs_level_greater1_flag", inc)
                gt1_flags.append(f)
                if f:
                    g1 = 0
                    if first_g1 == -1:
                        first_g1 = m
                elif 0 < g1 < 3:
                    g1 += 1
            greater1_ctx_carry = g1
            last_nz = sig_idx[0]
            first_nz = sig_idx[-1]
            if self.cu_tqb:
                hidden = False
            elif (self.cu_pred_mode == MODE_INTRA and
                  getattr(sps, "implicit_rdpcm_enabled", 0) and
                  transform_skip and pred_mode_intra in (10, 26)):
                hidden = False
            else:
                hidden = (last_nz - first_nz) >= 4
            if first_g1 != -1:
                inc = ctx_set + (4 if c_idx else 0)
                gt1_flags[first_g1] += self.bin(
                    "coeff_abs_level_greater2_flag", inc)
            nb_signs = n_sig - (1 if (sign_hiding and hidden) else 0)
            sign_bits = self.bypass_bits(nb_signs) << (16 - nb_signs) \
                if nb_signs else 0
            # persistent Rice adaptation (9.3.3.13; hevc_cabac.c:1716-1786)
            price = getattr(sps, "persistent_rice_adaptation", 0)
            if price:
                sb_type = 2 * (1 if c_idx == 0 else 0) + \
                    (1 if (transform_skip or self.cu_tqb) else 0)
                rice = self.stat_coeff[sb_type] >> 2
            else:
                rice = 0
            rice_init = False
            sum_abs = 0

            def bump(rem, rice):
                nonlocal rice_init
                if price and not rice_init:
                    r0 = self.stat_coeff[sb_type] >> 2
                    if rem >= (3 << r0):
                        self.stat_coeff[sb_type] += 1
                    elif 2 * rem < (1 << r0) and self.stat_coeff[sb_type]:
                        self.stat_coeff[sb_type] -= 1
                    rice_init = True
                return rice

            for m in range(n_sig):
                n = sig_idx[m]
                xc = (x_cg << 2) + off_scan[n][0]
                yc = (y_cg << 2) + off_scan[n][1]
                if m < 8:
                    level = 1 + gt1_flags[m]
                    if level == (3 if m == first_g1 else 2):
                        rem = self._abs_level_remaining(rice)
                        level += rem
                        if level > (3 << rice):
                            rice = rice + 1 if price else min(rice + 1, 4)
                        rice = bump(rem, rice)
                else:
                    rem = self._abs_level_remaining(rice)
                    level = 1 + rem
                    if level > (3 << rice):
                        rice = rice + 1 if price else min(rice + 1, 4)
                    rice = bump(rem, rice)
                if sign_hiding and hidden:
                    sum_abs += level
                    if n == first_nz and (sum_abs & 1):
                        level = -level
                if sign_bits >> 15:
                    level = -level
                sign_bits = (sign_bits << 1) & 0xFFFF
                levels[yc, xc] = level
        is_dst = (self.cu_pred_mode == MODE_INTRA and c_idx == 0 and
                  log2_tr == 2)
        if c_idx == 0:
            qp = self.cu_qp + sps.qp_bd_offset
        else:
            offset = (pps.cb_qp_offset + self.sh.cb_qp_offset +
                      self.cu_qp_offset_cb if c_idx == 1
                      else pps.cr_qp_offset + self.sh.cr_qp_offset +
                      self.cu_qp_offset_cr)
            cat = 0 if sps.chroma_format_idc == 0 else \
                (1 if sps.chroma_format_idc == 1 else sps.chroma_format_idc)
            qp = chroma_qp(self.cu_qp, offset, cat, sps.qp_bd_offset) + \
                sps.qp_bd_offset
        # transform-skip rotation: 4x4 intra TS blocks are decoded in
        # reversed scan (hevc_cabac.c:1877-1884)
        rot = (getattr(sps, "transform_skip_rotation_enabled", 0) and
               log2_tr == 2 and self.cu_pred_mode == MODE_INTRA and
               transform_skip and not self.cu_tqb)
        if rot:
            levels = levels[::-1, ::-1].copy()
        # RDPCM gates mirror hevc_cabac.c:1868-1892 exactly (including
        # the reference's rotation-flag gate on the TS implicit path)
        rdpcm_mode = -1
        intra_1026 = (self.cu_pred_mode == MODE_INTRA and
                      pred_mode_intra in (10, 26))
        if self.cu_tqb:
            if explicit_rdpcm >= 0 or (
                    getattr(sps, "implicit_rdpcm_enabled", 0) and
                    intra_1026):
                rdpcm_mode = (pred_mode_intra == 26) \
                    if getattr(sps, "implicit_rdpcm_enabled", 0) \
                    else explicit_rdpcm
                rdpcm_mode = int(rdpcm_mode)
        elif transform_skip:
            if explicit_rdpcm >= 0 or (
                    getattr(sps, "transform_skip_rotation_enabled", 0) and
                    intra_1026):
                rdpcm_mode = int(explicit_rdpcm) if explicit_rdpcm >= 0 \
                    else (1 if pred_mode_intra == 26 else 0)
        fs.coeff_blocks.append(CoeffBlock(
            plane=c_idx, x=x0, y=y0, log2_size=log2_tr, qp=qp,
            is_dst=is_dst, transform_skip=bool(transform_skip),
            transquant_bypass=bool(self.cu_tqb), rdpcm_mode=rdpcm_mode,
            levels=levels,
            matrix_id=3 * (self.cu_pred_mode != MODE_INTRA) + c_idx,
            cross_scale=cross_scale))

    def _res_scale(self, idx) -> int:
        """log2_res_scale_abs_plus1 + sign -> res_scale_val
        (hls_cross_component_pred, hevc.c:1150; 4 TU ctx per comp)."""
        i = 0
        while i < 4 and self.bin("log2_res_scale_abs", 4 * idx + i):
            i += 1
        if i == 0:
            return 0
        sign = self.bin("res_scale_sign_flag", idx)
        return (1 << (i - 1)) * (1 - 2 * sign)

    def _last_sig_prefix(self, c_idx, log2_tr, elem):
        if c_idx == 0:
            ctx_offset = 3 * (log2_tr - 2) + ((log2_tr - 1) >> 2)
            ctx_shift = (log2_tr + 1) >> 2
        else:
            ctx_offset = 15
            ctx_shift = log2_tr - 2
        i = 0
        mx = (log2_tr << 1) - 1
        while i < mx and self.bin(elem, (i >> ctx_shift) + ctx_offset):
            i += 1
        return i

    def _abs_level_remaining(self, rice):
        prefix = 0
        while prefix < 32 and self.bypass():
            prefix += 1
        if prefix < 3:
            suffix = self.bypass_bits(rice) if rice else 0
            return (prefix << rice) + suffix
        pm3 = prefix - 3
        suffix = self.bypass_bits(pm3 + rice)
        return (((1 << pm3) + 2) << rice) + suffix
