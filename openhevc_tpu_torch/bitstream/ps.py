"""Parameter-set parsing: VPS / SPS / PPS (H.265 7.3.2).

Python reference model for the native parse core. Parity target:
hevc_ps.c (ff_hevc_decode_nal_{vps,sps,pps}) — full Main / Main10 / RExt
syntax; SHVC VPS-extension fields are tolerated but not yet interpreted.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bits import BitReader, unescape_rbsp


@dataclass
class ProfileTierLevel:
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 1
    compat_flags: int = 0
    progressive_source: int = 0
    interlaced_source: int = 0
    non_packed: int = 0
    frame_only: int = 0
    level_idc: int = 0


def parse_ptl(r: BitReader, max_sub_layers_minus1: int) -> ProfileTierLevel:
    p = ProfileTierLevel()
    p.profile_space = r.read(2)
    p.tier_flag = r.read1()
    p.profile_idc = r.read(5)
    p.compat_flags = r.read(32)
    p.progressive_source = r.read1()
    p.interlaced_source = r.read1()
    p.non_packed = r.read1()
    p.frame_only = r.read1()
    r.read(44)  # RExt constraint flags / reserved
    p.level_idc = r.read(8)
    sub_profile_present = []
    sub_level_present = []
    for _ in range(max_sub_layers_minus1):
        sub_profile_present.append(r.read1())
        sub_level_present.append(r.read1())
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            r.read(2)
    for i in range(max_sub_layers_minus1):
        if sub_profile_present[i]:
            r.read(32 + 32 + 24)  # sub-layer profile block (88 bits)
        if sub_level_present[i]:
            r.read(8)
    return p


@dataclass
class ShortTermRPS:
    """Resolved short-term reference picture set (5-list precursor).

    delta_pocs sorted: negatives ascending-to-current then positives
    (matching the decode order used by ff_hevc_frame_rps)."""
    num_negative: int = 0
    num_positive: int = 0
    delta_poc: list = field(default_factory=list)   # signed deltas
    used: list = field(default_factory=list)

    @property
    def num_delta_pocs(self) -> int:
        return self.num_negative + self.num_positive


def parse_st_rps(r: BitReader, sps: "SPS", idx: int, num_rps: int,
                 in_slice_header: bool = False) -> ShortTermRPS:
    """7.3.7 st_ref_pic_set, incl. inter-RPS prediction."""
    rps = ShortTermRPS()
    pred = 0
    if idx != 0:
        pred = r.read1()  # inter_ref_pic_set_prediction_flag
    if pred:
        if in_slice_header:
            delta_idx = r.ue() + 1
        else:
            delta_idx = 1
        ref = sps.st_rps[idx - delta_idx]
        delta_rps_sign = r.read1()
        abs_delta_rps = r.ue() + 1
        delta_rps = (1 - 2 * delta_rps_sign) * abs_delta_rps
        use_flags = []
        for j in range(ref.num_delta_pocs + 1):
            used_by_curr = r.read1()
            use_delta = 1
            if not used_by_curr:
                use_delta = r.read1()
            use_flags.append((used_by_curr, use_delta))
        # derive (7-57..7-60)
        neg, pos = [], []
        # negative pics of new RPS
        for j in range(ref.num_positive - 1, -1, -1):
            d = ref.delta_poc[ref.num_negative + j] + delta_rps
            if d < 0 and use_flags[ref.num_negative + j][1]:
                neg.append((d, use_flags[ref.num_negative + j][0]))
        if delta_rps < 0 and use_flags[ref.num_delta_pocs][1]:
            neg.append((delta_rps, use_flags[ref.num_delta_pocs][0]))
        for j in range(ref.num_negative):
            d = ref.delta_poc[j] + delta_rps
            if d < 0 and use_flags[j][1]:
                neg.append((d, use_flags[j][0]))
        neg.sort(key=lambda t: -t[0])  # closest (largest, i.e. -1) first
        for j in range(ref.num_negative - 1, -1, -1):
            d = ref.delta_poc[j] + delta_rps
            if d > 0 and use_flags[j][1]:
                pos.append((d, use_flags[j][0]))
        if delta_rps > 0 and use_flags[ref.num_delta_pocs][1]:
            pos.append((delta_rps, use_flags[ref.num_delta_pocs][0]))
        for j in range(ref.num_positive):
            d = ref.delta_poc[ref.num_negative + j] + delta_rps
            if d > 0 and use_flags[ref.num_negative + j][1]:
                pos.append((d, use_flags[ref.num_negative + j][0]))
        pos.sort(key=lambda t: t[0])
        rps.num_negative = len(neg)
        rps.num_positive = len(pos)
        rps.delta_poc = [d for d, _ in neg] + [d for d, _ in pos]
        rps.used = [u for _, u in neg] + [u for _, u in pos]
        return rps
    rps.num_negative = r.ue()
    rps.num_positive = r.ue()
    prev = 0
    for _ in range(rps.num_negative):
        d = r.ue() + 1
        prev -= d
        rps.delta_poc.append(prev)
        rps.used.append(r.read1())
    prev = 0
    for _ in range(rps.num_positive):
        d = r.ue() + 1
        prev += d
        rps.delta_poc.append(prev)
        rps.used.append(r.read1())
    return rps


# Default scaling matrices, raster order (Table 7-5/7-6;
# hevc_ps.c:30-52 default_scaling_list_intra/inter).
_DEFAULT_SL_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32)
_DEFAULT_SL_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32)


def _diag_scan_xy(n: int):
    """Up-right diagonal scan order (6.5.3): [(x, y)] — matches
    ff_hevc_diag_scan4x4/8x8 (hevc_cabac.c:460)."""
    order = []
    x = y = 0
    while len(order) < n * n:
        while y >= 0:
            if x < n and y < n:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return order


_DIAG4 = _diag_scan_xy(4)
_DIAG8 = _diag_scan_xy(8)


class ScalingList:
    """Resolved scaling matrices (ScalingList in hevc.h; filled by
    scaling_list_data, hevc_ps.c:1419).

    sl[size_id][matrix_id]: raster int32 arrays — 4x4 (size 0) or 8x8
    (sizes 1..3; 16x16/32x32 are stored subsampled, exactly like the
    reference). sl_dc[size_id-2][matrix_id]: DC scale for 16x16/32x32."""

    def __init__(self):
        self.sl = [[None] * 6 for _ in range(4)]
        self.sl_dc = [[16] * 6 for _ in range(2)]
        # defaults (set_default_scaling_list_data, hevc_ps.c:1389)
        for m in range(6):
            self.sl[0][m] = np.full(16, 16, np.int32)
            for sz in (1, 2, 3):
                self.sl[sz][m] = (_DEFAULT_SL_INTRA if m < 3 else
                                  _DEFAULT_SL_INTER).copy()

    def copy(self):
        o = ScalingList.__new__(ScalingList)
        o.sl = [[a.copy() for a in row] for row in self.sl]
        o.sl_dc = [list(row) for row in self.sl_dc]
        return o

    def apply_444_fixup(self):
        """chroma_format_idc==3: 32x32 chroma lists mirror the 16x16
        chroma lists (hevc_ps.c:1475-1484)."""
        for m in (1, 2, 4, 5):
            self.sl[3][m] = self.sl[2][m].copy()
            self.sl_dc[1][m] = self.sl_dc[0][m]
        return self

    def matrix(self, log2_size: int, matrix_id: int) -> np.ndarray:
        """Expanded m[y][x] for one TB: 4x4/8x8 direct; 16x16/32x32 by
        2x/4x replication of the 8x8 list with the DC entry overridden
        (position lookup in hevc_cabac.c:1819-1830)."""
        sz = log2_size - 2
        base = self.sl[sz][matrix_id]
        if sz == 0:
            return base.reshape(4, 4)
        m8 = base.reshape(8, 8)
        if sz == 1:
            return m8
        rep = 1 << (sz - 1)
        m = np.repeat(np.repeat(m8, rep, axis=0), rep, axis=1).copy()
        m[0, 0] = self.sl_dc[sz - 2][matrix_id]
        return m


def parse_scaling_list(r: BitReader) -> ScalingList:
    """7.3.4 scaling_list_data -> resolved ScalingList
    (hevc_ps.c:1419-1473). Follows the reference exactly, including its
    un-multiplied pred_matrix_id_delta for size 3 (hevc_ps.c:1442 uses
    matrix_id - delta even though the spec scales delta by 3 there)."""
    sl = ScalingList()
    for size_id in range(4):
        matrix_step = 1 if size_id < 3 else 3
        for matrix_id in range(0, 6, matrix_step):
            pred_mode_flag = r.read1()
            if not pred_mode_flag:
                delta = r.ue()
                if delta:  # 0 = keep default
                    ref = matrix_id - delta
                    sl.sl[size_id][matrix_id] = sl.sl[size_id][ref].copy()
                    if size_id > 1:
                        sl.sl_dc[size_id - 2][matrix_id] = \
                            sl.sl_dc[size_id - 2][ref]
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                if size_id > 1:
                    next_coef = r.se() + 8
                    sl.sl_dc[size_id - 2][matrix_id] = next_coef
                scan = _DIAG4 if size_id == 0 else _DIAG8
                w = 4 if size_id == 0 else 8
                arr = sl.sl[size_id][matrix_id]
                for i in range(coef_num):
                    x, y = scan[i]
                    next_coef = (next_coef + r.se() + 256) % 256
                    arr[w * y + x] = next_coef
    return sl


def active_scaling_list(sps, pps) -> ScalingList | None:
    """The list residual dequant actually uses: PPS override else SPS
    (hevc_cabac.c:1484-1486), with the 4:4:4 fixup applied."""
    if not sps.scaling_list_enabled:
        return None
    sl = pps.scaling_list if pps.scaling_list is not None \
        else sps.scaling_list
    if sl is None:
        return None
    if sps.chroma_format_idc == 3:
        sl = sl.copy().apply_444_fixup()
    return sl


@dataclass
class VPS:
    vps_id: int = 0
    max_layers: int = 1
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel | None = None
    # SHVC extension (parse_vps_extension, hevc_ps.c:714)
    num_direct_ref_layers: tuple = (0,)
    rep_formats: tuple = ()        # (width, height, chroma_idc, bit_depth)
    rep_format_idx: tuple = (0,)
    max_one_active_ref_layer: int = 1
    phase_align: int = 0
    default_dep_type: int = 0
    # vps_timing_info (advisory; 0 = absent)
    num_units_in_tick: int = 0
    time_scale: int = 0


def parse_vps(rbsp: bytes) -> VPS:
    r = BitReader(rbsp)
    v = VPS()
    v.vps_id = r.read(4)
    r.read(2)
    v.max_layers = r.read(6) + 1
    v.max_sub_layers = r.read(3) + 1
    v.temporal_id_nesting = r.read1()
    r.read(16)
    v.ptl = parse_ptl(r, v.max_sub_layers - 1)
    sub_layer_ordering = r.read1()
    for _ in range((0 if sub_layer_ordering else v.max_sub_layers - 1),
                   v.max_sub_layers):
        r.ue(); r.ue(); r.ue()
    max_layer_id = r.read(6)
    num_layer_sets = r.ue() + 1
    n_in_set = [1] + [0] * (num_layer_sets - 1)
    for i in range(1, num_layer_sets):
        for j in range(max_layer_id + 1):
            n_in_set[i] += r.read1()
    if r.read1():           # vps_timing_info_present
        v.num_units_in_tick = r.read(32)
        v.time_scale = r.read(32)
        if r.read1():       # vps_poc_proportional_to_timing
            r.ue()          # vps_num_ticks_poc_diff_one_minus1
        num_hrd = r.ue()
        for i in range(num_hrd):
            r.ue()          # hrd_layer_set_idx[i]
            cprms = 1 if i == 0 else r.read1()
            _parse_hrd(r, cprms, v.max_sub_layers - 1)
    if r.read1() and v.max_layers > 1:   # vps_extension_flag
        r.align()
        _parse_vps_extension(r, v, num_layer_sets, n_in_set)
    return v


def _parse_vps_extension(r: BitReader, v: VPS, num_layer_sets, n_in_set):
    """Mirror of parse_vps_extension (hevc_ps.c:714) for the field set
    the SHVC writer emits; unrecognized shapes raise."""
    nl = v.max_layers
    r.read1()               # avc_base_layer_flag
    splitting = r.read1()
    n_scal = sum(r.read1() for _ in range(16))
    dim_len = [r.read(3) + 1 for _ in range(n_scal - (1 if splitting else 0))]
    nuh_present = r.read1()
    for i in range(1, nl):
        if nuh_present:
            r.read(6)
        for j in range(n_scal):
            r.read(dim_len[j])
    view_len = r.read(4) + 1
    r.read(view_len)        # view_id_val[0] (NumViews == 1 here)
    ndr = [0] * nl
    for i in range(1, nl):
        ndr[i] = sum(r.read1() for _ in range(i))
    v.num_direct_ref_layers = tuple(ndr)
    if r.read1():           # sub_layers_max_minus1_present
        for _ in range(nl - 1):
            r.read(3)
    if r.read1():           # max_tid_ref_present
        for i in range(nl - 1):
            for j in range(i + 1, nl):
                r.read(3)   # (approximates dep-gated reads; writer emits 0)
    r.read1()               # all_ref_layers_active
    assert r.read(10) == num_layer_sets - 1
    n_ptl = r.read(6) + 1
    for i in range(1, n_ptl):
        if not r.read1():   # vps_profile_present_flag
            r.read(6)
        parse_ptl(r, v.max_sub_layers - 1)
    more_ols = r.read1()
    n_ols = num_layer_sets if not more_ols else         num_layer_sets + r.read(10)
    if n_ols > 1:
        default_one = r.read1()
    for i in range(1, n_ols):
        if i > num_layer_sets - 1:
            raise NotImplementedError("additional output layer sets")
        nb = 1
        while (1 << nb) < n_ptl:
            nb += 1
        r.read(nb)          # profile_level_tier_idx
    if nl > 1:
        r.read1()           # alt_output_layer_flag
    rep_idx_present = r.read1()
    n_rep = (r.read(8) + 1) if rep_idx_present else nl
    reps = []
    for _ in range(n_rep):
        present = r.read1()
        w = r.read(16)
        h = r.read(16)
        cf, bd = 1, 8
        if present:
            cf = r.read(2)
            if cf == 3:
                r.read1()
            bd = r.read(4) + 8
            r.read(4)
        reps.append((w, h, cf, bd))
    v.rep_formats = tuple(reps)
    if rep_idx_present:
        v.rep_format_idx = tuple([0] + [
            (r.read(8) if n_rep > 1 else 0) for _ in range(1, nl)])
    else:
        v.rep_format_idx = tuple(range(nl))
    v.max_one_active_ref_layer = r.read1()
    for i in range(1, nl):
        if ndr[i] == 0:
            r.read1()       # poc_lsb_not_present
    v.phase_align = r.read1()
    # DPB size table
    n_sub_dpbs = [1] + [n_in_set[i] for i in range(1, n_ols)]
    for i in range(1, n_ols):
        sub_flag = r.read1()
        for j in range(v.max_sub_layers):
            present = 1 if j == 0 else (r.read1() if sub_flag else 0)
            if present:
                for _ in range(n_sub_dpbs[i]):
                    r.ue()
                r.ue(); r.ue()
    dep_len = r.ue() + 2
    if r.read1():           # default_direct_dependency_type_flag
        v.default_dep_type = r.read(dep_len)
    else:
        for i in range(1, nl):
            for j in range(i):
                pass        # per-dep types (writer uses default)
    # single_layer_for_non_irap, higher_layer_irap_skip, vps_vui
    r.read1(); r.read1()
    r.read1()


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    width: int = 0
    height: int = 0
    # conformance window crop (luma samples)
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    bit_depth: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: int = 5
    num_reorder_pics: int = 0
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    scaling_list: ScalingList | None = None
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    pcm_bit_depth: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_pcm_cb: int = 3
    log2_max_pcm_cb: int = 3
    pcm_loop_filter_disabled: int = 0
    st_rps: list = field(default_factory=list)
    long_term_ref_pics_present: int = 0
    lt_ref_poc_lsb: list = field(default_factory=list)
    lt_used_by_curr: list = field(default_factory=list)
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    ptl: ProfileTierLevel | None = None
    # Range extensions
    transform_skip_rotation_enabled: int = 0
    transform_skip_context_enabled: int = 0
    implicit_rdpcm_enabled: int = 0
    explicit_rdpcm_enabled: int = 0
    extended_precision: int = 0
    intra_smoothing_disabled: int = 0
    high_precision_offsets: int = 0
    persistent_rice_adaptation: int = 0
    cabac_bypass_alignment: int = 0
    # VUI timing (advisory; 0 = absent)
    num_units_in_tick: int = 0
    time_scale: int = 0
    max_sub_layers: int = 1
    # VUI sample aspect ratio (Table E-1; 0/1 = unspecified)
    sar_num: int = 0
    sar_den: int = 1

    # ---- derived ----
    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb

    @property
    def ctbs_w(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def ctbs_h(self) -> int:
        return -(-self.height // self.ctb_size)

    @property
    def min_cb_size(self) -> int:
        return 1 << self.log2_min_cb

    @property
    def hshift1(self) -> int:  # chroma horizontal subsample shift
        return 1 if self.chroma_format_idc in (1, 2) else 0

    @property
    def vshift1(self) -> int:
        return 1 if self.chroma_format_idc == 1 else 0

    @property
    def qp_bd_offset(self) -> int:
        return 6 * (self.bit_depth - 8)


def parse_sps(rbsp: bytes, layer_id: int = 0, vps: VPS | None = None) -> SPS:
    """layer_id > 0 (SHVC EL): no sub-layers/PTL/geometry/bit-depth
    fields — inherited from the VPS rep format (ff_hevc_decode_nal_sps,
    hevc_ps.c:1556-1722)."""
    r = BitReader(rbsp)
    s = SPS()
    s.vps_id = r.read(4)
    if layer_id == 0:
        max_sub_layers_minus1 = r.read(3)
        r.read1()  # sps_temporal_id_nesting_flag
        s.ptl = parse_ptl(r, max_sub_layers_minus1)
    else:
        max_sub_layers_minus1 = (vps.max_sub_layers - 1) if vps else 0
    s.max_sub_layers = max_sub_layers_minus1 + 1
    s.sps_id = r.ue()
    if layer_id > 0:
        update_rep = r.read1()
        rep_idx = r.read(8) if update_rep else \
            (vps.rep_format_idx[layer_id] if vps else 0)
        w, h, cf, bd = vps.rep_formats[rep_idx]
        s.width, s.height = w, h
        s.chroma_format_idc = cf
        s.bit_depth = s.bit_depth_chroma = bd
        if r.read1():  # conformance_window_flag
            sub_w = 2 if cf in (1, 2) else 1
            sub_h = 2 if cf == 1 else 1
            s.crop_left = r.ue() * sub_w
            s.crop_right = r.ue() * sub_w
            s.crop_top = r.ue() * sub_h
            s.crop_bottom = r.ue() * sub_h
        s.log2_max_poc_lsb = r.ue() + 4
        return _parse_sps_common(r, s, max_sub_layers_minus1, layer_id)
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        s.separate_colour_plane = r.read1()
    s.width = r.ue()
    s.height = r.ue()
    if r.read1():  # conformance_window_flag
        sub_w = 2 if s.chroma_format_idc in (1, 2) else 1
        sub_h = 2 if s.chroma_format_idc == 1 else 1
        s.crop_left = r.ue() * sub_w
        s.crop_right = r.ue() * sub_w
        s.crop_top = r.ue() * sub_h
        s.crop_bottom = r.ue() * sub_h
    s.bit_depth = r.ue() + 8
    s.bit_depth_chroma = r.ue() + 8
    s.log2_max_poc_lsb = r.ue() + 4
    return _parse_sps_common(r, s, max_sub_layers_minus1, 0)


def _parse_sps_common(r: BitReader, s: SPS, max_sub_layers_minus1: int,
                      layer_id: int) -> SPS:
    """SPS fields shared by BL and SHVC EL from
    sps_sub_layer_ordering_info onward."""
    sub_layer_ordering = r.read1()
    for i in range((0 if sub_layer_ordering else max_sub_layers_minus1),
                   max_sub_layers_minus1 + 1):
        s.max_dec_pic_buffering = r.ue() + 1
        s.num_reorder_pics = r.ue()
        r.ue()  # max_latency_increase_plus1
    s.log2_min_cb = r.ue() + 3
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = r.ue() + 2
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = r.read1()
    if s.scaling_list_enabled:
        if layer_id > 0 and r.read1():  # sps_infer_scaling_list_flag
            r.ue()                     # sps_scaling_list_ref_layer_id
            s.scaling_list_enabled = 0
        elif r.read1():  # sps_scaling_list_data_present_flag
            s.scaling_list = parse_scaling_list(r)
        else:
            s.scaling_list = ScalingList()  # defaults
    s.amp_enabled = r.read1()
    s.sao_enabled = r.read1()
    s.pcm_enabled = r.read1()
    if s.pcm_enabled:
        s.pcm_bit_depth = r.read(4) + 1
        s.pcm_bit_depth_chroma = r.read(4) + 1
        s.log2_min_pcm_cb = r.ue() + 3
        s.log2_max_pcm_cb = s.log2_min_pcm_cb + r.ue()
        s.pcm_loop_filter_disabled = r.read1()
    num_st_rps = r.ue()
    for i in range(num_st_rps):
        s.st_rps.append(parse_st_rps(r, s, i, num_st_rps))
    s.long_term_ref_pics_present = r.read1()
    if s.long_term_ref_pics_present:
        n = r.ue()
        for _ in range(n):
            s.lt_ref_poc_lsb.append(r.read(s.log2_max_poc_lsb))
            s.lt_used_by_curr.append(r.read1())
    s.temporal_mvp_enabled = r.read1()
    s.strong_intra_smoothing = r.read1()
    if r.read1():  # vui_parameters_present_flag
        _skip_vui(r, s)
    if r.read1():  # sps_extension_present_flag
        # 1-bit sps_range_extension_flag + 7 reserved ext bits, then the
        # RExt flag block (hevc_ps.c:1921-1927)
        range_ext = r.read1()
        r.read(7)
        if range_ext:
            s.transform_skip_rotation_enabled = r.read1()
            s.transform_skip_context_enabled = r.read1()
            s.implicit_rdpcm_enabled = r.read1()
            s.explicit_rdpcm_enabled = r.read1()
            s.extended_precision = r.read1()
            s.intra_smoothing_disabled = r.read1()
            s.high_precision_offsets = r.read1()
            s.persistent_rice_adaptation = r.read1()
            s.cabac_bypass_alignment = r.read1()
            if s.cabac_bypass_alignment:
                from ..utils.log import log, WARNING
                # parity: the reference decoder does not implement the
                # aligned-bypass engine either (hevc_ps.c:1955-1959)
                log(WARNING, "cabac_bypass_alignment_enabled_flag not "
                    "implemented (matches reference)")
    return s


_SAR_TABLE = [(0, 1), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33),
              (24, 11), (20, 11), (32, 11), (80, 33), (18, 11), (15, 11),
              (64, 33), (160, 99), (4, 3), (3, 2), (2, 1)]


def _skip_vui(r: BitReader, s: SPS):
    """7.3.2.2 VUI — parsed for bit-position correctness; timing and
    SAR are retained (the wrapper surfaces them in FrameInfo, matching
    openHevcWrapper.c:171-243's frameRate/sample_aspect_ratio)."""
    if r.read1():  # aspect_ratio_info_present
        idc = r.read(8)
        if idc == 255:
            s.sar_num = r.read(16)
            s.sar_den = r.read(16)
        elif idc < len(_SAR_TABLE):
            s.sar_num, s.sar_den = _SAR_TABLE[idc]
    if r.read1():  # overscan_info_present
        r.read1()
    if r.read1():  # video_signal_type_present
        r.read(3)
        r.read1()
        if r.read1():  # colour_description_present
            r.read(24)
    if r.read1():  # chroma_loc_info_present
        r.ue()
        r.ue()
    r.read(3)  # neutral_chroma + field_seq + frame_field_info
    if r.read1():  # default_display_window
        r.ue(), r.ue(), r.ue(), r.ue()
    if r.read1():  # vui_timing_info_present
        s.num_units_in_tick = r.read(32)
        s.time_scale = r.read(32)
        if r.read1():  # poc_proportional_to_timing
            r.ue()     # num_ticks_poc_diff_one_minus1
        if r.read1():  # vui_hrd_parameters_present
            _parse_hrd(r, 1, s.max_sub_layers - 1)
    if r.read1():  # bitstream_restriction
        r.read(3)
        r.ue(), r.ue(), r.ue(), r.ue(), r.ue()


def _parse_hrd(r: BitReader, common_inf: int, max_sub_layers_minus1: int):
    """7.3.2.11 hrd_parameters — skip-correct parse so streams carrying
    HRD info decode (mirrors decode_hrd, hevc_ps.c:269-343; values are
    advisory for a decoder and dropped)."""
    nal_hrd = vcl_hrd = sub_pic = 0
    if common_inf:
        nal_hrd = r.read1()
        vcl_hrd = r.read1()
        if nal_hrd or vcl_hrd:
            sub_pic = r.read1()
            if sub_pic:
                r.read(8)   # tick_divisor_minus2
                r.read(5)   # du_cpb_removal_delay_increment_length_minus1
                r.read1()   # sub_pic_cpb_params_in_pic_timing_sei
                r.read(5)   # dpb_output_delay_du_length_minus1
            r.read(4)       # bit_rate_scale
            r.read(4)       # cpb_size_scale
            if sub_pic:
                r.read(4)   # cpb_size_du_scale
            r.read(5)       # initial_cpb_removal_delay_length_minus1
            r.read(5)       # au_cpb_removal_delay_length_minus1
            r.read(5)       # dpb_output_delay_length_minus1
    for _ in range(max_sub_layers_minus1 + 1):
        low_delay = 0
        nb_cpb = 1
        fixed_rate = r.read1()          # fixed_pic_rate_general
        if not fixed_rate:
            fixed_rate = r.read1()      # fixed_pic_rate_within_cvs
        if fixed_rate:
            r.ue()                      # elemental_duration_in_tc_minus1
        else:
            low_delay = r.read1()
        if not low_delay:
            nb_cpb = r.ue() + 1
        for hrd_on in (nal_hrd, vcl_hrd):
            if hrd_on:
                for _ in range(nb_cpb):
                    r.ue()              # bit_rate_value_minus1
                    r.ue()              # cpb_size_value_minus1
                    if sub_pic:
                        r.ue()          # cpb_size_du_value_minus1
                        r.ue()          # bit_rate_du_value_minus1
                    r.read1()           # cbr_flag


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_l0_default: int = 1
    num_ref_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync: int = 0
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    col_widths: list = field(default_factory=list)   # in CTBs
    row_heights: list = field(default_factory=list)
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 1
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset: int = 0
    tc_offset: int = 0
    scaling_list: ScalingList | None = None
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_header_extension_present: int = 0
    # RExt
    log2_max_transform_skip_block_size: int = 2
    cross_component_prediction_enabled: int = 0
    chroma_qp_offset_list_enabled: int = 0
    diff_cu_chroma_qp_offset_depth: int = 0
    cb_qp_offset_list: list = field(default_factory=list)
    cr_qp_offset_list: list = field(default_factory=list)
    log2_sao_offset_scale_luma: int = 0
    log2_sao_offset_scale_chroma: int = 0


def parse_pps(rbsp: bytes, layer_id: int = 0) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    p.dependent_slice_segments = r.read1()
    p.output_flag_present = r.read1()
    p.num_extra_slice_header_bits = r.read(3)
    p.sign_data_hiding = r.read1()
    p.cabac_init_present = r.read1()
    p.num_ref_l0_default = r.ue() + 1
    p.num_ref_l1_default = r.ue() + 1
    p.init_qp = r.se() + 26
    p.constrained_intra_pred = r.read1()
    p.transform_skip_enabled = r.read1()
    p.cu_qp_delta_enabled = r.read1()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = r.read1()
    p.weighted_pred = r.read1()
    p.weighted_bipred = r.read1()
    p.transquant_bypass_enabled = r.read1()
    p.tiles_enabled = r.read1()
    p.entropy_coding_sync = r.read1()
    if p.tiles_enabled:
        p.num_tile_cols = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.uniform_spacing = r.read1()
        if not p.uniform_spacing:
            p.col_widths = [r.ue() + 1 for _ in range(p.num_tile_cols - 1)]
            p.row_heights = [r.ue() + 1 for _ in range(p.num_tile_rows - 1)]
        p.loop_filter_across_tiles = r.read1()
    p.loop_filter_across_slices = r.read1()
    p.deblocking_filter_control_present = r.read1()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = r.read1()
        p.deblocking_filter_disabled = r.read1()
        if not p.deblocking_filter_disabled:
            p.beta_offset = r.se() * 2
            p.tc_offset = r.se() * 2
    if layer_id > 0 and r.read1():  # pps_infer_scaling_list_flag
        r.ue()                          # pps_scaling_list_ref_layer_id
    elif r.read1():  # pps_scaling_list_data_present_flag
        p.scaling_list = parse_scaling_list(r)
    p.lists_modification_present = r.read1()
    p.log2_parallel_merge_level = r.ue() + 2
    p.slice_header_extension_present = r.read1()
    if r.read1():  # pps_extension_present_flag
        # range flag + 7 ext bits (hevc_ps.c:2421-2424); the reference
        # additionally gates on the RExt profile, which conformant
        # streams using these tools signal anyway
        range_ext = r.read1()
        r.read(7)
        if range_ext:
            if p.transform_skip_enabled:
                p.log2_max_transform_skip_block_size = r.ue() + 2
            p.cross_component_prediction_enabled = r.read1()
            p.chroma_qp_offset_list_enabled = r.read1()
            if p.chroma_qp_offset_list_enabled:
                p.diff_cu_chroma_qp_offset_depth = r.ue()
                n = r.ue() + 1
                for _ in range(n):
                    p.cb_qp_offset_list.append(r.se())
                    p.cr_qp_offset_list.append(r.se())
            p.log2_sao_offset_scale_luma = r.ue()
            p.log2_sao_offset_scale_chroma = r.ue()
    return p


def ctb_tile_maps(pps: PPS, sps: SPS):
    """CTB raster<->tile-scan maps + tile id per CTB (derivation mirrored
    from the PPS map construction in hevc_ps.c:2305-2341)."""
    cw, ch = sps.ctbs_w, sps.ctbs_h
    cols, rows = tile_layout(pps, sps)
    col_bd = np.cumsum([0] + cols)
    row_bd = np.cumsum([0] + rows)
    tile_id = np.zeros((ch, cw), np.int32)
    ts_order = []
    tid = 0
    for tr in range(len(rows)):
        for tc in range(len(cols)):
            for y in range(row_bd[tr], row_bd[tr + 1]):
                for x in range(col_bd[tc], col_bd[tc + 1]):
                    ts_order.append(y * cw + x)
                    tile_id[y, x] = tid
            tid += 1
    ts_order = np.array(ts_order, np.int32)       # ts index -> rs
    rs_to_ts = np.zeros(cw * ch, np.int32)
    rs_to_ts[ts_order] = np.arange(cw * ch)
    tile_width = np.array([cols[c] for c in range(len(cols))])
    return rs_to_ts, ts_order, tile_id, col_bd, row_bd


def tile_layout(pps: PPS, sps: SPS):
    """Column/row boundaries in CTBs (derivation 6-3/6-4)."""
    cw, ch = sps.ctbs_w, sps.ctbs_h
    if not pps.tiles_enabled:
        return [cw], [ch]
    nc, nr = pps.num_tile_cols, pps.num_tile_rows
    if pps.uniform_spacing:
        cols = [(i + 1) * cw // nc - i * cw // nc for i in range(nc)]
        rows = [(i + 1) * ch // nr - i * ch // nr for i in range(nr)]
    else:
        cols = pps.col_widths + [cw - sum(pps.col_widths)]
        rows = pps.row_heights + [ch - sum(pps.row_heights)]
    return cols, rows
