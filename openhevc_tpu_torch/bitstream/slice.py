"""Slice segment header parsing (H.265 7.3.6; parity: hls_slice_header,
hevc.c:520)."""
from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader
from .ps import SPS, PPS, ShortTermRPS, parse_st_rps

NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21

B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


def is_irap(nal_type: int) -> bool:
    return 16 <= nal_type <= 23
def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


@dataclass
class SliceHeader:
    first_slice: int = 1
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent: int = 0
    segment_address: int = 0
    slice_type: int = I_SLICE
    pic_output_flag: int = 1
    colour_plane_id: int = 0
    poc_lsb: int = 0
    st_rps: ShortTermRPS | None = None
    st_rps_sps_idx: int = -1
    lt_poc: list = field(default_factory=list)
    lt_used: list = field(default_factory=list)
    lt_msb_present: list = field(default_factory=list)
    temporal_mvp: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx: tuple = (0, 0)
    list_mod_l0: list | None = None
    list_mod_l1: list | None = None
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_list: int = 0      # 0: from l0... stores collocated_from_l0
    collocated_ref_idx: int = 0
    max_num_merge_cand: int = 5
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    cu_chroma_qp_offset_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset: int = 0
    tc_offset: int = 0
    loop_filter_across_slices: int = 1
    num_entry_points: int = 0
    entry_point_offsets: list = field(default_factory=list)
    data_start_byte: int = 0      # byte offset of slice data in the RBSP
    weighted_pred_table: object = None
    inter_layer_pred: int = 0     # SHVC EL (hevc.c:808)


def parse_slice_header(rbsp: bytes, nal_type: int, sps: SPS,
                       pps: PPS, layer_id: int = 0,
                       num_direct_ref_layers: int = 0) -> SliceHeader:
    r = BitReader(rbsp)
    sh = SliceHeader()
    sh.first_slice = r.read1()
    if is_irap(nal_type):
        sh.no_output_of_prior_pics = r.read1()
    sh.pps_id = r.ue()
    if not sh.first_slice:
        if pps.dependent_slice_segments:
            sh.dependent = r.read1()
        import math
        n_ctbs = sps.ctbs_w * sps.ctbs_h
        addr_bits = max(1, math.ceil(math.log2(n_ctbs)))
        sh.segment_address = r.read(addr_bits)
    if not sh.dependent:
        for _ in range(pps.num_extra_slice_header_bits):
            r.read1()
        sh.slice_type = r.ue()
        if pps.output_flag_present:
            sh.pic_output_flag = r.read1()
        if sps.separate_colour_plane:
            sh.colour_plane_id = r.read(2)
        if layer_id > 0 and is_idr(nal_type):
            # SHVC EL IDR carries pic_order_cnt_lsb (hevc.c:728)
            sh.poc_lsb = r.read(sps.log2_max_poc_lsb)
        if not is_idr(nal_type):
            sh.poc_lsb = r.read(sps.log2_max_poc_lsb)
            if not r.read1():  # short_term_ref_pic_set_sps_flag
                sh.st_rps = parse_st_rps(r, sps, len(sps.st_rps),
                                         len(sps.st_rps) + 1,
                                         in_slice_header=True)
            else:
                n = len(sps.st_rps)
                idx = 0
                if n > 1:
                    idx = r.read((n - 1).bit_length())
                sh.st_rps_sps_idx = idx
                sh.st_rps = sps.st_rps[idx]
            if sps.long_term_ref_pics_present:
                num_sps_lt = r.ue() if sps.lt_ref_poc_lsb else 0
                num_lt = r.ue()
                prev_delta_msb = 0
                for i in range(num_sps_lt + num_lt):
                    if i < num_sps_lt:
                        idx = 0
                        if len(sps.lt_ref_poc_lsb) > 1:
                            idx = r.read((len(sps.lt_ref_poc_lsb) - 1).bit_length())
                        sh.lt_poc.append(sps.lt_ref_poc_lsb[idx])
                        sh.lt_used.append(sps.lt_used_by_curr[idx])
                    else:
                        sh.lt_poc.append(r.read(sps.log2_max_poc_lsb))
                        sh.lt_used.append(r.read1())
                    if r.read1():  # delta_poc_msb_present_flag
                        d = r.ue()
                        # DeltaPocMsbCycleLt accumulates across slice-header
                        # entries (7.4.7.1; hevc.c decode_lt_rps :359)
                        if i and i != num_sps_lt:
                            d += prev_delta_msb
                        sh.lt_msb_present.append(d)
                        prev_delta_msb = d
                    else:
                        sh.lt_msb_present.append(None)
            if sps.temporal_mvp_enabled:
                sh.temporal_mvp = r.read1()
        # SHVC EL: inter_layer_pred block, all slice types (hevc.c:805-830;
        # with NumDirectRefLayers == 1 + max_one_active it is one flag)
        if layer_id > 0 and num_direct_ref_layers > 0:
            sh.inter_layer_pred = r.read1()
        if sps.sao_enabled:
            sh.sao_luma = r.read1()
            sh.sao_chroma = r.read1()
        if sh.slice_type in (P_SLICE, B_SLICE):
            n0, n1 = pps.num_ref_l0_default, pps.num_ref_l1_default
            if r.read1():  # num_ref_idx_active_override_flag
                n0 = r.ue() + 1
                if sh.slice_type == B_SLICE:
                    n1 = r.ue() + 1
            if sh.slice_type == P_SLICE:
                n1 = 0
            sh.num_ref_idx = (n0, n1)
            if pps.lists_modification_present:
                nb_refs = _num_pic_total_curr(sh, sps)
                if nb_refs > 1:
                    sh.list_mod_l0, sh.list_mod_l1 = _ref_list_mod(
                        r, sh, nb_refs)
            if sh.slice_type == B_SLICE:
                sh.mvd_l1_zero = r.read1()
            if pps.cabac_init_present:
                sh.cabac_init_flag = r.read1()
            if sh.temporal_mvp:
                sh.collocated_list = 1
                if sh.slice_type == B_SLICE:
                    sh.collocated_list = r.read1()
                nref = sh.num_ref_idx[0 if sh.collocated_list else 1]
                if nref > 1:
                    sh.collocated_ref_idx = r.ue()
            if ((pps.weighted_pred and sh.slice_type == P_SLICE) or
                    (pps.weighted_bipred and sh.slice_type == B_SLICE)):
                sh.weighted_pred_table = _parse_pred_weight_table(r, sh, sps)
            sh.max_num_merge_cand = 5 - r.ue()
        sh.qp = pps.init_qp + r.se()
        if pps.slice_chroma_qp_offsets_present:
            sh.cb_qp_offset = r.se()
            sh.cr_qp_offset = r.se()
        if pps.chroma_qp_offset_list_enabled:
            sh.cu_chroma_qp_offset_enabled = r.read1()
        deblock_override = 0
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                deblock_override = r.read1()
            if deblock_override:
                sh.deblocking_filter_disabled = r.read1()
                if not sh.deblocking_filter_disabled:
                    sh.beta_offset = r.se() * 2
                    sh.tc_offset = r.se() * 2
            else:
                sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
                sh.beta_offset = pps.beta_offset
                sh.tc_offset = pps.tc_offset
        sh.loop_filter_across_slices = pps.loop_filter_across_slices
        if pps.loop_filter_across_slices and (
                sh.sao_luma or sh.sao_chroma or
                not sh.deblocking_filter_disabled):
            sh.loop_filter_across_slices = r.read1()
    if pps.tiles_enabled or pps.entropy_coding_sync:
        sh.num_entry_points = r.ue()
        if sh.num_entry_points > 0:
            ep_bits = r.ue() + 1
            sh.entry_point_offsets = [r.read(ep_bits) + 1
                                      for _ in range(sh.num_entry_points)]
    if pps.slice_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.read(8)
    # byte_alignment()
    one = r.read1()
    assert one == 1, "slice header alignment bit"
    r.align()
    sh.data_start_byte = r.pos // 8
    return sh


def _num_pic_total_curr(sh: SliceHeader, sps: SPS) -> int:
    n = 0
    if sh.st_rps:
        n += sum(sh.st_rps.used)
    n += sum(sh.lt_used)
    return n


def _ref_list_mod(r: BitReader, sh: SliceHeader, nb_refs: int):
    import math
    bits = math.ceil(math.log2(nb_refs))
    l0 = l1 = None
    if r.read1():  # ref_pic_list_modification_flag_l0
        l0 = [r.read(bits) for _ in range(sh.num_ref_idx[0])]
    if sh.slice_type == B_SLICE and r.read1():
        l1 = [r.read(bits) for _ in range(sh.num_ref_idx[1])]
    return l0, l1


def _parse_pred_weight_table(r: BitReader, sh: SliceHeader, sps: SPS):
    """7.3.6.3 pred_weight_table (values resolved for weighted MC)."""
    table = {"luma_log2_denom": r.ue()}
    if sps.chroma_format_idc != 0:
        table["chroma_log2_denom"] = table["luma_log2_denom"] + r.se()
    for lx, nref in (("l0", sh.num_ref_idx[0]), ("l1", sh.num_ref_idx[1])):
        if lx == "l1" and sh.slice_type != B_SLICE:
            break
        luma_flags = [r.read1() for _ in range(nref)]
        chroma_flags = ([r.read1() for _ in range(nref)]
                        if sps.chroma_format_idc != 0 else [0] * nref)
        entries = []
        for i in range(nref):
            lw = 1 << table["luma_log2_denom"]
            lo = 0
            if luma_flags[i]:
                lw = (1 << table["luma_log2_denom"]) + r.se()
                lo = r.se()
            cw = [1 << table.get("chroma_log2_denom", 0)] * 2
            co = [0, 0]
            if chroma_flags[i]:
                for j in range(2):
                    cw[j] = (1 << table["chroma_log2_denom"]) + r.se()
                    delta = r.se()
                    # wpOffsetHalfRangeC = 128 without high-precision
                    # offsets (pred_weight_table, hevc.c:262-266)
                    co[j] = max(-128, min(127,
                                delta - ((128 * cw[j]) >>
                                         table["chroma_log2_denom"]) + 128))
            entries.append((lw, lo, cw, co))
        table[lx] = entries
    return table
