"""ctypes bridge to the native host parse core (native/hevcparse.cc,
built at first use into build/native/libhevcparse.so).

Drop-in replacement for the Python SliceDataParser: produces the same
FrameSymbols. The Python parser remains the correctness mirror; tests
cross-check both on every conformance stream.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..symbols import FrameSymbols, PcmBlock
from .syntax import zscan_grid
from .mvs import MotionContext

from ..buildutil import BUILD_DIR, PKG_DIR, build_once

_NATIVE_DIR = os.path.join(PKG_DIR, "native")
_LIB_PATH = os.path.join(BUILD_DIR, "native", "libhevcparse.so")
_CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
             "-std=c++17", "-Wall", "-pthread"]
_lib = None


def _round_fine(n, base):
    """1/16-octave bucket: round up to a multiple of 2^(floor(log2 n)-4)
    (min `base`); mirrors round_fine in native/hevcparse.cc."""
    if n <= base:
        return base
    step = 1 << max((n - 1).bit_length() - 5, 0)
    return -(-n // step) * step


def _bucket(n: int) -> int:
    """Intra meta width bucket (the native packer's npad)."""
    return _round_fine(n, 1024)


class _SliceParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "width", "height", "log2_ctb", "log2_min_cb", "log2_min_tb",
        "log2_max_tb", "max_trafo_depth_intra", "max_trafo_depth_inter",
        "bit_depth", "chroma_format_idc",
        "pcm_enabled", "pcm_bd", "pcm_bd_c", "log2_min_pcm", "log2_max_pcm",
        "amp_enabled", "strong_intra_smoothing", "intra_smoothing_disabled",
        "sign_data_hiding", "cabac_init_present",
        "cb_qp_offset", "cr_qp_offset", "slice_cb_qp_offset",
        "slice_cr_qp_offset",
        "transquant_bypass_enabled", "transform_skip_enabled", "log2_max_ts",
        "constrained_intra_pred", "log2_parallel_merge",
        "implicit_rdpcm",
        "slice_type", "slice_qp", "cabac_init_flag", "max_merge_cand",
        "mvd_l1_zero", "num_ref0", "num_ref1")] + [
        ("ref_poc", ctypes.c_int32 * 32),
        ("ref_lt", ctypes.c_int32 * 32),
    ] + [(n, ctypes.c_int32) for n in (
        "cur_poc", "sao_enabled", "slice_sao_luma", "slice_sao_chroma",
        "data_start_byte", "qp_bd_offset", "tiles_enabled",
        "num_tile_cols", "num_tile_rows", "entropy_coding_sync",
        "num_substreams")] + [
        ("ss_start", ctypes.c_int32 * 128),
    ] + [(n, ctypes.c_int32) for n in (
        "temporal_mvp", "colloc_from_l0", "col_poc", "n_col_lt")] + [
        ("col_lt_poc", ctypes.c_int32 * 32),
        ("col_lt_flag", ctypes.c_int32 * 32),
    ] + [(n, ctypes.c_int32) for n in (
        "cu_qp_delta_enabled", "diff_cu_qp_delta_depth",
        "start_ts", "slice_no", "dependent",
        "ts_rotation", "explicit_rdpcm", "persistent_rice",
        "cross_component", "n_col_bd_in", "n_row_bd_in")] + [
        ("col_bd_in", ctypes.c_int32 * 25),
        ("row_bd_in", ctypes.c_int32 * 25),
    ] + [(n, ctypes.c_int32) for n in (
        "cu_chroma_qp_offset_enabled", "diff_cu_chroma_qp_offset_depth",
        "n_cqo_list")] + [
        ("cqo_cb", ctypes.c_int32 * 6),
        ("cqo_cr", ctypes.c_int32 * 6),
    ] + [("parse_threads", ctypes.c_int32)]


class _Outputs(ctypes.Structure):
    _fields_ = [
        ("ipm", ctypes.c_void_p), ("pred_mode", ctypes.c_void_p),
        ("is_pcm", ctypes.c_void_p), ("tqb", ctypes.c_void_p),
        ("cbf_luma4", ctypes.c_void_p), ("bounds_v", ctypes.c_void_p),
        ("bounds_h", ctypes.c_void_p), ("qp_y4", ctypes.c_void_p),
        ("mv_pf", ctypes.c_void_p), ("mv", ctypes.c_void_p),
        ("mv_poc", ctypes.c_void_p), ("mv_refidx", ctypes.c_void_p),
        ("sao", ctypes.c_void_p),
        ("cb_meta", ctypes.c_void_p), ("cb_levels", ctypes.c_void_p),
        ("ij_meta", ctypes.c_void_p), ("ij_avail", ctypes.c_void_p),
        ("pcm_meta", ctypes.c_void_p), ("pcm_samples", ctypes.c_void_p),
        ("pb", ctypes.c_void_p),
        ("cb_cap", ctypes.c_int32), ("lvl_cap", ctypes.c_int32),
        ("ij_cap", ctypes.c_int32), ("pcm_cap", ctypes.c_int32),
        ("pcm_arena_cap", ctypes.c_int32), ("pb_cap", ctypes.c_int32),
        ("n_cb", ctypes.c_int32), ("n_ij", ctypes.c_int32),
        ("n_pcm", ctypes.c_int32), ("n_pb", ctypes.c_int32),
        ("lvl_used", ctypes.c_int32), ("pcm_used", ctypes.c_int32),
        ("error", ctypes.c_int32),
        ("threads", ctypes.c_int32), ("fallback", ctypes.c_int32),
        ("wave_wait_us", ctypes.c_int64),
    ]


def ensure_built():
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, "hevcparse.cc")
    build_once(_LIB_PATH, [src, os.path.join(_NATIVE_DIR, "tables.inc")],
               lambda out: [os.environ.get("CXX", "g++"), *_CXXFLAGS, src,
                            "-o", out])
    _lib = ctypes.CDLL(_LIB_PATH)
    _lib.hevc_parse_slice.restype = ctypes.c_int
    _lib.hevc_parse_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(_SliceParams), ctypes.POINTER(_Outputs),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # TMVP col grids
    _lib.hevc_parse_picture.restype = ctypes.c_int
    _lib.hevc_parse_picture.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(_SliceParams),
        ctypes.POINTER(_Outputs),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib.hevc_pack_frame.restype = ctypes.c_int
    _lib.hevc_pack_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,   # cb_meta/levels
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,   # ij meta/avail
        ctypes.c_int32,                                     # strong smooth
        ctypes.c_void_p, ctypes.c_int32,                    # arena8
        ctypes.c_void_p, ctypes.c_int32,                    # arena16
        ctypes.c_void_p, ctypes.c_int32,                    # esc
        ctypes.c_void_p, ctypes.c_int32,                    # meta
        ctypes.c_void_p, ctypes.c_void_p]                   # caps/used
    return _lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _pack_native(lib, o, cb_meta, cb_levels, ij_meta, ij_avail, sps):
    """Call hevc_pack_frame: per-size residual payload arena (v2
    scan-prefix nibble/byte format, 4-int16-per-block sideband) +
    [5, npad] intra meta in the JAX package's _frame_fused upload layout
    (no scaling lists). The port adds each job's wavefront level
    (ij_meta column 6) as a sixth row of the same buffer: `meta` is the
    first five rows, `meta6` all six; `n_levels` is the highest level."""
    # worst case payload: one byte per level cell (byte mode)
    a4 = np.empty(o.lvl_used + 64, np.uint8)
    a16 = np.empty(4 * (o.n_cb + o.n_cb // 2) + 4 * 4 * 528 + 16,
                   np.int16)
    npad = _bucket(int(o.n_ij))
    meta = np.empty(6 * npad, np.int16)
    caps = np.zeros(16, np.int32)
    used = np.zeros(4, np.int32)
    esc_cap = 65536
    while True:
        esc = np.empty(esc_cap, np.int32)
        rc = lib.hevc_pack_frame(
            _ptr(cb_meta), o.n_cb, _ptr(cb_levels),
            _ptr(ij_meta), _ptr(ij_avail), o.n_ij,
            1 if sps.strong_intra_smoothing else 0,
            _ptr(a4), a4.size, _ptr(a16), a16.size,
            _ptr(esc), esc_cap, _ptr(meta), 5 * npad,
            _ptr(caps), _ptr(used))
        if rc == 0:
            break
        if esc_cap > (o.lvl_used + 1) * 4:
            raise ValueError("native frame pack failed")
        esc_cap *= 8
    # tail-pad the payload to the same 1/16-octave byte bucket as
    # _pack_arena (the arena LENGTH is part of the static jit layout)
    pay = np.zeros(_round_fine(max(int(used[0]), 1), 4096), np.uint8)
    pay[:used[0]] = a4[:used[0]]
    n = int(o.n_ij)
    meta6 = meta.reshape(6, npad)
    level = ij_meta[6:n * 8:8]
    if n and not 1 <= int(level.min()) <= int(level.max()) <= 32767:
        raise ValueError("intra job levels outside 1..32767")
    meta6[5, :n] = level
    meta6[5, n:] = 0
    return dict(
        arena4=pay,
        arena16=a16[:used[1]] if used[1] else np.zeros(1, np.int16),
        esc=esc[:used[2]] if used[2] else np.zeros(2, np.int32),
        caps=tuple(tuple(int(v) for v in caps[i * 4:(i + 1) * 4])
                   for i in range(4)),
        meta=meta6[:5],
        meta6=meta6,
        n=n,
        n_levels=int(level.max()) if n else 0)


def parse_slice_native(rbsp: bytes, sps, pps, sh, nal_type: int, poc: int,
                       ref_list=None, ss_starts=None,
                       col_motion=None, parse_threads=0) -> FrameSymbols:
    """Single-slice picture parse (threaded WPP/tile substreams when
    ss_starts given). col_motion: (col_poc, pred_flag4, mv4, refpoc4,
    lt_map) of the collocated picture when sh.temporal_mvp.
    parse_threads: per-decoder substream worker count (0 = auto)."""
    return _parse_native([(rbsp, sh, 0, 0)], sps, pps, nal_type, poc,
                         ref_list, ss_starts, col_motion,
                         parse_threads=parse_threads)


def parse_picture_native(segments, sps, pps, nal_type: int, poc: int,
                         ref_list=None, col_motion=None,
                         parse_threads=0) -> FrameSymbols:
    """Multi-slice picture parse: segments = [(rbsp, sh, start_ts,
    slice_no), ...] in decode order (dependent segments carry sh.dependent
    set; CABAC/QP state chains inside hevc_parse_picture)."""
    return _parse_native(segments, sps, pps, nal_type, poc, ref_list,
                         None, col_motion, parse_threads=parse_threads)


def _fill_params(p, sps, pps, sh, poc, ref_list, ss_starts,
                 start_ts, slice_no):
    p.width, p.height = sps.width, sps.height
    p.log2_ctb, p.log2_min_cb = sps.log2_ctb, sps.log2_min_cb
    p.log2_min_tb, p.log2_max_tb = sps.log2_min_tb, sps.log2_max_tb
    p.max_trafo_depth_intra = sps.max_transform_hierarchy_depth_intra
    p.max_trafo_depth_inter = sps.max_transform_hierarchy_depth_inter
    p.bit_depth = sps.bit_depth
    p.chroma_format_idc = sps.chroma_format_idc
    p.pcm_enabled = sps.pcm_enabled
    p.pcm_bd, p.pcm_bd_c = sps.pcm_bit_depth, sps.pcm_bit_depth_chroma
    p.log2_min_pcm, p.log2_max_pcm = sps.log2_min_pcm_cb, sps.log2_max_pcm_cb
    p.amp_enabled = sps.amp_enabled
    p.strong_intra_smoothing = sps.strong_intra_smoothing
    p.intra_smoothing_disabled = getattr(sps, "intra_smoothing_disabled", 0)
    p.sign_data_hiding = pps.sign_data_hiding
    p.cabac_init_present = pps.cabac_init_present
    p.cb_qp_offset, p.cr_qp_offset = pps.cb_qp_offset, pps.cr_qp_offset
    p.slice_cb_qp_offset = sh.cb_qp_offset
    p.slice_cr_qp_offset = sh.cr_qp_offset
    p.transquant_bypass_enabled = pps.transquant_bypass_enabled
    p.transform_skip_enabled = pps.transform_skip_enabled
    p.log2_max_ts = pps.log2_max_transform_skip_block_size
    p.constrained_intra_pred = pps.constrained_intra_pred
    p.log2_parallel_merge = pps.log2_parallel_merge_level
    p.cu_qp_delta_enabled = pps.cu_qp_delta_enabled
    p.diff_cu_qp_delta_depth = pps.diff_cu_qp_delta_depth
    p.implicit_rdpcm = getattr(sps, "implicit_rdpcm_enabled", 0)
    p.ts_rotation = getattr(sps, "transform_skip_rotation_enabled", 0)
    p.explicit_rdpcm = getattr(sps, "explicit_rdpcm_enabled", 0)
    p.persistent_rice = getattr(sps, "persistent_rice_adaptation", 0)
    p.cross_component = getattr(
        pps, "cross_component_prediction_enabled", 0)
    p.cu_chroma_qp_offset_enabled = getattr(
        sh, "cu_chroma_qp_offset_enabled", 0)
    p.diff_cu_chroma_qp_offset_depth = getattr(
        pps, "diff_cu_chroma_qp_offset_depth", 0)
    cbl = tuple(getattr(pps, "cb_qp_offset_list", ()) or ())
    crl = tuple(getattr(pps, "cr_qp_offset_list", ()) or ())
    p.n_cqo_list = len(cbl)
    for i, v in enumerate(cbl[:6]):
        p.cqo_cb[i] = int(v)
    for i, v in enumerate(crl[:6]):
        p.cqo_cr[i] = int(v)
    p.slice_type = sh.slice_type
    p.slice_qp = sh.qp
    p.cabac_init_flag = sh.cabac_init_flag
    p.max_merge_cand = sh.max_num_merge_cand
    p.mvd_l1_zero = sh.mvd_l1_zero
    p.num_ref0 = len(ref_list[0])
    p.num_ref1 = len(ref_list[1])
    for lx in range(2):
        for i, (rp, lt) in enumerate(ref_list[lx][:16]):
            p.ref_poc[lx * 16 + i] = rp
            p.ref_lt[lx * 16 + i] = 1 if lt else 0
    p.cur_poc = poc
    p.sao_enabled = sps.sao_enabled
    p.slice_sao_luma = sh.sao_luma
    p.slice_sao_chroma = sh.sao_chroma
    p.data_start_byte = sh.data_start_byte
    p.qp_bd_offset = sps.qp_bd_offset
    p.tiles_enabled = pps.tiles_enabled
    p.num_tile_cols = pps.num_tile_cols
    p.num_tile_rows = pps.num_tile_rows
    if pps.tiles_enabled:
        # explicit boundaries cover non-uniform spacing (6-3/6-4)
        from .ps import tile_layout
        cols, rows = tile_layout(pps, sps)
        if len(cols) <= 24 and len(rows) <= 24:
            cb = [0]
            for w in cols:
                cb.append(cb[-1] + w)
            rb = [0]
            for h in rows:
                rb.append(rb[-1] + h)
            p.n_col_bd_in = len(cb)
            p.n_row_bd_in = len(rb)
            for i, v in enumerate(cb):
                p.col_bd_in[i] = v
            for i, v in enumerate(rb):
                p.row_bd_in[i] = v
    p.entropy_coding_sync = pps.entropy_coding_sync
    p.start_ts = start_ts
    p.slice_no = slice_no
    p.dependent = 1 if sh.dependent else 0
    if ss_starts and len(ss_starts) <= 128:
        p.num_substreams = len(ss_starts)
        for i, ss in enumerate(ss_starts):
            p.ss_start[i] = ss
    else:
        p.num_substreams = 0


def _parse_native(segments, sps, pps, nal_type, poc, ref_list, ss_starts,
                  col_motion, parse_threads=0) -> FrameSymbols:
    lib = ensure_built()
    ref_list = ref_list or [[], []]
    rbsp, sh = segments[0][0], segments[0][1]
    w4 = (sps.ctbs_w << sps.log2_ctb) >> 2
    h4 = (sps.ctbs_h << sps.log2_ctb) >> 2
    ng = h4 * w4

    n_seg = len(segments)
    params = (_SliceParams * n_seg)()
    for i, (seg_rbsp, seg_sh, start_ts, slice_no) in enumerate(segments):
        _fill_params(params[i], sps, pps, seg_sh, poc, ref_list,
                     ss_starts if (i == 0 and n_seg == 1) else None,
                     start_ts, slice_no)
        params[i].parse_threads = int(parse_threads)
    # TMVP collocated motion (hevc_mvs.c:227 inputs)
    col_pf_arr = col_mv_arr = col_rp_arr = None
    if sh.temporal_mvp and col_motion is not None:
        cpoc, cpf, cmv, crp = col_motion[:4]
        lt_map = col_motion[4] if len(col_motion) > 4 else {}
        items = list(lt_map.items())[:32]
        for i, (seg_rbsp, seg_sh, start_ts, slice_no) in enumerate(segments):
            if not seg_sh.temporal_mvp:
                continue
            p = params[i]
            p.temporal_mvp = 1
            p.colloc_from_l0 = int(seg_sh.collocated_list)
            p.col_poc = cpoc
            p.n_col_lt = len(items)
            for j, (rp, lt) in enumerate(items):
                p.col_lt_poc[j] = int(rp)
                p.col_lt_flag[j] = 1 if lt else 0
        col_pf_arr = np.ascontiguousarray(cpf, np.uint8)
        col_mv_arr = np.ascontiguousarray(cmv, np.int32)
        col_rp_arr = np.ascontiguousarray(crp, np.int32)

    # output arenas (numpy-owned; the native core initializes every grid
    # at parse entry, so np.empty throughout)
    g = {n: np.empty(ng, np.uint8) for n in
         ("ipm", "pred_mode", "is_pcm", "tqb", "cbf_luma4",
          "bounds_v", "bounds_h", "mv_pf")}
    qp_y4 = np.empty(ng, np.int8)
    mv = np.empty(ng * 4, np.int32)
    mv_poc = np.empty(ng * 2, np.int32)
    mv_refidx = np.empty(ng * 2, np.int8)
    sao = np.empty(sps.ctbs_h * sps.ctbs_w * 18, np.int16)
    n_pix = sps.width * sps.height
    # arena capacity scales with the chroma format: luma contributes up
    # to n_pix coefficient slots / ng 4x4 TBs, chroma another 0.5x (420),
    # 1x (422) or 2x (444) of that
    cmul = {0: 1, 1: 2, 2: 3, 3: 4}[sps.chroma_format_idc]
    cb_cap = max(1024, ng * cmul)
    lvl_cap = max(1 << 16, cmul * n_pix)
    ij_cap = cb_cap
    pcm_cap = max(256, ng // 4)
    pcm_arena = max(1 << 16, 2 * n_pix)
    pb_cap = max(256, ng)
    # np.empty: the used prefix of every arena is fully written by the
    # native core (records write all fields; levels/avail are memset per
    # block) — avoids ~8 MB/frame of calloc page-fault cost
    cb_meta = np.empty(cb_cap * 8, np.int32)
    cb_levels = np.empty(lvl_cap, np.int16)
    ij_meta = np.empty(ij_cap * 8, np.int32)
    ij_avail = np.empty(ij_cap * 132, np.uint8)
    pcm_meta = np.empty(pcm_cap * 3, np.int32)
    pcm_samples = np.empty(pcm_arena, np.uint16)
    pb = np.empty(pb_cap * 14, np.int32)

    o = _Outputs()
    for name, a in (("ipm", g["ipm"]), ("pred_mode", g["pred_mode"]),
                    ("is_pcm", g["is_pcm"]), ("tqb", g["tqb"]),
                    ("cbf_luma4", g["cbf_luma4"]),
                    ("bounds_v", g["bounds_v"]), ("bounds_h", g["bounds_h"]),
                    ("qp_y4", qp_y4), ("mv_pf", g["mv_pf"]), ("mv", mv),
                    ("mv_poc", mv_poc), ("mv_refidx", mv_refidx),
                    ("sao", sao), ("cb_meta", cb_meta),
                    ("cb_levels", cb_levels), ("ij_meta", ij_meta),
                    ("ij_avail", ij_avail), ("pcm_meta", pcm_meta),
                    ("pcm_samples", pcm_samples), ("pb", pb)):
        setattr(o, name, _ptr(a))
    o.cb_cap, o.lvl_cap = cb_cap, lvl_cap
    o.ij_cap, o.pcm_cap = ij_cap, pcm_cap
    o.pcm_arena_cap, o.pb_cap = pcm_arena, pb_cap

    cp = _ptr(col_pf_arr) if col_pf_arr is not None else None
    cm = _ptr(col_mv_arr) if col_mv_arr is not None else None
    cr = _ptr(col_rp_arr) if col_rp_arr is not None else None
    if n_seg == 1:
        rc = lib.hevc_parse_slice(rbsp, len(rbsp), ctypes.byref(params[0]),
                                  ctypes.byref(o), cp, cm, cr)
    else:
        bufs = [bytes(sg[0]) for sg in segments]
        rbsp_ptrs = (ctypes.c_char_p * n_seg)(*bufs)
        sizes = (ctypes.c_int64 * n_seg)(*[len(b) for b in bufs])
        rc = lib.hevc_parse_picture(n_seg, rbsp_ptrs, sizes, params,
                                    ctypes.byref(o), cp, cm, cr)
    if rc != 0 or o.error:
        raise ValueError("native slice parse failed")

    # ---- assemble FrameSymbols -------------------------------------------
    fs = FrameSymbols(sps=sps, pps=pps, poc=poc, slice_type=sh.slice_type,
                      slice_qp=sh.qp, nal_type=nal_type)
    fs.ipm = g["ipm"].reshape(h4, w4)
    fs.pred_mode = g["pred_mode"].reshape(h4, w4)
    fs.is_pcm = g["is_pcm"].reshape(h4, w4)
    fs.tqb = g["tqb"].reshape(h4, w4)
    fs.cbf_luma4 = g["cbf_luma4"].reshape(h4, w4)
    fs.bounds_v = g["bounds_v"].reshape(h4, w4)
    fs.bounds_h = g["bounds_h"].reshape(h4, w4)
    fs.qp_y4 = qp_y4.reshape(h4, w4)
    fs.sao = sao.reshape(sps.ctbs_h, sps.ctbs_w, 3, 6)
    fs.deblock_disabled = bool(sh.deblocking_filter_disabled)
    fs.beta_offset = sh.beta_offset
    fs.tc_offset = sh.tc_offset
    fs.sao_luma = bool(sh.sao_luma)
    fs.sao_chroma = bool(sh.sao_chroma)
    fs.ref_poc_l0 = [rp for rp, _ in ref_list[0]]
    fs.ref_poc_l1 = [rp for rp, _ in ref_list[1]]
    fs.weights = sh.weighted_pred_table   # reconstruction-side WP combine
    # the entry points handed over (1: none), the workers that parsed
    # them (1: serial), whether a failed threaded attempt left the
    # result to the serial re-parse, and the workers' summed wait on
    # the WPP row above
    fs.parse_stats = dict(substreams=max(int(params[0].num_substreams), 1),
                          threads=int(o.threads), fallback=int(o.fallback),
                          wave_wait_us=int(o.wave_wait_us))
    # CTB order (tile-scan) for the loop-filter schedule + tile-aware zscan
    if pps.tiles_enabled:
        from .ps import ctb_tile_maps
        rs_to_ts, ts_order, _tid, _cb, _rb = ctb_tile_maps(pps, sps)
        cs = 1 << sps.log2_ctb
        fs.ctb_order = [((int(r) % sps.ctbs_w) * cs,
                         (int(r) // sps.ctbs_w) * cs) for r in ts_order]
        zs = zscan_grid(sps, rs_to_ts)
    else:
        zs = zscan_grid(sps)
    # motion context view
    mc = MotionContext(sps, zs, poc, sh.slice_type,
                       sh.max_num_merge_cand, ref_list,
                       pps.log2_parallel_merge_level)
    mc.pred_flag = g["mv_pf"].reshape(h4, w4)
    mc.mv = mv.reshape(h4, w4, 2, 2)
    mc.refpoc = mv_poc.reshape(h4, w4, 2)
    mc.ref_idx = mv_refidx.reshape(h4, w4, 2)
    fs.motion = mc
    # per-TU objects stay lazy (fs.ensure_objects) — raw arrays suffice
    # for the vectorized device packing path
    fs.native_raw = dict(
        cb_meta=cb_meta[:o.n_cb * 8].reshape(-1, 8),
        cb_levels=cb_levels[:o.lvl_used],
        ij_meta=ij_meta[:o.n_ij * 8].reshape(-1, 8),
        ij_avail=ij_avail[:o.n_ij * 132].reshape(-1, 132),
        n_levels=int(ij_meta[6:o.n_ij * 8:8].max()) if o.n_ij else 0)
    # device-upload layouts packed natively (hevc_pack_frame) — the exact
    # arena8/arena16/esc/meta byte layout _frame_fused consumes; Python
    # packers (_res_buckets/_pack_arena/pack_meta) remain the mirror and
    # handle the scaling-list case
    from .ps import active_scaling_list
    if active_scaling_list(sps, pps) is None:
        fs.native_pack = _pack_native(lib, o, cb_meta, cb_levels, ij_meta,
                                      ij_avail, sps)
    # pcm
    off = 0
    hs, vs = sps.hshift1, sps.vshift1
    for i in range(o.n_pcm):
        m = pcm_meta[i * 3:(i + 1) * 3]
        cb = int(m[2])
        csz_h, csz_v = cb >> hs, cb >> vs
        ys = pcm_samples[off:off + cb * cb].astype(np.int32) \
            .reshape(cb, cb)
        off += cb * cb
        cbs = pcm_samples[off:off + csz_h * csz_v].astype(np.int32) \
            .reshape(csz_v, csz_h)
        off += csz_h * csz_v
        crs = pcm_samples[off:off + csz_h * csz_v].astype(np.int32) \
            .reshape(csz_v, csz_h)
        off += csz_h * csz_v
        fs.pcm_blocks.append(PcmBlock(int(m[0]), int(m[1]), cb,
                                      ys, cbs, crs))
    # inter pbs: lazy list over the flat [n_pb, 14] records — only the
    # np-engine oracle materializes InterPb objects
    from ..symbols import LazyPbList
    # copy: a view would pin the whole pb_cap arena for the fs lifetime
    fs.inter_pbs = LazyPbList(pb[:o.n_pb * 14].copy(), int(o.n_pb))
    return fs
