"""FrameSymbols — the host→device handoff contract.

The host parse core (bitstream/syntax.py in Python; native C++ later) emits
one FrameSymbols per coded picture: every syntax decision of the bitstream,
resolved into dense grids + per-TU job lists. Reconstruction engines (numpy
oracle in models/recon_np.py; JAX/Pallas pipeline in models/pipeline.py)
consume only this — they never touch the bitstream.

Mirrors the reference's flat sideband layout (tab_ipm / cbf_luma / tab_mvf /
qp_y_tab, hevc.h:1227-1241) which is already the tensor layout we want.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CoeffBlock:
    """One transform block's raw levels (post-parse, pre-dequant)."""
    plane: int            # 0=Y 1=Cb 2=Cr
    x: int                # plane coords (chroma coords for chroma planes)
    y: int
    log2_size: int
    qp: int               # final QP for dequant (incl. chroma mapping)
    is_dst: bool          # 4x4 intra luma -> DST
    transform_skip: bool
    transquant_bypass: bool
    rdpcm_mode: int       # -1 none, 0 horizontal, 1 vertical
    levels: np.ndarray    # int32 [s, s] raster order
    matrix_id: int = 0    # 3*(pred!=intra)+cIdx (hevc_cabac.c:1487-1489)
    cross_scale: int = 0  # RExt cross-component res_scale_val (hevc.c:1150)


@dataclass
class IntraJob:
    """One intra-predicted TB in decode order (prediction + residual add)."""
    plane: int
    x: int                # plane coords
    y: int
    size: int
    mode: int             # 0..34
    avail: np.ndarray     # bool [4*size+1], layout of ops/intra_np.py
    filter_refs: bool     # neighbour smoothing enabled for this TB


@dataclass
class PcmBlock:
    x: int                # luma coords
    y: int
    size: int
    samples_y: np.ndarray
    samples_cb: np.ndarray
    samples_cr: np.ndarray


@dataclass
class InterPb:
    """One inter prediction block (PU)."""
    x: int; y: int; w: int; h: int       # luma coords
    # per list: (valid, mvx, mvy, ref_dpb_slot) quarter-pel luma MVs
    l0: tuple | None
    l1: tuple | None
    r0: int = 0                          # ref_idx per list (weighted pred)
    r1: int = 0


class LazyPbList:
    """List-like view over the native parser's flat [N, 14] PB records.
    The device path only ever asks `if fs.inter_pbs:`; materializing
    thousands of InterPb objects per frame cost real milliseconds on
    the parse thread, so the objects build lazily on first indexed/
    iterated access (the np-engine oracle's path)."""

    __slots__ = ("_pb", "_n", "_mat")

    def __init__(self, pb, n):
        self._pb = pb          # np.int32 [n*14] (native `pb` arena view)
        self._n = n
        self._mat = None

    def _list(self):
        if self._mat is None:
            pb = self._pb
            out = []
            for i in range(self._n):
                m = pb[i * 14:(i + 1) * 14]
                out.append(InterPb(
                    x=int(m[0]), y=int(m[1]), w=int(m[2]), h=int(m[3]),
                    l0=(int(m[5]), int(m[6]), int(m[7])) if m[4] else None,
                    l1=(int(m[9]), int(m[10]), int(m[11])) if m[8]
                    else None,
                    r0=int(m[12]), r1=int(m[13])))
            self._mat = out
        return self._mat

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def __iter__(self):
        return iter(self._list())

    def __getitem__(self, i):
        return self._list()[i]

    def append(self, pb):            # symmetry with the plain-list path
        self._list().append(pb)
        self._n = len(self._mat)


@dataclass
class FrameSymbols:
    sps: object
    pps: object
    poc: int
    slice_type: int               # 0=B 1=P 2=I
    slice_qp: int
    nal_type: int = 19
    # decode-order job lists
    pcm_blocks: list = field(default_factory=list)
    coeff_blocks: list = field(default_factory=list)
    intra_jobs: list = field(default_factory=list)
    inter_pbs: list = field(default_factory=list)
    # dense per-4x4 sideband grids [H4, W4]
    ipm: np.ndarray | None = None        # luma intra mode (255 if n/a)
    pred_mode: np.ndarray | None = None  # 0 inter, 1 intra, 2 skip
    is_pcm: np.ndarray | None = None
    tqb: np.ndarray | None = None        # cu_transquant_bypass per 4x4
    cbf_luma4: np.ndarray | None = None  # cbf_luma at 4x4 granularity
    qp_y4: np.ndarray | None = None      # QP_Y per 4x4
    # per-4x4 TU/PU/CU boundary flags (left edge / top edge of a block)
    bounds_v: np.ndarray | None = None
    bounds_h: np.ndarray | None = None
    # per-8x8 MV field [H8, W8, 2, 4]: (mvx, mvy, ref_poc_slot, valid)
    mvf: np.ndarray | None = None
    # full motion state (bitstream.mvs.MotionContext): per-4x4 pred_flag /
    # mv / ref poc grids, used by deblocking BS and (later) TMVP
    motion: object = None
    # raw flat arrays from the native parse core (bitstream/native.py):
    # cb_meta/cb_levels/ij_meta/ij_avail/n_levels — enables vectorized
    # device packing without materializing per-TU Python objects
    native_raw: dict | None = None
    # device-upload layouts packed by the native core (hevc_pack_frame):
    # arena8/arena16/esc/caps/meta/n in _frame_fused's exact format
    native_pack: dict | None = None
    # how the native core parsed the picture (bitstream/native.py):
    # substreams, threads, fallback, wave_wait_us
    parse_stats: dict | None = None

    def active_scaling(self):
        """Resolved scaling list for dequant, or None when disabled
        (selection rule of hevc_cabac.c:1484-1486)."""
        if not hasattr(self, "_asl"):
            from .bitstream.ps import active_scaling_list
            self._asl = active_scaling_list(self.sps, self.pps)
        return self._asl

    def ensure_objects(self):
        """Materialize coeff_blocks/intra_jobs from native_raw arrays
        (the native parser skips per-TU Python objects for speed; the
        scalar oracle paths call this on demand)."""
        if self.native_raw is None or self.coeff_blocks or self.intra_jobs:
            return
        import numpy as np
        raw = self.native_raw
        cm, arena = raw["cb_meta"], raw["cb_levels"]
        for m in cm:
            size = 1 << m[3]
            fl = int(m[5])
            lv = arena[m[6]:m[6] + size * size].astype(np.int32)
            self.coeff_blocks.append(CoeffBlock(
                plane=int(m[0]), x=int(m[1]), y=int(m[2]),
                log2_size=int(m[3]), qp=int(m[4]), is_dst=bool(fl & 1),
                transform_skip=bool(fl & 2), transquant_bypass=bool(fl & 4),
                rdpcm_mode=(-1 if not fl & 8 else (1 if fl & 16 else 0)),
                levels=lv.reshape(size, size),
                matrix_id=3 * bool(fl & 32) + int(m[0]),
                # RExt cross_scale in bits 6-10, biased by 9 (0 = none)
                cross_scale=((fl >> 6) & 31) - 9 if fl >> 6 else 0))
        im, iav = raw["ij_meta"], raw["ij_avail"]
        for i, m in enumerate(im):
            size = int(m[3])
            self.intra_jobs.append(IntraJob(
                plane=int(m[0]), x=int(m[1]), y=int(m[2]), size=size,
                mode=int(m[4]), avail=iav[i, :4 * size + 1].astype(bool),
                filter_refs=bool(m[5])))
    # per-CTB SAO: [ctbs_h, ctbs_w, 3(planes), 6] =
    #   (type 0/1/2=off/band/edge, band_pos or eo_class, offset[4])
    sao: np.ndarray | None = None
    # ref lists: DPB POCs for L0/L1 (resolved by the runtime to plane stacks)
    ref_poc_l0: list = field(default_factory=list)
    ref_poc_l1: list = field(default_factory=list)
    # CTB parse order [(x,y)] (tile-scan when tiles) — drives the
    # reference-schedule loop-filter driver; None = raster
    ctb_order: list | None = None
    # in-loop filter controls
    deblock_disabled: bool = False
    weights: dict | None = None   # pred_weight_table (slice.py) or None
    beta_offset: int = 0
    tc_offset: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
