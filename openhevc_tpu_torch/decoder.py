"""Top-level decoder driver: NAL dispatch, parameter-set registry, POC,
DPB output ordering. (Parity: decode_nal_units/decode_nal_unit,
hevc.c:3831/3288, and output bumping, hevc_refs.c:182.)

Reconstruction runs in the PyTorch engine (models/pipeline.py
TorchEngine) on one torch device: the card by default, the CPU only when
the caller asks for it; or, given a `parallel.DeviceMesh`, in waves of
independent pictures over the mesh's devices (parallel/mesh.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bitstream.bits import unescape_rbsp
from .bitstream import ps as PS
from .bitstream.slice import parse_slice_header, is_idr, is_irap, I_SLICE
from .bitstream.syntax import SliceDataParser
from .utils import trace

class DecodeError(Exception):
    """Raised in strict mode where default mode conceals
    (err_recognition & AV_EF_EXPLODE behavior, hevc.c:3497)."""


NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
NAL_AUD, NAL_EOS, NAL_EOB, NAL_FD = 35, 36, 37, 38
NAL_SEI_PREFIX, NAL_SEI_SUFFIX = 39, 40


def _mesh_type(mesh):
    """mesh, if it is a `parallel.DeviceMesh`; else TypeError."""
    from .parallel import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: want an openhevc_tpu_torch.parallel."
                        f"DeviceMesh, got {type(mesh).__name__}")
    return mesh


def split_nals(data: bytes):
    """Annex-B start-code scan (role of ff_hevc_extract_rbsp's caller)."""
    out = []
    i = 0
    n = len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        start = j + 3
        k = data.find(b"\x00\x00\x01", start)
        end = n if k < 0 else k
        while end > start and data[end - 1] == 0 and k >= 0:
            end -= 1
        out.append(data[start:end])
        i = start
    return out


class _IlRef:
    """Wave-refs shim: an inter-layer reference rides the pinned-refs
    map like a DecodedPicture (only .planes is read at wave recon)."""
    __slots__ = ("planes",)

    def __init__(self, planes):
        self.planes = planes


@dataclass
class DecodedPicture:
    poc: int
    planes: list          # [Y, Cb, Cr] int arrays (uncropped)
    sps: object
    motion: tuple | None = None   # (pred_flag4, mv4, refpoc4) for TMVP
    pid: tuple | None = None      # (layer, decode-order index): spans' id
    fed: int = -1                 # index of the decode() call that fed it

    def cropped(self):
        s = self.sps
        y, cb, cr = self.planes
        H, W = s.height, s.width
        cl, cr_, ct, cbm = s.crop_left, s.crop_right, s.crop_top, s.crop_bottom
        yv = y[ct:H - cbm, cl:W - cr_]
        hs, vs = s.hshift1, s.vshift1
        uc = cb[ct >> vs:(H - cbm) >> vs, cl >> hs:(W - cr_) >> hs]
        vc = cr[ct >> vs:(H - cbm) >> vs, cl >> hs:(W - cr_) >> hs]
        return [yv, uc, vc]


class Decoder:
    def __init__(self, device: str | None = None, layer: int = 0, mesh=None,
                 engine: str = "torch",
                 temporal_layer: int | None = None, strict: bool = False,
                 nb_threads: int | None = None, thread_type: int = 3,
                 config=None, native_parse: bool = True,
                 wave_depth: int | None = None):
        """device: torch device of the reconstruction ("cuda" by default;
        "cpu" only when asked for — there is no fallback); with a mesh,
        the device of the host-side helpers (the SHVC inter-layer
        upsample), by default the mesh's first device.
        layer: nuh_layer_id this decoder handles.
        mesh: a `parallel.DeviceMesh` with a "frame" axis (and an
        optional "tile" axis): independent pictures batch into waves
        reconstructed over its devices (parallel/mesh.py, the
        pthread_frame.c:325 analogue).
        wave_depth: max pictures per wave (default: the mesh's frame
        axis size).
        native_parse: parse slices with the native C++ core (built at
        first use); False sends every slice to the Python parser
        (`SliceDataParser`). With True, a slice the core refuses is
        parsed in Python all the same (counted in stats["python_slices"]).
        engine != "torch": not ported (NotImplementedError).
        config: DecoderConfig — the single typed knob home (SURVEY §5);
        keyword arguments above override its fields for compatibility."""
        from .config import DecoderConfig
        if config is None:
            if device is None:
                device = "cuda" if mesh is None else \
                    str(_mesh_type(mesh).devices.flat[0])
            config = DecoderConfig.from_env(
                engine=engine, device=device, nb_threads=nb_threads,
                thread_type=thread_type, temporal_layer=temporal_layer,
                strict=strict, mesh=mesh, wave_depth=wave_depth)
        if config.mesh is not None:
            _mesh_type(config.mesh)
        if config.engine != "torch":
            raise NotImplementedError(
                f"engine {config.engine!r}: the port has only the torch "
                f"engine (the numpy oracle stays in the JAX package)")
        dev = torch.device(config.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Decoder(device='cuda'): no CUDA device is available; pass "
                "device='cpu' to reconstruct on the CPU")
        self.config = config
        self.device = dev
        self.engine = config.engine
        self.mesh = config.mesh
        self._wave_sched = None         # WaveScheduler (mesh wave path)
        self._wave_depth = config.wave_depth
        self._mesh_dec = None
        self.layer = layer
        self.shvc_bl: Decoder | None = None   # the BL decoder of an EL
        # sub-layer selection: VCL NALs with temporal_id above this are
        # dropped before parse (the AVOption "temporal-layer-id",
        # openHevcWrapper.c:442 -> hevc.c decode_nal_unit gating)
        self.temporal_layer = config.temporal_layer
        # AV_EF_EXPLODE analogue (hevc.c:3497): raise on damage that the
        # default mode conceals (missing references, parse fallbacks)
        self.strict = config.strict
        # host parse through the native C++ core (built at first use);
        # the Python parser takes the slices it cannot
        if native_parse:
            from .bitstream.native import ensure_built
            ensure_built()
        self.native_parse = native_parse
        self.vps = {}
        self.sps = {}
        self.pps = {}
        self.poc = 0
        self.prev_poc_tid0 = 0
        self.dpb: list[DecodedPicture] = []   # pending output, POC order
        self.output: list[DecodedPicture] = []
        self.ref_pics: dict[int, DecodedPicture] = {}
        self.n_output_pending = 0
        self._torch_engine = None
        self._next_vcl_continues = False
        self._acc = None
        self.max_ra = float("inf")   # RASL gate (s->max_ra, hevc.c:3375)
        self.is_nalff = False        # length-prefixed NALs (hvcC input)
        self.nal_length_size = 4
        # 1-deep decode pipeline (the frame-thread analogue,
        # pthread_frame.c:325): the completed picture's reconstruction
        # (device dispatch) runs on the main thread while the NEXT
        # slice's CABAC parse runs in a worker (the native core releases
        # the GIL). Pending = (fs, pic, refs_snapshot, il_planes).
        self._pending = None
        self._parse_executor = None
        # parse-ahead queue (depth>1 keeps the native-parse worker fed
        # while the main thread packs/dispatches; col-motion inputs of
        # queued jobs resolve lazily inside the FIFO worker).
        # Threading knobs resolve in DecoderConfig (openHevcWrapper.c:
        # 80-87: 1=frame -> parse-ahead depth, 2=slice/wpp -> native
        # substream workers, else both). Instance-local — two decoders
        # with different knobs in one process must not share state.
        from collections import deque
        self._parse_q = deque()
        self._parse_futs = {}
        self._parse_depth, self._parse_threads = config.resolved_threads()
        # picture ids of the spans (utils/trace.py): pictures whose
        # slice header was read, and decode() calls, in this decoder
        self._pics = 0
        self._calls = 0
        # parse-path accounting: how many slice segments took the native
        # C++ core vs the Python mirror (tests assert no silent fallback)
        self.stats = {"native_slices": 0, "python_slices": 0}

    # -- extradata (hvcC / Annex-B) ----------------------------------------
    def set_extradata(self, data: bytes):
        """Feed codec extradata before/with the stream. hvcC (ISO 14496-15)
        is detected as in hevc_decode_extradata (hevc.c:4412): parameter-set
        arrays carry 2-byte NAL lengths; subsequent packets are parsed as
        nal_length_size-prefixed NAL units instead of Annex-B."""
        if len(data) > 3 and (data[0] or data[1] or data[2] > 1):
            self.is_nalff = True
            pos = 21
            self.nal_length_size = (data[pos] & 3) + 1
            pos += 1
            num_arrays = data[pos]
            pos += 1
            for _ in range(num_arrays):
                pos += 1                       # completeness + NAL type
                cnt = int.from_bytes(data[pos:pos + 2], "big")
                pos += 2
                for _ in range(cnt):
                    n = int.from_bytes(data[pos:pos + 2], "big")
                    pos += 2
                    nal = data[pos:pos + n]
                    pos += n
                    if len(nal) >= 2:
                        self._handle_nal(nal)
        else:
            self.is_nalff = False
            for nal in split_nals(data):
                if len(nal) >= 2:
                    self._handle_nal(nal)

    def _split_nalff(self, data: bytes):
        out = []
        i, n = 0, self.nal_length_size
        while i + n <= len(data):
            ln = int.from_bytes(data[i:i + n], "big")
            i += n
            out.append(data[i:i + ln])
            i += ln
        return out

    # -- parameter sets ----------------------------------------------------
    def _handle_nal(self, nal: bytes):
        nal_type = (nal[0] >> 1) & 0x3F
        layer_id = ((nal[0] & 1) << 5) | (nal[1] >> 3)
        temporal_id = (nal[1] & 7) - 1
        rbsp = unescape_rbsp(nal[2:])
        # parameter sets are parsed regardless of layer (ids are unique
        # across layers; mirrors decode_nal_unit's VPS/SPS pass-through,
        # hevc.c:3303); slices only for this decoder's layer
        if nal_type == NAL_VPS:
            v = PS.parse_vps(rbsp)
            self.vps[v.vps_id] = v
        elif nal_type == NAL_SPS:
            s = PS.parse_sps(rbsp, layer_id=layer_id,
                             vps=self.vps.get(0))
            self.sps[s.sps_id] = s
        elif nal_type == NAL_PPS:
            p = PS.parse_pps(rbsp, layer_id=layer_id)
            self.pps[p.pps_id] = p
        elif nal_type in (NAL_SEI_PREFIX, NAL_SEI_SUFFIX):
            self._handle_sei(rbsp)
        elif nal_type <= 31 and layer_id == self.layer:
            if self.temporal_layer is not None and \
                    temporal_id > self.temporal_layer:
                return              # sub-layer dropped before parse
            self._decode_slice(nal_type, temporal_id, rbsp,
                               esc_payload=nal[2:])

    def _handle_sei(self, rbsp):
        """Structured SEI retention (ff_hevc_decode_nal_sei): picture
        hash (conformance MD5), frame packing, pic timing, active
        parameter sets land in self.sei."""
        from .bitstream import sei as S
        if not hasattr(self, "sei"):
            self.sei = {}
        try:
            for (ptype, payload) in S.parse_sei(rbsp):
                if ptype == S.SEI_TYPE_DECODED_PICTURE_HASH:
                    self.sei["picture_hash"] = S.parse_picture_hash(payload)
                elif ptype == S.SEI_TYPE_FRAME_PACKING:
                    self.sei["frame_packing"] = S.parse_frame_packing(
                        payload)
                elif ptype == S.SEI_TYPE_PIC_TIMING:
                    self.sei["pic_struct"] = S.parse_pic_timing(
                        payload, True)
                elif ptype == S.SEI_TYPE_ACTIVE_PARAMETER_SETS:
                    self.sei["active_ps"] = \
                        S.parse_active_parameter_sets(payload)
        except Exception:
            pass                     # SEI is advisory; never fatal

    def _compute_poc(self, sps, sh, nal_type, temporal_id):
        """8.3.1 (ff_hevc_compute_poc behavior)."""
        if is_idr(nal_type):
            poc = 0
        else:
            max_lsb = 1 << sps.log2_max_poc_lsb
            prev = self.prev_poc_tid0
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            lsb = sh.poc_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            if nal_type in (16, 17, 18):  # BLA
                msb = 0
            poc = msb + lsb
        if temporal_id == 0 and nal_type not in (0, 2, 4, 8, 9):
            # RASL/RADL/sub-layer pics don't update prev_tid0
            self.prev_poc_tid0 = poc
        return poc

    def _decode_slice(self, nal_type, temporal_id, rbsp, esc_payload=None):
        ndr = 0
        if self.layer > 0 and 0 in self.vps:
            nd = self.vps[0].num_direct_ref_layers
            ndr = nd[self.layer] if self.layer < len(nd) else 0
        sh = parse_slice_header(rbsp, nal_type,
                                self._sps_for(rbsp, nal_type),
                                self._pps_for(rbsp, nal_type),
                                layer_id=self.layer,
                                num_direct_ref_layers=ndr)
        pps = self.pps[sh.pps_id]
        sps = self.sps[pps.sps_id]
        acc = getattr(self, "_acc", None)
        if not sh.first_slice and acc is None:
            return                      # mid-picture join: drop segment
        if sh.dependent and acc is not None:
            # dependent slice segment: all slice-level fields inherit
            # from the preceding independent segment (7.4.7.1; the
            # reference keeps the previous SliceHeader)
            import copy
            base = copy.copy(acc["sh0"])
            base.first_slice = 0
            base.dependent = 1
            base.segment_address = sh.segment_address
            base.data_start_byte = sh.data_start_byte
            base.entry_point_offsets = sh.entry_point_offsets
            sh = base
        if sh.first_slice:
            pid = (self.layer, self._pics)
            self._pics += 1
            poc = self._compute_poc(sps, sh, nal_type, temporal_id)
            if is_idr(nal_type):
                self.ref_pics = {}
            il = None
            if self.layer > 0 and sh.inter_layer_pred and \
                    self.shvc_bl is not None:
                il = self._make_il_ref(poc, sps, sh, pid)
            ref_list = self._build_ref_lists(sh, sps, poc, il=il)
            # collocated picture motion for TMVP (hevc_refs.c)
            col_motion = None
            if sh.temporal_mvp:
                cl = 0 if sh.collocated_list else 1
                lst = ref_list[cl] or ref_list[1 - cl]
                if lst:
                    idx = min(sh.collocated_ref_idx, len(lst) - 1)
                    cpoc = lst[idx][0]
                    if cpoc == poc and \
                            getattr(self, "_il_motion", None) is not None:
                        # collocated = the inter-layer reference: its
                        # motion is the upsampled BL field (mfm,
                        # ff_upscale_mv_block)
                        col_motion = (poc,) + self._il_motion
                    else:
                        col = self.ref_pics.get(cpoc)
                        if col is not None and col.motion is not None:
                            col_motion = (col.poc,) + col.motion
                        elif cpoc in self._parse_futs:
                            # collocated picture still parsing: resolve
                            # inside the FIFO parse worker
                            fcol = self._parse_futs[cpoc]
                            mo = self._motion_of
                            col_motion = (
                                lambda f=fcol, cp=cpoc, mo=mo:
                                (cp,) + mo(f.result()))
            acc = dict(sh0=sh, poc=poc, sps=sps, pps=pps,
                       ref_list=ref_list, col_motion=col_motion,
                       nal_type=nal_type, shared=None, parser=None,
                       n_parsed=0, slice_no=-1, pid=pid)
            self._acc = acc
        poc = acc["poc"]
        n_ctb = sps.ctbs_w * sps.ctbs_h
        # RASL gating after a stream-starting CRA/BLA (hevc.c:3375-3398)
        if sh.first_slice:
            if self.max_ra == float("inf"):
                if nal_type == 21 or 16 <= nal_type <= 18:  # CRA / BLA
                    self.max_ra = poc
                elif is_idr(nal_type):
                    self.max_ra = float("-inf")
            if nal_type in (8, 9) and poc <= self.max_ra:
                self._acc = None
                return                  # drop RASL ahead of the RAP
            if nal_type == 9 and poc > self.max_ra:
                self.max_ra = float("-inf")
            # RPS-driven DPB reference marking (ff_hevc_frame_rps,
            # hevc_refs.c:637): every DPB picture absent from the current
            # picture's RPS (ST curr+foll, LT curr+foll) becomes
            # unused-for-reference and leaves ref_pics. Output copies ride
            # self.dpb, so bumping order is unaffected.
            if not is_idr(nal_type):
                keep = self._rps_keep_set(sh, sps, poc)
                for q in list(self.ref_pics):
                    if q not in keep:
                        del self.ref_pics[q]
            # missing-reference concealment (generate_missing_ref,
            # hevc_refs.c:538): fabricate mid-gray frames so decode
            # continues deterministically; strict mode escalates instead
            # (AV_EF_EXPLODE, hevc.c:3497)
            for lst in acc["ref_list"]:
                for (p, _lt) in lst:
                    if p not in self.ref_pics:
                        if self.strict:
                            raise DecodeError(
                                f"POC {poc}: reference picture {p} "
                                f"missing from the DPB")
                        self.ref_pics[p] = self._missing_ref(p, sps)
        elif self._acc is None:
            return                      # RASL continuation segments
        single_slice = sh.first_slice and not self._next_vcl_continues
        # native core covers 4:2:0/4:2:2/4:4:4, uniform AND non-uniform
        # tiles + WPP, TMVP, weighted pred, cu_qp_delta, multi-slice
        # pictures, and the full RExt tool set incl. cross-component
        # prediction and chroma QP offset lists
        native_caps = self.native_parse and \
            sps.chroma_format_idc in (1, 2, 3) and \
            not (pps.tiles_enabled and
                 (pps.num_tile_cols > 24 or pps.num_tile_rows > 24))
        use_native = single_slice and native_caps
        if use_native:
            from .bitstream.native import parse_slice_native
            if self._parse_executor is None:
                from concurrent.futures import ThreadPoolExecutor
                self._parse_executor = ThreadPoolExecutor(max_workers=1)
            # substream entry points (escaped-domain offsets -> rbsp-byte
            # starts) unlock the native core's threaded WPP/tile parse
            ss_starts = None
            if sh.entry_point_offsets and esc_payload is not None:
                from .bitstream.bits import substream_starts_rbsp
                ss_starts = substream_starts_rbsp(
                    esc_payload, sh.data_start_byte,
                    sh.entry_point_offsets)
            cm = acc["col_motion"]
            rl = acc["ref_list"]
            pid = acc["pid"]

            def job(rbsp=rbsp, sps=sps, pps=pps, sh=sh,
                    nal_type=nal_type, poc=poc, rl=rl,
                    ss_starts=ss_starts, cm=cm,
                    pt=self._parse_threads, parent=trace.current()):
                with trace.span("parse", pic=pid, parent=parent,
                                route="native"):
                    cmv = cm() if callable(cm) else cm
                    try:
                        fs = parse_slice_native(
                            rbsp, sps, pps, sh, nal_type, poc,
                            ref_list=rl, ss_starts=ss_starts,
                            col_motion=cmv, parse_threads=pt)
                        trace.annotate(**fs.parse_stats)
                        return fs
                    except ValueError:
                        # the native core refused the slice (a capacity
                        # or feature edge): the Python parser takes it,
                        # here in the worker
                        trace.annotate(route="python")
                        self.stats["python_slices"] += 1
                        self.stats["native_slices"] -= 1
                        p = SliceDataParser(rbsp, sps, pps, sh, nal_type,
                                            poc, ref_list=rl,
                                            col_motion=cmv, start_ts=0,
                                            slice_no=0)
                        return p.decode()

            fut = self._parse_executor.submit(job)
            self.stats["native_slices"] += 1
            self._acc = None
            # placeholder enters the DPB now: later headers do RPS
            # bookkeeping against it; motion/planes land at drain
            pic = DecodedPicture(poc=poc, planes=None, sps=sps,
                                 motion=None, pid=pid, fed=self._calls)
            self.ref_pics[poc] = pic
            self._parse_futs[poc] = fut
            il = getattr(self, "_il_planes", None) or None
            self._il_planes = None
            # pin the reference PICTURE OBJECTS now: later headers'
            # RPS eviction must not drop them before this picture's
            # drain-time planes snapshot
            pins = {p: self.ref_pics[p]
                    for lst in acc["ref_list"] for (p, _lt) in lst
                    if p in self.ref_pics}
            self._parse_q.append((fut, pic, poc, sps, il, pins))
            while len(self._parse_q) > self._parse_depth:
                self._drain_parse()
            return
        elif native_caps:
            self._drain_parse_all()
            if callable(acc["col_motion"]):
                acc["col_motion"] = acc["col_motion"]()
            # multi-slice picture through the native core: accumulate
            # segments; the whole picture parses in ONE
            # hevc_parse_picture call once the last segment arrives
            # (CABAC/QP state chains across dependent segments in C++)
            from .bitstream.native import parse_picture_native
            if not sh.dependent:
                acc["slice_no"] += 1
            start_ts = sh.segment_address
            if pps.tiles_enabled:
                from .bitstream.ps import ctb_tile_maps
                rs_to_ts = ctb_tile_maps(pps, sps)[0]
                start_ts = int(np.asarray(rs_to_ts).flat[start_ts])
            segs = acc.setdefault("native_segs", [])
            segs.append((rbsp, sh, start_ts, max(acc["slice_no"], 0)))
            if self._next_vcl_continues:
                return                  # more segments of this picture
            self._flush_pending()
            with trace.span("parse", pic=acc["pid"], route="native"):
                fs = parse_picture_native(
                    segs, sps, pps, acc["nal_type"], poc,
                    ref_list=acc["ref_list"],
                    col_motion=acc["col_motion"],
                    parse_threads=self._parse_threads)
                trace.annotate(**fs.parse_stats)
            self.stats["native_slices"] += len(segs)
            acc["n_parsed"] = n_ctb
        else:
            self._drain_parse_all()
            if callable(acc["col_motion"]):
                acc["col_motion"] = acc["col_motion"]()
            self._flush_pending()
            if not sh.dependent:
                acc["slice_no"] += 1
            start_ts = sh.segment_address  # == rs in tile-scan-free case
            if pps.tiles_enabled:
                from .bitstream.ps import ctb_tile_maps
                rs_to_ts = ctb_tile_maps(pps, sps)[0]
                start_ts = int(np.asarray(rs_to_ts).flat[start_ts])
            p = SliceDataParser(
                rbsp, sps, pps, sh, nal_type, poc,
                ref_list=acc["ref_list"], col_motion=acc["col_motion"],
                start_ts=start_ts, shared=acc["shared"],
                dep_ctx=(acc["parser"].final_ctx
                         if sh.dependent and acc["parser"] else None),
                slice_no=max(acc["slice_no"], 0))
            with trace.span("parse", pic=acc["pid"], route="python"):
                fs = p.decode()
            self.stats["python_slices"] += 1
            acc["shared"] = p.shared
            acc["parser"] = p
            acc["n_parsed"] += p.end_ts - p.start_ts
        if acc["n_parsed"] < n_ctb:
            return                      # picture continues in next NAL
        self._acc = None
        self._finish_picture(fs, poc, sps, acc["pid"])

    def _finish_picture(self, fs, poc, sps, pid):
        """Parse of this picture is complete (synchronous paths):
        register it in the DPB and stash the reconstruction work."""
        il = getattr(self, "_il_planes", None)
        self._il_planes = None
        pic = DecodedPicture(poc=poc, planes=None, sps=sps,
                             motion=self._motion_of(fs), pid=pid,
                             fed=self._calls)
        self.ref_pics[poc] = pic
        self._finish_parsed(fs, poc, sps, pic, il)

    def _drain_parse(self):
        """Retire the oldest queued native parse: wait for the worker,
        attach motion to the DPB placeholder, hand off to recon."""
        if not self._parse_q:
            return
        fut, pic, poc, sps, il, pins = self._parse_q.popleft()
        self._parse_futs.pop(poc, None)
        # dispatch the previous picture's recon while the worker runs
        self._flush_pending()
        with trace.span("parse_wait", pic=pic.pid):
            fs = fut.result()
        pic.motion = self._motion_of(fs)
        self._finish_parsed(fs, poc, sps, pic, il, pins)

    def _drain_parse_all(self):
        while self._parse_q:
            self._drain_parse()

    def _finish_parsed(self, fs, poc, sps, pic, il, pins=None):
        """Queue reconstruction of a parse-complete picture. The refs
        snapshot pins the reference pictures this picture needs, so
        later IDR resets / evictions cannot invalidate the deferred
        reconstruct."""
        # mesh wave path (pthread_frame.c:325 analogue): pictures whose
        # references all lie OUTSIDE the current wave batch into one
        # wave over the mesh — intra pictures always qualify; inter
        # pictures qualify until one references a wave member (the
        # WaveScheduler then flushes and starts a new wave). In a
        # hierarchical-B GOP the same-level B pictures form waves.
        if self.mesh is not None:
            if self._wave_sched is None:
                from .parallel import WaveScheduler
                self._wave_sched = WaveScheduler(self._wave_max())
            used = (set(fs.ref_poc_l0) | set(fs.ref_poc_l1)) \
                if fs.inter_pbs else set()
            src = self.ref_pics if pins is None else \
                {**self.ref_pics, **pins}
            refs_pin = {p: src[p] for p in used if p in src}
            if il:
                # SHVC EL: the inter-layer reference is an already-
                # upsampled planes object of the SAME AU — never a wave
                # member of THIS decoder, so it adds no wave dependency
                # and EL pictures batch like any others (the
                # pthread_frame.c:516-624 concurrent-layer analogue)
                for p, pl in il.items():
                    refs_pin[p] = _IlRef(pl)
            w = self._wave_sched
            if len(w) and w._wave[0][1][0].sps is not sps:
                self._flush_wave()
            flushed = w.add(id(pic),
                            {id(o) for o in refs_pin.values()},
                            (fs, pic, refs_pin))
            if flushed:
                self._recon_wave(flushed)
            if len(w) >= self._wave_max():
                self._recon_wave(w.flush())
            return
        src = self.ref_pics if pins is None else \
            {**self.ref_pics, **pins}
        refs = {p: rp.planes for p, rp in src.items()
                if rp.planes is not None}
        if il:
            refs.update(il)     # inter-layer ref (same poc as current)
        # retention is RPS-driven (see _decode_slice); this hard cap is
        # pure OOM protection against damaged/non-conformant streams
        cap = max(getattr(sps, "max_dec_pic_buffering", 8) + 2, 17)
        while len(self.ref_pics) > cap:
            del self.ref_pics[min(self.ref_pics)]
        self._pending = (fs, pic, refs)

    def _flush_pending(self):
        p = self._pending
        if p is None:
            return
        self._pending = None
        fs, pic, refs = p
        with trace.span("reconstruct", pic=pic.pid):
            pic.planes = self._reconstruct(fs, refs)
        if hasattr(pic.planes, "pid"):
            pic.planes.pid = pic.pid
        self._bump(pic, pic.sps)

    def _wave_max(self):
        if self._wave_depth is not None:
            return self._wave_depth
        return int(self.mesh.shape["frame"])

    def _flush_wave(self):
        if self._wave_sched is not None:
            self._recon_wave(self._wave_sched.flush())

    def _recon_wave(self, entries):
        """Reconstruct a flushed wave over the mesh (parallel/mesh.py)
        and bump in decode order. entries: [(key, (fs, pic, refs_pin))]
        from the WaveScheduler. Every picture comes back filtered: on
        the device, or on the host where its filters lie outside the
        whole-frame device model."""
        if not entries:
            return
        self._flush_pending()       # pending picture is always older
        if self._mesh_dec is None:
            from .parallel import MeshFrameDecoder
            self._mesh_dec = MeshFrameDecoder(self.mesh)
        fs_list = [fs for _, (fs, _pic, _rp) in entries]
        refs_list = [{p: o.planes for p, o in rp.items()
                      if o.planes is not None}
                     for _, (_fs, _pic, rp) in entries]
        with trace.span("reconstruct", pic=entries[0][1][1].pid,
                        pictures=len(entries)):
            outs, _ = self._mesh_dec.reconstruct_wave(fs_list, refs_list)
        for (_, (fs, pic, _rp)), planes in zip(entries, outs):
            pic.planes = planes
            if hasattr(planes, "pid"):
                planes.pid = pic.pid
            self._bump(pic, pic.sps)

    def _missing_ref(self, poc, sps):
        """Concealment frame: mid-gray planes + zero motion
        (generate_missing_ref, hevc_refs.c:538)."""
        mid = 1 << (sps.bit_depth - 1)
        H, W = sps.height, sps.width
        hs, vs = sps.hshift1, sps.vshift1
        h4 = (sps.ctbs_h << sps.log2_ctb) >> 2
        w4 = (sps.ctbs_w << sps.log2_ctb) >> 2
        planes = [np.full((H, W), mid, np.int32),
                  np.full((H >> vs, W >> hs), mid, np.int32),
                  np.full((H >> vs, W >> hs), mid, np.int32)]
        motion = (np.zeros((h4, w4), np.uint8),
                  np.zeros((h4, w4, 2, 2), np.int32),
                  np.zeros((h4, w4, 2), np.int32), {})
        return DecodedPicture(poc=poc, planes=planes, sps=sps,
                              motion=motion)

    @staticmethod
    def _motion_of(fs):
        """Per-4x4 (pred_flag, mv, refpoc) grids + {poc: is_lt} of the
        picture's reference lists, stored with the DPB entry (the
        tab_mvf + refPicList analogue kept per HEVCFrame for TMVP)."""
        mc = getattr(fs, "motion", None)
        if mc is not None:
            lt_map = {p: lt for lst in mc.ref_list for (p, lt) in lst}
            return (mc.pred_flag.copy(), mc.mv.copy(), mc.refpoc.copy(),
                    lt_map)
        h4 = (fs.sps.ctbs_h << fs.sps.log2_ctb) >> 2
        w4 = (fs.sps.ctbs_w << fs.sps.log2_ctb) >> 2
        return (np.zeros((h4, w4), np.uint8),
                np.zeros((h4, w4, 2, 2), np.int32),
                np.zeros((h4, w4, 2), np.int32), {})

    def _make_il_ref(self, poc, el_sps, sh, pid):
        """Upsampled BL picture of this AU as the inter-layer reference
        (ff_hevc_set_new_iter_layer_ref behavior; marked long-term with
        the EL's own POC, hevc_refs.c:748). The BL picture is read where
        it lies on the device, upsampled there (ops/upsample.py) and kept
        there as a `TorchPlanes` for the EL's MC: nothing crosses to the
        host. Also derives the IL reference's upsampled motion field and
        the BL reference lists' long-term map for TMVP with collocated =
        IL (mfm; ff_upscale_mv_block, hevc_filter.c:1311). pid: the EL
        picture's id, which the spans of both steps carry."""
        bl = self.shvc_bl
        bl._drain_parse_all()
        bl_pic = bl.ref_pics.get(poc)
        if bl_pic is not None and bl_pic.planes is None:
            bl._flush_pending()             # BL picture still pending
            bl._flush_wave()                # ... or in the BL's wave
        if bl_pic is None or bl_pic.planes is None:
            return None
        from .models.pipeline import TorchPlanes
        from .ops.upsample import upsample_il_frame_dev
        from .ops.upsample_np import upscale_mv_field
        eng = self._engine()
        bd, W, H = el_sps.bit_depth, el_sps.width, el_sps.height
        hs, vs = el_sps.hshift1, el_sps.vshift1
        with eng._stage("upsample"):
            trace.annotate(pic=pid)
            up = upsample_il_frame_dev(
                [eng._ref_plane_dev(bl_pic.planes, c) for c in range(3)],
                W, H, bit_depth=bd, hs=hs, vs=vs)
            flat = torch.cat([p.reshape(-1) for p in up]) \
                .to(torch.uint8 if bd <= 8 else torch.uint16)
        self._il_planes = {poc: TorchPlanes(flat, H, W, H >> vs, W >> hs)}
        self._il_motion = None
        if bl_pic.motion is not None:
            h4 = (el_sps.ctbs_h << el_sps.log2_ctb) >> 2
            w4 = (el_sps.ctbs_w << el_sps.log2_ctb) >> 2
            bl_sps = bl_pic.sps
            with trace.span("il_motion", pic=pid):
                pf, mv, pocg = upscale_mv_field(
                    bl_pic.motion, bl_sps.width, bl_sps.height, W, H, h4,
                    w4, nb_list=2 if sh.slice_type == 0 else 1)
            self._il_motion = (pf, mv, pocg, bl_pic.motion[3])
        return (poc, True)

    def _rps_keep_set(self, sh, sps, poc):
        """POCs the current picture's RPS retains as references: all
        short-term deltas (used AND follow) plus every long-term entry
        (LT_CURR and LT_FOLL), resolved like the list build."""
        keep = set()
        if sh.st_rps is not None:
            keep |= {poc + d for d in sh.st_rps.delta_poc}
        max_lsb = 1 << sps.log2_max_poc_lsb
        for lsb, _used, cyc in zip(sh.lt_poc, sh.lt_used,
                                   sh.lt_msb_present):
            p = lsb
            if cyc is not None:
                p = lsb + poc - cyc * max_lsb - (poc & (max_lsb - 1))
            keep.add(self._find_lt_ref(p, sps))
        return keep

    def _find_lt_ref(self, p, sps):
        """Resolve a long-term entry to a DPB picture POC: LSB match
        first, then exact (find_ref_idx, hevc_refs.c:347-365)."""
        mask = (1 << sps.log2_max_poc_lsb) - 1
        for rp in sorted(self.ref_pics, reverse=True):
            if (rp & mask) == p:
                return rp
        for rp in sorted(self.ref_pics, reverse=True):
            if rp == p:
                return rp
        return p                     # missing ref: keep nominal poc

    def _build_ref_lists(self, sh, sps, poc, il=None):
        """RPS -> L0/L1 reference POC lists (ff_hevc_frame_rps +
        ff_hevc_slice_rpl behavior). il: the inter-layer entry
        (poc, True), inserted after ST-before in L0 and last in L1
        (cand order, hevc_refs.c:457)."""
        if sh.slice_type == I_SLICE:
            return [[], []]
        rps = sh.st_rps
        before, after = [], []
        if rps is not None:
            for delta, used in zip(rps.delta_poc, rps.used):
                p = poc + delta
                if not used:
                    continue
                (before if delta < 0 else after).append((p, False))
        # long-term entries (decode_lt_rps -> LT_CURR, hevc_refs.c:714)
        lt = []
        max_lsb = 1 << sps.log2_max_poc_lsb
        for lsb, used, cyc in zip(sh.lt_poc, sh.lt_used,
                                  sh.lt_msb_present):
            if not used:
                continue
            p = lsb
            if cyc is not None:
                p = lsb + poc - cyc * max_lsb - (poc & (max_lsb - 1))
            lt.append((self._find_lt_ref(p, sps), True))
        n0, n1 = sh.num_ref_idx
        ilr = [il] if il else []
        cands0 = before + ilr + after + lt
        cands1 = after + before + lt + ilr
        l0 = [cands0[i % len(cands0)] for i in range(n0)] if cands0 else []
        l1 = [cands1[i % len(cands1)] for i in range(n1)] if cands1 else []
        if sh.list_mod_l0:
            l0 = [cands0[i] for i in sh.list_mod_l0]
        if sh.list_mod_l1:
            l1 = [cands1[i] for i in sh.list_mod_l1]
        if sh.slice_type == 1:  # P
            l1 = []
        return [l0, l1]

    def _engine(self):
        """The lazily created TorchEngine on this decoder's device."""
        from .models.pipeline import TorchEngine
        if self._torch_engine is None:
            self._torch_engine = TorchEngine(self.device)
        return self._torch_engine

    def _reconstruct(self, fs, refs):
        return self._engine().reconstruct(fs, ref_planes=refs)

    def _sps_for(self, rbsp, nal_type):
        # peek pps id from slice header start to find sps
        from .bitstream.bits import BitReader
        r = BitReader(rbsp)
        r.read1()
        if is_irap(nal_type):
            r.read1()
        pps_id = r.ue()
        pps = self.pps[pps_id]
        return self.sps[pps.sps_id]

    def _pps_for(self, rbsp, nal_type):
        from .bitstream.bits import BitReader
        r = BitReader(rbsp)
        r.read1()
        if is_irap(nal_type):
            r.read1()
        return self.pps[r.ue()]

    # -- output ordering (num_reorder bumping) -----------------------------
    def _bump(self, pic, sps):
        self.dpb.append(pic)
        self.dpb.sort(key=lambda p: p.poc)
        while len(self.dpb) > sps.num_reorder_pics:
            self.output.append(self.dpb.pop(0))

    # -- public API --------------------------------------------------------
    def _vcl_lookahead(self, nals):
        """Per-NAL flag: does the next VCL NAL of this layer continue
        the current picture (first_slice_segment_in_pic_flag == 0)?
        Drives multi-slice accumulation and the native fast path."""
        nxt = [False] * len(nals)
        prev_vcl = None
        for i, n in enumerate(nals):
            ntype = (n[0] >> 1) & 0x3F
            lid = ((n[0] & 1) << 5) | (n[1] >> 3)
            if ntype <= 31 and lid == self.layer and len(n) >= 3:
                if prev_vcl is not None:
                    nxt[prev_vcl] = (n[2] >> 7) == 0
                prev_vcl = i
        return nxt

    def decode(self, data: bytes):
        """Feed Annex-B bytes (any number of AUs); returns newly available
        pictures in output order."""
        self._calls += 1
        with trace.span("decode"):
            nals = self._split_nalff(data) if self.is_nalff \
                else split_nals(data)
            nals = [n for n in nals if len(n) >= 2]
            nxt = self._vcl_lookahead(nals)
            for i, nal in enumerate(nals):
                self._next_vcl_continues = nxt[i]
                self._handle_nal(nal)
            out, self.output = self.output, []
            trace.outputs(out, self._calls, False)
        return out

    def flush(self):
        with trace.span("flush"):
            self._drain_parse_all()
            self._flush_pending()
            self._flush_wave()
            out = self.output + self.dpb
            self.output, self.dpb = [], []
            trace.outputs(out, self._calls, True)
        return out


class ShvcDecoder:
    """2-layer SHVC decode chain (the openHevcWrapper 2-decoder setup,
    openHevcWrapper.c:95-140): both layers see the full access units;
    the EL builds its inter-layer reference from the BL's decoded
    picture of the same POC, on the device. Only EL pictures are
    returned (the wrapper outputs the highest layer,
    openHevcWrapper.c:144); outputs are fetched lazily, so a BL picture
    is never copied to the host."""

    layer_class = Decoder        # the single-layer decoder of each layer

    def __init__(self, device: str | None = None,
                 nb_threads: int | None = None, thread_type: int = 3,
                 config=None, mesh=None):
        """device: torch device of both layers ("cuda" by default; "cpu"
        only when asked for). mesh: a `parallel.DeviceMesh` both layers
        reconstruct their waves over (`Decoder`)."""
        kw = dict(device=device, nb_threads=nb_threads,
                  thread_type=thread_type, config=config, mesh=mesh)
        self.bl = self.layer_class(**kw)
        self.el = self.layer_class(layer=1, **kw)
        self.el.shvc_bl = self.bl

    def set_extradata(self, data: bytes):
        self.bl.set_extradata(data)
        self.el.set_extradata(data)

    def decode(self, data: bytes):
        """Returns newly available EL pictures (the display layer).
        Layers advance NAL-interleaved: the EL's inter-layer reference
        is built right after the BL picture of the same AU, matching
        the wrapper's AU-locked layer stepping (openHevcWrapper.c:95;
        BL reference retention is RPS-driven, so the EL cannot lag a
        whole buffer behind)."""
        self.bl._calls += 1
        self.el._calls += 1
        with trace.span("decode"):
            nals = [n for n in split_nals(data) if len(n) >= 2]
            nxt_bl = self.bl._vcl_lookahead(nals)
            nxt_el = self.el._vcl_lookahead(nals)
            for i, nal in enumerate(nals):
                self.bl._next_vcl_continues = nxt_bl[i]
                self.bl._handle_nal(nal)
                self.el._next_vcl_continues = nxt_el[i]
                self.el._handle_nal(nal)
            self.bl.output = []
            out, self.el.output = self.el.output, []
            trace.outputs(out, self.el._calls, False)
        return out

    def flush(self):
        with trace.span("flush"):
            self.bl.flush()
            return self.el.flush()
