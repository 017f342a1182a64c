"""Public API with openHEVC wrapper parity.

`OpenHevc` mirrors the libOpenHevc* surface (openHevcWrapper.h:79-98):
init/start/decode/get_picture_info/get_output/set_*/flush/close, including
the two-decoder layer management slots for SHVC (`set_active_decoders(1)`
decodes two-layer streams through `ShvcDecoder`). `Decoder` (decoder.py)
remains the idiomatic Python API underneath; both reconstruct on the card
unless `device="cpu"` is asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .decoder import Decoder, split_nals
from .bitstream.bits import unescape_rbsp
from .bitstream.sei import (parse_sei, parse_picture_hash, plane_md5,
                            SEI_TYPE_DECODED_PICTURE_HASH)

VERSION = "openhevc_tpu_torch 0.1"


@dataclass
class FrameInfo:
    nYPitch: int = 0
    nUPitch: int = 0
    nVPitch: int = 0
    nBitDepth: int = 8
    nWidth: int = 0
    nHeight: int = 0
    chromat_format: int = 0      # 0=420 1=422 2=444
    frameRate: tuple = (0, 1)
    sample_aspect_ratio: tuple = (0, 1)
    display_picture_number: int = 0
    flag: int = 0
    nTimeStamp: int = 0


@dataclass
class OpenHevcFrame:
    planes: list = field(default_factory=list)   # [Y, U, V] numpy arrays
    frame_info: FrameInfo = field(default_factory=FrameInfo)


class MD5Mismatch(Exception):
    pass


class OpenHevc:
    """libOpenHevcInit-shaped decoder handle."""

    MAX_DECODERS = 2   # base + enhancement layer slots (SHVC)

    def __init__(self, nb_pthreads: int = 1, thread_type: int = 1,
                 device: str = "cuda"):
        """device: torch device of the reconstruction ("cuda" by default;
        "cpu" only when asked for). start() raises RuntimeError on
        "cuda" without a card."""
        self.nb_threads = nb_pthreads
        self.thread_type = thread_type
        self.device = device
        self.check_md5 = False
        self.temporal_layer_id = 0
        self._tl_set = False
        self.err_recognition = 0
        self.active_decoders = 0
        self.view_layer = 0
        self.no_cropping = False
        self._dec: Decoder | None = None
        self._out_queue: list = []
        self._last: OpenHevcFrame | None = None
        self._pending_md5: dict[int, list] = {}
        self._md5_frame_count = 0
        self._verified = 0
        self._extradata: bytes | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self.active_decoders >= 1:
            from .decoder import ShvcDecoder
            self._dec = ShvcDecoder(device=self.device,
                                    nb_threads=self.nb_threads,
                                    thread_type=self.thread_type)
        else:
            self._dec = Decoder(device=self.device,
                                nb_threads=self.nb_threads,
                                thread_type=self.thread_type)
        self._apply_temporal_layer()
        self._apply_strict()
        if self._extradata is not None:
            self._dec.set_extradata(self._extradata)
        return 1

    def _each_layer(self):
        if self._dec is None:
            return []
        return [self._dec.bl, self._dec.el] if hasattr(self._dec, "bl") \
            else [self._dec]

    def _apply_temporal_layer(self):
        # wrapper semantics (openHevcWrapper.c:450): the decoder keeps
        # NALs with temporal_id <= val+1 once a layer has been selected;
        # before any selection everything passes (hevc.c:4307 default 8)
        v = (self.temporal_layer_id + 1) if self._tl_set else None
        for d in self._each_layer():
            d.temporal_layer = v

    def _apply_strict(self):
        for d in self._each_layer():
            d.strict = bool(getattr(self, "err_recognition", 0))

    def close(self):
        self._dec = None

    def flush(self):
        if self._dec:
            self._drain(self._dec.flush())

    # -- configuration (libOpenHevcSet*) ------------------------------------
    def set_check_md5(self, v: bool):
        self.check_md5 = bool(v)

    def set_temporal_layer_id(self, v: int):
        self.temporal_layer_id = v
        self._tl_set = True
        self._apply_temporal_layer()

    def set_error_recognition(self, v: int):
        """AV_EF_EXPLODE-style strictness: v != 0 raises DecodeError on
        stream damage the default mode conceals (hevc.c:3497)."""
        self.err_recognition = int(v)
        self._apply_strict()

    def set_active_decoders(self, v: int):
        self.active_decoders = v

    def set_view_layers(self, v: int):
        self.view_layer = v

    def set_no_cropping(self, v: bool):
        self.no_cropping = bool(v)

    def set_debug_mode(self, v: int):
        """libOpenHevcSetDebugMode parity (openHevcWrapper.c:400):
        v >= 1 switches the framework logger to DEBUG."""
        from .utils import log as _log
        _log.set_level(_log.DEBUG if v >= 1 else _log.WARNING)

    def copy_extradata(self, extra_data: bytes):
        """libOpenHevcCopyExtraData (openHevcWrapper.c:157): stores codec
        extradata (hvcC or Annex-B parameter sets); applied at start(), or
        immediately if already started."""
        self._extradata = bytes(extra_data)
        if self._dec is not None:
            self._dec.set_extradata(self._extradata)

    def version(self) -> str:
        return VERSION

    # -- decode -------------------------------------------------------------
    def decode(self, data: bytes, pts: int = 0) -> int:
        """Feed one access unit (or any chunk of Annex-B bytes). Returns
        got_picture (number of queued output pictures)."""
        assert self._dec is not None, "call start() first"
        # intercept suffix SEI for picture-hash conformance checking
        if self.check_md5:
            for nal in split_nals(data):
                nt = (nal[0] >> 1) & 0x3F
                if nt in (39, 40):
                    for ptype, payload in parse_sei(unescape_rbsp(nal[2:])):
                        if ptype == SEI_TYPE_DECODED_PICTURE_HASH:
                            md5s = parse_picture_hash(payload)
                            if md5s:
                                self._pending_md5[self._md5_frame_count] = \
                                    md5s
                                self._md5_frame_count += 1
        pics = self._dec.decode(data)
        self._drain(pics)
        return 1 if self._out_queue else 0

    def _drain(self, pics):
        for pic in pics:
            planes = pic.cropped() if not self.no_cropping else pic.planes
            if self.check_md5:
                self._verify_md5(pic)
            sps = pic.sps
            # frameRate from VUI timing, SAR from VUI aspect info
            # (openHevcWrapper.c:171-243 fills both from the codec ctx)
            fr = (sps.time_scale, sps.num_units_in_tick) \
                if sps.num_units_in_tick else (0, 1)
            info = FrameInfo(
                nYPitch=planes[0].shape[1], nUPitch=planes[1].shape[1],
                nVPitch=planes[2].shape[1], nBitDepth=sps.bit_depth,
                nWidth=planes[0].shape[1], nHeight=planes[0].shape[0],
                chromat_format=sps.chroma_format_idc - 1,
                frameRate=fr,
                sample_aspect_ratio=(sps.sar_num, sps.sar_den),
                display_picture_number=pic.poc)
            self._out_queue.append(OpenHevcFrame(planes=planes,
                                                 frame_info=info))

    def _verify_md5(self, pic):
        md5s = self._pending_md5.pop(self._verified, None)
        self._verified += 1
        if md5s is None:
            return
        planes = pic.planes  # hash covers the UNcropped decoded picture
        for i, (plane, want) in enumerate(zip(planes, md5s)):
            got = plane_md5(np.asarray(plane), pic.sps.bit_depth)
            if got != want:
                raise MD5Mismatch(
                    f"POC {pic.poc} plane {i}: decoded picture hash mismatch")

    # -- output -------------------------------------------------------------
    def get_picture_info(self) -> FrameInfo:
        if self._out_queue:
            return self._out_queue[0].frame_info
        return FrameInfo()

    def get_output(self, got_picture: int = 1) -> OpenHevcFrame | None:
        if not got_picture or not self._out_queue:
            return None
        frame = self._out_queue.pop(0)
        self._last = frame
        return frame

    get_output_cpy = get_output
