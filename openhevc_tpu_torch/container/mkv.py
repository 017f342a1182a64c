"""Minimal Matroska (WebM-family EBML) layer for HEVC tracks.

Demux side plays the role the reference fills via libavformat's
matroskadec.c: walk the EBML tree to the Segment, find the video track
whose CodecID is V_MPEGH/ISO/HEVC, hand its CodecPrivate (hvcC) to the
decoder as extradata, and iterate SimpleBlock/BlockGroup frames
(length-prefixed NAL samples). Mux side (matroskaenc.c role) writes the
same subset: EBML header + one Segment with Info, a single video
track, and one Cluster of SimpleBlocks — enough to round-trip our own
streams and feed standard players/tools.
"""
from __future__ import annotations

import struct

# EBML element IDs (stored with their length-marker bits, as they
# appear on the wire)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEG_INFO = 0x1549A966
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
VIDEO = 0xE0
PIXEL_W = 0xB0
PIXEL_H = 0xBA
CLUSTER = 0x1F43B675
TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
TIMESTAMP_SCALE = 0x2AD7B1
MUX_APP = 0x4D80
WRITE_APP = 0x5741
DURATION = 0x4489

HEVC_CODEC_ID = b"V_MPEGH/ISO/HEVC"


def is_mkv(data: bytes) -> bool:
    return data[:4] == b"\x1a\x45\xdf\xa3"


# =========================================================================
# EBML primitives
# =========================================================================

def _read_vint(data: bytes, i: int, keep_marker: bool):
    """EBML variable-length integer at offset i -> (value, next offset)."""
    if i >= len(data):
        raise ValueError("EBML: truncated vint")
    b0 = data[i]
    if b0 == 0:
        raise ValueError("EBML: invalid vint")
    n = 8 - b0.bit_length()          # number of extension bytes
    v = b0 if keep_marker else b0 & ((1 << (7 - n)) - 1)
    for k in range(n):
        v = (v << 8) | data[i + 1 + k]
    return v, i + 1 + n


def _elements(data: bytes, start: int, end: int):
    """Iterate (element_id, body_start, body_end) in [start, end)."""
    i = start
    while i < end:
        eid, i = _read_vint(data, i, keep_marker=True)
        size, i = _read_vint(data, i, keep_marker=False)
        yield eid, i, min(i + size, end)
        i += size


def _uint(data: bytes, b: int, e: int) -> int:
    v = 0
    for k in range(b, e):
        v = (v << 8) | data[k]
    return v


def _enc_id(eid: int) -> bytes:
    n = max(1, (eid.bit_length() + 7) // 8)
    return eid.to_bytes(n, "big")


def _enc_size(size: int) -> bytes:
    """Shortest-form EBML size."""
    for n in range(1, 9):
        if size < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | size).to_bytes(n, "big")
    raise ValueError("EBML size too large")


def _el(eid: int, body: bytes) -> bytes:
    return _enc_id(eid) + _enc_size(len(body)) + body


def _el_uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return _el(eid, v.to_bytes(n, "big"))


# =========================================================================
# demux
# =========================================================================

def demux_mkv(data: bytes):
    """-> (hvcC extradata bytes, [sample bytes], nal_length_size).

    Samples are length-prefixed NAL packets exactly as in MP4 (the
    CodecPrivate hvcC declares the prefix size). Raises ValueError when
    no HEVC track is present (matroskadec.c role)."""
    seg = None
    for eid, b, e in _elements(data, 0, len(data)):
        if eid == SEGMENT:
            seg = (b, e)
            break
    if seg is None:
        raise ValueError("no Matroska Segment")
    hvcc = None
    track_no = None
    samples = []
    for eid, b, e in _elements(data, seg[0], seg[1]):
        if eid == TRACKS and track_no is None:
            for tid, tb, te in _elements(data, b, e):
                if tid != TRACK_ENTRY:
                    continue
                num, cid, priv = None, None, None
                for fid, fb, fe in _elements(data, tb, te):
                    if fid == TRACK_NUMBER:
                        num = _uint(data, fb, fe)
                    elif fid == CODEC_ID:
                        cid = data[fb:fe].rstrip(b"\x00")
                    elif fid == CODEC_PRIVATE:
                        priv = data[fb:fe]
                if cid == HEVC_CODEC_ID and priv is not None:
                    track_no, hvcc = num, priv
                    break
        elif eid == CLUSTER and track_no is not None:
            for cid, cb, ce in _elements(data, b, e):
                if cid == SIMPLE_BLOCK:
                    spans = [(cb, ce)]
                elif cid == BLOCK_GROUP:
                    # frames wrapped in BlockGroup/Block (mkvmerge,
                    # ffmpeg blocks carrying duration/references)
                    spans = [(ib, ie) for iid, ib, ie
                             in _elements(data, cb, ce) if iid == BLOCK]
                else:
                    continue
                for bb, be in spans:
                    tn, i = _read_vint(data, bb, keep_marker=False)
                    if tn != track_no:
                        continue
                    # 2-byte relative timestamp + 1 flags byte
                    flags = data[i + 2]
                    body = data[i + 3:be]
                    lacing = (flags >> 1) & 3
                    if lacing == 0:
                        samples.append(body)
                    else:
                        samples.extend(_delace(body, lacing))
    if hvcc is None:
        raise ValueError("no HEVC (V_MPEGH/ISO/HEVC) track in Matroska")
    nls = (hvcc[21] & 3) + 1 if len(hvcc) > 21 else 4
    return hvcc, samples, nls


def _delace(body: bytes, lacing: int):
    """Split a laced block body into frames (Matroska lacing: 1=Xiph,
    2=fixed-size, 3=EBML; matroskadec.c matroska_parse_laces role)."""
    nframes = body[0] + 1
    i = 1
    sizes = []
    if lacing == 1:                     # Xiph: 255-continued bytes
        for _ in range(nframes - 1):
            sz = 0
            while True:
                sz += body[i]
                last = body[i] != 255
                i += 1
                if last:
                    break
            sizes.append(sz)
    elif lacing == 2:                   # fixed: equal split
        if (len(body) - 1) % nframes:
            raise ValueError("mkv: fixed lacing size mismatch")
        sizes = [(len(body) - 1) // nframes] * (nframes - 1)
    else:                               # EBML: first vint, then deltas
        first, i = _read_vint(body, i, keep_marker=False)
        sizes.append(first)
        prev = first
        for _ in range(nframes - 2):
            raw, j = _read_vint(body, i, keep_marker=False)
            nbytes = j - i
            delta = raw - ((1 << (7 * nbytes - 1)) - 1)   # signed vint
            prev += delta
            i = j
            sizes.append(prev)
    frames = []
    for sz in sizes:
        frames.append(body[i:i + sz])
        i += sz
    frames.append(body[i:])            # last frame: remaining bytes
    return frames


# =========================================================================
# mux
# =========================================================================

def mux_mkv(samples, hvcc: bytes, width: int, height: int,
            fps: int = 25) -> bytes:
    """Length-prefixed HEVC samples + hvcC -> minimal Matroska file
    (matroskaenc.c role): one Segment, one video track, Clusters of
    key SimpleBlocks with millisecond timestamps (a new Cluster opens
    before the int16 relative timestamp could overflow)."""
    ebml = _el(EBML_HEADER,
               _el_uint(0x4286, 1) +          # EBMLVersion
               _el_uint(0x42F7, 1) +          # EBMLReadVersion
               _el_uint(0x42F2, 4) +          # EBMLMaxIDLength
               _el_uint(0x42F3, 8) +          # EBMLMaxSizeLength
               _el(0x4282, b"matroska") +     # DocType
               _el_uint(0x4287, 4) +          # DocTypeVersion
               _el_uint(0x4285, 2))           # DocTypeReadVersion
    info = _el(SEG_INFO,
               _el_uint(TIMESTAMP_SCALE, 1000000) +   # ns per tick (ms)
               _el(MUX_APP, b"openhevc_tpu_torch") +
               _el(WRITE_APP, b"openhevc_tpu_torch") +
               _el(DURATION, struct.pack(">f",
                                         len(samples) * 1000.0 / fps)))
    track = _el(TRACKS, _el(TRACK_ENTRY,
                _el_uint(TRACK_NUMBER, 1) +
                _el_uint(0x73C5, 1) +          # TrackUID
                _el_uint(TRACK_TYPE, 1) +      # video
                _el(CODEC_ID, HEVC_CODEC_ID) +
                _el(CODEC_PRIVATE, hvcc) +
                _el(VIDEO, _el_uint(PIXEL_W, width) +
                    _el_uint(PIXEL_H, height))))
    # SimpleBlock timestamps are int16-relative to their Cluster: start
    # a new Cluster (with its own absolute Timestamp) before the
    # relative value would overflow (matroskaenc.c behavior) — without
    # this, streams past ~32 s of ms-ticks cannot be represented
    clusters = bytearray()
    blocks = bytearray()
    base = 0
    for n, s in enumerate(samples):
        t = n * 1000 // max(fps, 1)
        if t - base > 32000 and blocks:
            clusters += _el(CLUSTER, _el_uint(TIMESTAMP, base) +
                            bytes(blocks))
            blocks = bytearray()
            base = t
        # track 1 vint, s16 relative timestamp, flags: keyframe
        body = b"\x81" + struct.pack(">h", t - base) + b"\x80" + s
        blocks += _el(SIMPLE_BLOCK, body)
    clusters += _el(CLUSTER, _el_uint(TIMESTAMP, base) + bytes(blocks))
    return ebml + _el(SEGMENT, info + track + bytes(clusters))
