"""Access-unit parser: frame-boundary detection over an Annex-B byte
stream (AVCodecParser ff_hevc_parser, hevc_parser.c:344).

Splits arbitrary byte chunks into complete access units and extracts
lightweight per-AU info (pict_type, POC lsb, IRAP-ness) without running
the full decoder — the role avcodec's parser plays between the demuxer
and the decoder (hevc_find_frame_end :41, parse_nal_units :94).
"""
from __future__ import annotations

from dataclasses import dataclass, field

NAL_AUD, NAL_EOS, NAL_EOB, NAL_FD = 35, 36, 37, 38
NAL_SEI_PREFIX = 39
PS_NALS = (32, 33, 34)               # VPS / SPS / PPS


@dataclass
class AuInfo:
    pict_type: str = "?"             # 'I' / 'P' / 'B'
    poc_lsb: int = -1
    irap: bool = False
    idr: bool = False
    nal_types: list = field(default_factory=list)


def _nal_positions(data: bytes):
    """[(start_of_startcode, start_of_nal)] for every NAL in data."""
    out = []
    i = 0
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        sc = j - 1 if j > 0 and data[j - 1] == 0 else j
        out.append((sc, j + 3))
        i = j + 3
    return out


def _is_au_start(data: bytes, pos: int) -> bool:
    """Does the VCL NAL at pos begin a new AU?
    (first_slice_segment_in_pic_flag of a layer-0 slice,
    hevc_find_frame_end hevc_parser.c:52-60)."""
    nal_type = (data[pos] >> 1) & 0x3F
    layer_id = ((data[pos] & 1) << 5) | (data[pos + 1] >> 3)
    if nal_type > 31 or layer_id != 0:
        return False
    return pos + 2 < len(data) and (data[pos + 2] >> 7) == 1


class AuParser:
    """Incremental AU splitter. feed() accepts arbitrary byte chunks and
    returns a list of complete access units; flush() drains the tail."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes):
        self._buf += chunk
        data = self._buf
        nals = _nal_positions(data)
        aus = []
        au_begin = None            # byte offset where the current AU began
        seen_vcl = False
        last_complete = 0
        for k, (sc, pos) in enumerate(nals):
            if pos + 2 >= len(data):
                break
            nal_type = (data[pos] >> 1) & 0x3F
            starts_new = False
            if nal_type <= 31:
                if _is_au_start(data, pos) and seen_vcl:
                    starts_new = True
            elif nal_type in PS_NALS or nal_type == NAL_AUD or \
                    nal_type == NAL_SEI_PREFIX or \
                    nal_type in (NAL_EOS, NAL_EOB):
                # non-VCL prefix NALs belong to the NEXT AU once a VCL
                # NAL has been seen (hevc_parser.c:55-59)
                if seen_vcl:
                    starts_new = True
            if starts_new:
                aus.append(data[au_begin or 0:sc])
                last_complete = sc
                au_begin = sc
                seen_vcl = False
            if au_begin is None:
                au_begin = sc
            if nal_type <= 31:
                seen_vcl = True
        self._buf = data[last_complete:]
        return aus

    def flush(self):
        out = [self._buf] if self._buf.strip(b"\x00") else []
        self._buf = b""
        return out


def au_info(au: bytes, sps_log2_max_poc_lsb: int | None = None) -> AuInfo:
    """Lightweight per-AU info (parse_nal_units, hevc_parser.c:94):
    pict_type from the first slice's slice_type, POC lsb when the SPS
    poc-lsb width is known."""
    from .bits import BitReader, unescape_rbsp
    info = AuInfo()
    done = False
    for (sc, pos) in _nal_positions(au):
        if pos + 2 > len(au):
            continue
        nal_type = (au[pos] >> 1) & 0x3F
        info.nal_types.append(nal_type)
        if nal_type > 31 or done:
            continue
        done = True
        info.irap = 16 <= nal_type <= 23
        info.idr = nal_type in (19, 20)
        r = BitReader(unescape_rbsp(au[pos + 2:pos + 32]))
        first = r.read1()
        if 16 <= nal_type <= 23:
            r.read1()              # no_output_of_prior_pics_flag
        r.ue()                     # slice_pic_parameter_set_id
        if not first:
            continue               # type lives on the first segment
        st = r.ue()
        info.pict_type = {0: "B", 1: "P", 2: "I"}.get(st, "?")
        if sps_log2_max_poc_lsb and not info.idr:
            info.poc_lsb = r.read(sps_log2_max_poc_lsb)
    return info
