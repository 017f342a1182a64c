"""Minimal ISO-BMFF (MP4/MOV) layer for HEVC tracks.

Demux side plays the role the reference fills via libavformat's mov.c +
isom.c: locate the hvc1/hev1 sample entry, hand its hvcC box to the
decoder as extradata (parsed by Decoder.set_extradata, the
hevc_decode_extradata path), and iterate samples (length-prefixed NAL
packets) from the sample tables. Only the boxes a plain one-video-track
file needs: stsd/stsz/stco(co64)/stsc.

Mux side writes the same subset — enough to round-trip our own streams
and to hand decoded output to standard players/tools.
"""
from __future__ import annotations

import struct


def is_mp4(data: bytes) -> bool:
    return len(data) > 11 and data[4:8] in (b"ftyp", b"moov", b"mdat")


# =========================================================================
# demux
# =========================================================================

def _boxes(data: bytes, start: int, end: int):
    i = start
    while i + 8 <= end:
        size = struct.unpack(">I", data[i:i + 4])[0]
        typ = data[i + 4:i + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[i + 8:i + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - i
        if size < hdr:
            break
        yield typ, i + hdr, min(i + size, end)
        i += size


def _find(data: bytes, path, start=0, end=None):
    if end is None:
        end = len(data)
    for name in path:
        found = None
        for typ, b, e in _boxes(data, start, end):
            if typ == name:
                found = (b, e)
                break
        if found is None:
            return None
        start, end = found
    return start, end


def demux_mp4(data: bytes):
    """-> (hvcC extradata bytes, [sample bytes], nal_length_size).
    Raises ValueError if no HEVC track is present."""
    moov = _find(data, [b"moov"])
    if moov is None:
        raise ValueError("no moov box")
    for typ, tb, te in _boxes(data, *moov):
        if typ != b"trak":
            continue
        stbl = _find(data, [b"mdia", b"minf", b"stbl"], tb, te)
        if stbl is None:
            continue
        sb, se = stbl
        hvcc = None
        stsz = stco = stsc = None
        co64 = False
        for btyp, bb, be in _boxes(data, sb, se):
            if btyp == b"stsd":
                # full box header + entry count, then sample entries
                for etyp, eb, ee in _boxes(data, bb + 8, be):
                    if etyp in (b"hvc1", b"hev1"):
                        # 78 bytes of VisualSampleEntry fields
                        sub = _find(data, [b"hvcC"], eb + 78, ee)
                        if sub:
                            hvcc = data[sub[0]:sub[1]]
            elif btyp == b"stsz":
                stsz = (bb, be)
            elif btyp in (b"stco", b"co64"):
                stco = (bb, be)
                co64 = btyp == b"co64"
            elif btyp == b"stsc":
                stsc = (bb, be)
        if hvcc is None or stsz is None or stco is None:
            continue
        # sample sizes
        ssb = stsz[0]
        uniform = struct.unpack(">I", data[ssb + 4:ssb + 8])[0]
        count = struct.unpack(">I", data[ssb + 8:ssb + 12])[0]
        if uniform:
            sizes = [uniform] * count
        else:
            sizes = list(struct.unpack(
                ">%dI" % count, data[ssb + 12:ssb + 12 + 4 * count]))
        # chunk offsets
        cb = stco[0]
        nch = struct.unpack(">I", data[cb + 4:cb + 8])[0]
        fmt, w = (">%dQ", 8) if co64 else (">%dI", 4)
        offsets = list(struct.unpack(
            fmt % nch, data[cb + 8:cb + 8 + w * nch]))
        # samples per chunk
        spc = []
        if stsc is not None:
            scb = stsc[0]
            n = struct.unpack(">I", data[scb + 4:scb + 8])[0]
            ent = [struct.unpack(">III", data[scb + 8 + 12 * i:
                                              scb + 20 + 12 * i])
                   for i in range(n)]
            for ci in range(nch):
                k = 0
                for (first, cnt, _desc) in ent:
                    if first <= ci + 1:
                        k = cnt
                spc.append(k)
        else:
            spc = [1] * nch
        samples = []
        si = 0
        for ci, off in enumerate(offsets):
            pos = off
            for _ in range(spc[ci]):
                if si >= len(sizes):
                    break
                samples.append(data[pos:pos + sizes[si]])
                pos += sizes[si]
                si += 1
        nls = (hvcc[21] & 3) + 1 if len(hvcc) > 21 else 4
        return hvcc, samples, nls
    raise ValueError("no HEVC track found")


# =========================================================================
# mux
# =========================================================================

def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def make_hvcc(vps: bytes, sps: bytes, pps: bytes,
              nal_length_size: int = 4) -> bytes:
    """hvcC payload (ISO 14496-15 8.3.3.1) from raw parameter-set NALs."""
    def arr(nal_type, nals):
        out = struct.pack(">BH", 0x80 | nal_type, len(nals))
        for n in nals:
            out += struct.pack(">H", len(n)) + n
        return out
    hdr = bytes([
        1,              # configurationVersion
        0x01, 0x60, 0x00, 0x00, 0x00,  # profile space/idc + compat
        0xB0, 0, 0, 0, 0, 0,           # constraint flags
        120,            # level idc
        0xF0, 0x00,     # min_spatial_segmentation
        0xFC,           # parallelismType
        0xFD,           # chroma_format_idc 1
        0xF8, 0xF8,     # bit depths (8)
        0, 0,           # avgFrameRate
        (0x3 << 6) | (0x1 << 3) | 0x4 | (nal_length_size - 1),
        3,              # numOfArrays
    ])
    return hdr + arr(32, [vps]) + arr(33, [sps]) + arr(34, [pps])


def annexb_to_length_prefixed(au: bytes, nal_length_size=4) -> bytes:
    """One access unit: start codes -> length prefixes (mov sample form)."""
    from ..decoder import split_nals
    out = b""
    for nal in split_nals(au):
        out += len(nal).to_bytes(nal_length_size, "big") + nal
    return out


def mux_mp4(samples, hvcc: bytes, width: int, height: int,
            timescale: int = 25, use_hev1: bool = False) -> bytes:
    """samples: list of length-prefixed-NAL sample payloads (one per AU);
    hvcc: hvcC box payload (incl. box header NOT included)."""
    mdat_payload = b"".join(samples)
    # mdat directly after ftyp; moov after — offsets known up front
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) +
                b"isomiso2mp41")
    mdat = _box(b"mdat", mdat_payload)
    data_off = len(ftyp) + 8

    n = len(samples)
    entry = _box(b"hev1" if use_hev1 else b"hvc1",
                 bytes(6) + struct.pack(">H", 1) + bytes(16) +
                 struct.pack(">HH", width, height) +
                 struct.pack(">II", 0x480000, 0x480000) +
                 bytes(4) + struct.pack(">H", 1) + bytes(32) +
                 struct.pack(">Hh", 0x18, -1) +
                 _box(b"hvcC", hvcc))
    stsd = _full(b"stsd", struct.pack(">I", 1) + entry)
    stts = _full(b"stts", struct.pack(">III", 1, n, 1))
    stsc = _full(b"stsc", struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", struct.pack(">II", 0, n) +
                 b"".join(struct.pack(">I", len(s)) for s in samples))
    stco = _full(b"stco", struct.pack(">II", 1, data_off))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    url = _full(b"url ", b"", flags=1)
    dinf = _box(b"dinf", _full(b"dref", struct.pack(">I", 1) + url))
    vmhd = _full(b"vmhd", bytes(8), flags=1)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", bytes(4) + b"vide" + bytes(12) + b"Video\x00")
    mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, n,
                                      0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, n) +
                 bytes(8) + struct.pack(">HHHH", 0, 0, 0, 0) +
                 struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000) +
                 struct.pack(">II", width << 16, height << 16), flags=7)
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, timescale, n) +
                 struct.pack(">IH", 0x10000, 0x100) + bytes(10) +
                 struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000) + bytes(24) +
                 struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    return ftyp + mdat + moov
