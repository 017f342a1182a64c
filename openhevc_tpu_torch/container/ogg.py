"""Minimal Ogg (RFC 3533) layer for HEVC elementary streams.

Demux side plays the role the reference fills via libavformat's
oggdec.c: sync on "OggS" page capture patterns, validate the page CRC,
reassemble packets from the 255-lacing segment table across page
boundaries, and pick the logical stream whose BOS packet carries the
HEVC mapping. There is no standardized HEVC-in-Ogg mapping (the
reference's oggdec.c carries Theora/Vorbis-family codecs only), so the
mux uses a Theora-style private header: BOS packet = b"\\x80hevc\\x00"
followed by the hvcC decoder configuration; each subsequent packet is
one length-prefixed HEVC sample (as in MP4/Matroska). Enough to
round-trip our own streams and exercise the full page/lacing/CRC
machinery external Ogg files use.
"""
from __future__ import annotations

import struct

MAGIC = b"\x80hevc\x00"


def is_ogg(data: bytes) -> bool:
    return data[:4] == b"OggS"


def _crc_table():
    # Ogg CRC32: poly 0x04C11DB7, init 0, no final xor, MSB-first
    tab = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            c &= 0xFFFFFFFF
        tab.append(c)
    return tab


_CRC = _crc_table()


def crc_ogg(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC[((c >> 24) ^ b) & 0xFF]
    return c


def _raw_page(serial: int, seq: int, granule: int, htype: int,
              segs: bytes, body: bytes) -> bytes:
    hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, granule, serial,
                      seq, 0, len(segs)) + segs
    crc = crc_ogg(hdr + body)
    return hdr[:22] + struct.pack("<I", crc) + hdr[26:] + body


def _packet_pages(serial: int, seq0: int, granule: int, pkt: bytes,
                  htype0: int, eos: bool) -> bytes:
    """Pages carrying one packet: 255-lacing, spilling onto
    continuation pages (header_type 0x01) when the segment table
    (max 255 entries) fills."""
    lac = []
    r = len(pkt)
    while True:
        seg = min(r, 255)
        lac.append(seg)
        r -= seg
        if seg < 255:
            break
    out = bytearray()
    pos = 0
    seq = seq0
    first = True
    while lac:
        chunk, lac = lac[:255], lac[255:]
        nbytes = sum(chunk)
        htype = (htype0 if first else 0x01)
        if not lac and eos:
            htype |= 0x04
        out += _raw_page(serial, seq, granule, htype, bytes(chunk),
                         pkt[pos:pos + nbytes])
        pos += nbytes
        seq += 1
        first = False
    return bytes(out)


def mux_ogg(samples, hvcc: bytes, serial: int = 0x48455643) -> bytes:
    """Length-prefixed HEVC samples + hvcC -> Ogg stream: BOS page with
    the private HEVC mapping header, one packet per sample (laced over
    continuation pages when larger than one segment table), EOS flag on
    the final page."""
    out = bytearray()
    out += _packet_pages(serial, 0, 0, MAGIC + hvcc, 0x02, False)
    seq = len(out.split(b"OggS")) - 1
    n = len(samples)
    for i, s in enumerate(samples):
        pages = _packet_pages(serial, seq, i + 1, s, 0, i == n - 1)
        seq += pages.count(b"OggS")
        out += pages
    return bytes(out)


def demux_ogg(data: bytes):
    """-> (hvcC extradata, [sample bytes], nal_length_size).

    Full page walk: CRC check, packet reassembly across pages
    (continuation flag + 255-lacing), BOS mapping detection. Raises
    ValueError when no HEVC logical stream is present."""
    i = 0
    serial = None
    hvcc = None
    samples = []
    partial = b""
    while i + 27 <= len(data):
        if data[i:i + 4] != b"OggS":
            i += 1                      # resync (oggdec.c behavior)
            continue
        (_, _ver, htype, _gran, ser, _seq, crc, nseg) = struct.unpack(
            "<4sBBqIIIB", data[i:i + 27])
        segs = data[i + 27:i + 27 + nseg]
        body_off = i + 27 + nseg
        body_len = sum(segs)
        page = bytearray(data[i:body_off + body_len])
        page[22:26] = b"\x00\x00\x00\x00"
        if crc_ogg(bytes(page)) != crc:
            i += 1
            continue                    # corrupt page: resync
        if serial is not None and ser != serial:
            i = body_off + body_len
            continue
        # packet reassembly from the lacing values
        pos = body_off
        if not (htype & 0x01):          # not a continuation: fresh
            partial = b""
        for k, seg in enumerate(segs):
            partial += data[pos:pos + seg]
            pos += seg
            if seg < 255:               # packet ends here
                pkt, partial = partial, b""
                if serial is None:
                    if (htype & 0x02) and pkt.startswith(MAGIC):
                        serial = ser
                        hvcc = pkt[len(MAGIC):]
                else:
                    samples.append(pkt)
        i = body_off + body_len
    if hvcc is None:
        raise ValueError("no HEVC logical stream in Ogg")
    nls = (hvcc[21] & 3) + 1 if len(hvcc) > 21 else 4
    return hvcc, samples, nls
