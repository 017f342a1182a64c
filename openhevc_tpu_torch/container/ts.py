"""Minimal MPEG-TS (ISO 13818-1) layer for HEVC elementary streams.

Demux side plays the role the reference fills via libavformat's
mpegts.c: sync on 188-byte packets, walk PAT -> PMT to find the HEVC
elementary PID (stream_type 0x24), reassemble PES packets and hand the
Annex-B elementary stream to the decoder. Mux side writes the same
subset (mpegtsenc.c role): PAT + PMT + PES with PTS, continuity
counters, and adaptation-field stuffing — enough to round-trip our own
streams and to feed standard players/tools.
"""
from __future__ import annotations

import struct

TS_PKT = 188
SYNC = 0x47
PMT_PID = 0x1000
HEVC_PID = 0x0100
HEVC_STREAM_TYPE = 0x24          # ITU-T H.265 | ISO 23008-2


def is_ts(data: bytes) -> bool:
    """Sync-byte heuristic: >= 4 aligned 188-byte packets."""
    if len(data) < 4 * TS_PKT or data[0] != SYNC:
        return False
    return all(data[i * TS_PKT] == SYNC for i in range(4))


# =========================================================================
# shared: MPEG-2 CRC32 (polynomial 0x04C11DB7, MSB-first, init ~0)
# =========================================================================

def _crc_table():
    tab = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            c &= 0xFFFFFFFF
        tab.append(c)
    return tab


_CRC = _crc_table()


def crc32_mpeg(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC[((c >> 24) ^ b) & 0xFF]
    return c


# =========================================================================
# demux
# =========================================================================

def _psi_payload(pkt: bytes):
    """Packet payload positioned after the PSI pointer_field (valid on
    packets with payload_unit_start set)."""
    afc = (pkt[3] >> 4) & 3
    i = 4
    if afc & 2:                       # adaptation field present
        i += 1 + pkt[4]
    if afc & 1 and i < TS_PKT:
        ptr = pkt[i]
        return pkt[i + 1 + ptr:]
    return b""


def _pes_payload(pkt: bytes):
    afc = (pkt[3] >> 4) & 3
    i = 4
    if afc & 2:
        i += 1 + pkt[4]
    return pkt[i:] if afc & 1 else b""


def demux_ts(data: bytes) -> bytes:
    """-> Annex-B HEVC elementary stream bytes.

    Walks PAT -> PMT for the first stream_type-0x24 PID, strips PES
    headers at each payload_unit_start, concatenates the ES payload
    (mpegts.c's handle_packet -> mpegts_push_data role). PSI sections
    and PES headers are accumulated across packet boundaries
    (mpegts.c:write_section_data role) — external muxers emit
    multi-packet PMTs and >184-byte PES headers. Raises ValueError if
    no HEVC stream is present."""
    pmt_pids = set()
    hevc_pid = None
    # pass 1: PSI, accumulated per PID until section_length is covered
    psi_buf: dict = {}
    for off in range(0, len(data) - TS_PKT + 1, TS_PKT):
        pkt = data[off:off + TS_PKT]
        if pkt[0] != SYNC:
            continue
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        pusi = pkt[1] & 0x40
        if pid == 0 or pid in pmt_pids:
            if pusi:
                psi_buf[pid] = bytearray(_psi_payload(pkt))
            elif pid in psi_buf:
                psi_buf[pid] += _pes_payload(pkt)
            else:
                continue
            sec = psi_buf[pid]
            if len(sec) < 3:
                continue
            slen = ((sec[1] & 0x0F) << 8) | sec[2]
            if len(sec) < 3 + slen:
                continue              # section continues in next packet
            body = bytes(sec[3:3 + slen - 4])
            del psi_buf[pid]
            if pid == 0 and sec[0] == 0x00:           # PAT
                for i in range(5, len(body) - 3, 4):
                    prog = (body[i] << 8) | body[i + 1]
                    p = ((body[i + 2] & 0x1F) << 8) | body[i + 3]
                    if prog != 0:     # 0 = network PID
                        pmt_pids.add(p)
            elif pid != 0 and sec[0] == 0x02 and hevc_pid is None:
                pinfo = ((body[7] & 0x0F) << 8) | body[8]
                i = 9 + pinfo
                while i + 5 <= len(body):
                    stype = body[i]
                    epid = ((body[i + 1] & 0x1F) << 8) | body[i + 2]
                    eilen = ((body[i + 3] & 0x0F) << 8) | body[i + 4]
                    if stype == HEVC_STREAM_TYPE:
                        hevc_pid = epid
                        break
                    i += 5 + eilen
    if hevc_pid is None:
        raise ValueError("no HEVC (stream_type 0x24) track in TS")
    # pass 2: PES reassembly on the HEVC PID; the optional PES header
    # may span packets — buffer until 9 + header_length bytes arrived
    out = []
    hdr = None                        # accumulating PES header, or None
    for off in range(0, len(data) - TS_PKT + 1, TS_PKT):
        pkt = data[off:off + TS_PKT]
        if pkt[0] != SYNC:
            continue
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        if pid != hevc_pid:
            continue
        payload = _pes_payload(pkt)
        if pkt[1] & 0x40:             # payload_unit_start
            hdr = bytearray()
        if hdr is not None:
            hdr += payload
            if len(hdr) < 9:
                continue
            if hdr[:3] != b"\x00\x00\x01":
                hdr = None            # not a PES start: drop packet
                continue
            total = 9 + hdr[8]
            if len(hdr) < total:
                continue              # header continues in next packet
            out.append(bytes(hdr[total:]))
            hdr = None
        else:
            out.append(payload)
    return b"".join(out)


# =========================================================================
# mux
# =========================================================================

def _ts_packets(pid: int, payload: bytes, cc_state: dict,
                pusi: bool, pcr: int | None = None) -> bytes:
    """Packetize one PES/PSI payload onto `pid`, stuffing the final
    partial cell through an adaptation field (mpegtsenc.c:write_pes).
    pcr: 27 MHz program clock reference stamped into the FIRST packet's
    adaptation field (the PMT declares PCR_PID = video PID)."""
    out = bytearray()
    first = True
    pos = 0
    while pos < len(payload) or first:
        cc = cc_state.get(pid, 0)
        cc_state[pid] = (cc + 1) & 0x0F
        flags2 = (0x40 if (pusi and first) else 0) | (pid >> 8)
        want_pcr = pcr is not None and first
        room = 184 - 8 if want_pcr else 184
        chunk = payload[pos:pos + room]
        pos += len(chunk)
        if len(chunk) == 184 and not want_pcr:
            out += bytes((SYNC, flags2, pid & 0xFF, 0x10 | cc)) + chunk
        else:
            # adaptation field: PCR and/or stuffing fills the gap
            af_len = 184 - len(chunk) - 1
            body = bytearray()
            if want_pcr:
                base, ext = divmod(pcr, 300)
                body.append(0x10)     # PCR_flag
                body += bytes(((base >> 25) & 0xFF, (base >> 17) & 0xFF,
                               (base >> 9) & 0xFF, (base >> 1) & 0xFF,
                               ((base & 1) << 7) | 0x7E | (ext >> 8),
                               ext & 0xFF))
            elif af_len > 0:
                body.append(0x00)
            body += b"\xff" * (af_len - len(body))
            out += bytes((SYNC, flags2, pid & 0xFF, 0x30 | cc)) + \
                bytes((af_len,)) + bytes(body) + chunk
        first = False
    return bytes(out)


def _psi_section(table_id: int, table_id_ext: int, body: bytes) -> bytes:
    slen = len(body) + 9                     # 5 post-length hdr + body + CRC
    sec = bytes((table_id, 0xB0 | (slen >> 8), slen & 0xFF,
                 table_id_ext >> 8, table_id_ext & 0xFF,
                 0xC1, 0x00, 0x00)) + body
    return sec + struct.pack(">I", crc32_mpeg(sec))


def mux_ts(au_list, fps: int = 25) -> bytes:
    """Annex-B access units -> single-program MPEG-TS.

    au_list: iterable of Annex-B byte strings (one access unit each).
    Writes PAT + PMT once, then one PES packet per AU with a PTS on a
    90 kHz clock (mpegtsenc.c role)."""
    cc = {}
    out = bytearray()
    # PAT: program 1 -> PMT_PID
    pat_body = bytes((0x00, 0x01, 0xE0 | (PMT_PID >> 8), PMT_PID & 0xFF))
    out += _ts_packets(0, b"\x00" + _psi_section(0x00, 1, pat_body),
                       cc, True)
    # PMT: PCR on the video PID, one HEVC stream
    pmt_body = bytes((0xE0 | (HEVC_PID >> 8), HEVC_PID & 0xFF,
                      0xF0, 0x00,
                      HEVC_STREAM_TYPE,
                      0xE0 | (HEVC_PID >> 8), HEVC_PID & 0xFF,
                      0xF0, 0x00))
    out += _ts_packets(PMT_PID, b"\x00" + _psi_section(0x02, 1, pmt_body),
                       cc, True)
    tick = 90000 // max(fps, 1)
    for n, au in enumerate(au_list):
        pts = (n + 1) * tick
        p = bytes((0x21 | ((pts >> 29) & 0x0E),
                   (pts >> 22) & 0xFF, 0x01 | ((pts >> 14) & 0xFE),
                   (pts >> 7) & 0xFF, 0x01 | ((pts << 1) & 0xFE)))
        # PES_packet_length 0 (unbounded, legal for video)
        pes = b"\x00\x00\x01\xe0\x00\x00" + \
            bytes((0x80, 0x80, len(p))) + p + au
        # PCR rides the video PID (PCR_PID in the PMT), one per AU,
        # slightly behind PTS (27 MHz clock)
        out += _ts_packets(HEVC_PID, pes, cc, True, pcr=n * tick * 300)
    return bytes(out)
