"""SEI parsing/writing — decoded picture hash (conformance MD5).

Parity: ff_hevc_decode_nal_sei / decode_nal_sei_decoded_picture_hash
(hevc_sei.c:28). The hash drives the same per-frame conformance check the
reference CLI enables by default (verify_md5, hevc.c:4045).
"""
from __future__ import annotations

import hashlib

import numpy as np

from .bits import BitWriter, wrap_nal

SEI_TYPE_PIC_TIMING = 1
SEI_TYPE_FRAME_PACKING = 45
SEI_TYPE_ACTIVE_PARAMETER_SETS = 129
SEI_TYPE_DECODED_PICTURE_HASH = 132
NAL_SEI_SUFFIX = 40


def parse_sei(rbsp: bytes):
    """Returns list of (payload_type, payload bytes)."""
    out = []
    i = 0
    n = len(rbsp)
    while i + 1 < n:
        ptype = 0
        while i < n and rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        if i >= n:
            break
        ptype += rbsp[i]
        i += 1
        psize = 0
        while i < n and rbsp[i] == 0xFF:
            psize += 255
            i += 1
        if i >= n:
            break
        psize += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i:i + psize]))
        i += psize
        if i < n and rbsp[i] == 0x80:  # rbsp stop
            break
    return out


def parse_picture_hash(payload: bytes):
    """-> list of 16-byte MD5 digests per plane (hash_type 0) or None."""
    if not payload or payload[0] != 0:  # only MD5 supported
        return None
    md5s = []
    i = 1
    while i + 16 <= len(payload):
        md5s.append(payload[i:i + 16])
        i += 16
    return md5s


def plane_md5(plane: np.ndarray, bit_depth: int) -> bytes:
    """MD5 over the plane bytes as the reference computes it
    (calc_md5, hevc.c:4623: row-major, 16-bit little-endian when >8 bit)."""
    if bit_depth > 8:
        data = plane.astype("<u2").tobytes()
    else:
        data = plane.astype(np.uint8).tobytes()
    return hashlib.md5(data).digest()


def write_picture_hash_sei(planes, bit_depth: int) -> bytes:
    """Suffix SEI NAL carrying per-plane MD5 of the decoded picture."""
    payload = bytes([0])  # hash_type = 0 (MD5)
    for p in planes:
        payload += plane_md5(p, bit_depth)
    bw = BitWriter()
    t = SEI_TYPE_DECODED_PICTURE_HASH
    while t >= 255:
        bw.put(0xFF, 8)
        t -= 255
    bw.put(t, 8)
    sz = len(payload)
    while sz >= 255:
        bw.put(0xFF, 8)
        sz -= 255
    bw.put(sz, 8)
    for b in payload:
        bw.put(b, 8)
    bw.align_one_then_zero()
    return wrap_nal(NAL_SEI_SUFFIX, bw.getvalue())


def parse_frame_packing(payload: bytes) -> dict | None:
    """SEI frame-packing arrangement (D.3.16;
    decode_nal_sei_frame_packing_arrangement, hevc_sei.c:52)."""
    from .bits import BitReader
    r = BitReader(payload)
    r.ue()                          # frame_packing_arrangement_id
    present = not r.read1()         # cancel flag
    if not present:
        return None
    out = {"arrangement_type": r.read(7),
           "quincunx_subsampling": r.read1(),
           "content_interpretation_type": r.read(6)}
    r.read(6)                       # flipping/field/frame0 flags
    if not out["quincunx_subsampling"] and out["arrangement_type"] != 5:
        r.read(16)                  # grid positions
    r.read(8)                       # reserved byte
    out["persistence"] = r.read1()
    return out


def parse_pic_timing(payload: bytes, frame_field_info_present: bool):
    """SEI picture timing (D.3.2; decode_pic_timing, hevc_sei.c:77):
    returns pic_struct or None."""
    if not frame_field_info_present or not payload:
        return None
    from .bits import BitReader
    r = BitReader(payload)
    return r.read(4)                # pic_struct


def parse_active_parameter_sets(payload: bytes) -> dict:
    """SEI active parameter sets (D.3.19; active_parameter_sets,
    hevc_sei.c:110): the active VPS + SPS ids."""
    from .bits import BitReader
    r = BitReader(payload)
    out = {"active_vps_id": r.read(4)}
    r.read(2)                       # self_contained + no_update flags
    n = r.ue() + 1                  # num_sps_ids_minus1 + 1
    out["active_sps_ids"] = [r.ue() for _ in range(n)]
    return out
