"""Streams as data: Annex-B bytes split into access units, the frozen
files and their sidecars, and the per-picture md5 that the sidecars hold.

Nothing here imports the program: the benchmark splits and checks the
bytes itself and hands them to the decoder unchanged.
"""
from __future__ import annotations

import hashlib
import json
import os

PS_NALS = (32, 33, 34)              # VPS, SPS, PPS
PREFIX_NALS = PS_NALS + (35, 39)    # + access unit delimiter, prefix SEI
START = b"\x00\x00\x00\x01"


def split_nals(data: bytes) -> list[bytes]:
    """The NAL units of an Annex-B byte stream, without start codes or
    trailing zero bytes."""
    out, i, n = [], 0, len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            return out
        start = j + 3
        k = data.find(b"\x00\x00\x01", start)
        end = n if k < 0 else k
        while end > start and data[end - 1] == 0 and k >= 0:
            end -= 1
        out.append(data[start:end])
        i = start


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def layer_id(nal: bytes) -> int:
    return ((nal[0] & 1) << 5) | (nal[1] >> 3)


def starts_picture(nal: bytes) -> bool:
    """A VCL NAL of layer 0 with first_slice_segment_in_pic_flag set."""
    return nal_type(nal) <= 31 and layer_id(nal) == 0 and len(nal) > 2 \
        and nal[2] >> 7 == 1


def access_units(data: bytes) -> list[bytes]:
    """The stream cut into access units, as a demuxer hands them to the
    decoder: an AU begins at the first slice of a layer-0 picture, or at
    the parameter sets, delimiter or prefix SEI just before it, and holds
    every layer's NALs up to the next one. Each NAL keeps a 4-byte start
    code."""
    aus, cur, seen_vcl = [], [], False
    for nal in split_nals(data):
        if len(nal) < 2:
            continue
        t = nal_type(nal)
        if seen_vcl and (starts_picture(nal) or
                         (t in PREFIX_NALS and layer_id(nal) == 0)):
            aus.append(b"".join(cur))
            cur, seen_vcl = [], False
        cur.append(START + nal)
        seen_vcl |= t <= 31
    if cur:
        aus.append(b"".join(cur))
    return aus


def first_frames(data: bytes, k: int) -> bytes:
    """The stream cut after its k-th VCL NAL (one slice per picture)."""
    out, vcl = [], 0
    for nal in split_nals(data):
        if nal_type(nal) <= 31:
            if vcl == k:
                break
            vcl += 1
        out.append(START + nal)
    return b"".join(out)


def file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_frozen(root: str, paths: list[str]) -> None:
    """Raise ValueError when a stream file differs from the md5 that
    SOURCES.json beside it records (the copies are frozen)."""
    for rel in paths:
        path = os.path.join(root, rel)
        with open(os.path.join(os.path.dirname(path), "SOURCES.json")) as f:
            want = json.load(f)["files"][os.path.basename(path)]["md5"]
        if file_md5(path) != want:
            raise ValueError(f"{rel} differs from its frozen md5 {want}")


def read_md5s(path: str) -> list[str]:
    with open(path) as f:
        return f.read().split()


class Stream:
    """One stream of a configuration's pool: its bytes cut into access
    units, the expected md5 of each output picture (`el`: the pictures
    the decoder returns, in output order) and, for two layers, of each
    base-layer picture (`bl`), both from the reference decoders'
    sidecars."""

    def __init__(self, root: str, entry: dict):
        self.name = entry["name"]
        with open(os.path.join(root, entry["file"]), "rb") as f:
            self.data = f.read()
        self.aus = access_units(self.data)
        self.el = read_md5s(os.path.join(root, entry["md5"]))
        self.bl = read_md5s(os.path.join(root, entry["bl_md5"])) \
            if entry.get("bl_md5") else None
        if len(self.el) != len(self.aus):
            raise ValueError(f"{self.name}: {len(self.aus)} access units "
                             f"but {len(self.el)} sidecar lines")


def hash_planes(planes, bit_depth: int) -> str:
    """md5 of cropped Y, U, V planes as the sidecars hash them: uint8
    samples, or uint16 when the bit depth is above 8."""
    import numpy as np
    dt = np.uint16 if bit_depth > 8 else np.uint8
    h = hashlib.md5()
    for plane in planes:
        h.update(np.ascontiguousarray(np.asarray(plane, dt)).tobytes())
    return h.hexdigest()


def crop(planes, sps):
    """The cropped [Y, Cb, Cr] of uncropped planes (the conformance
    window of `sps`)."""
    y, cb, cr = planes
    H, W = sps.height, sps.width
    cl, cr_, ct, cbm = sps.crop_left, sps.crop_right, sps.crop_top, \
        sps.crop_bottom
    hs, vs = sps.hshift1, sps.vshift1
    return [y[ct:H - cbm, cl:W - cr_],
            cb[ct >> vs:(H - cbm) >> vs, cl >> hs:(W - cr_) >> hs],
            cr[ct >> vs:(H - cbm) >> vs, cl >> hs:(W - cr_) >> hs]]


def hash_pics(pics) -> list[str]:
    """Per-picture md5 of decoded pictures (`.planes`, `.sps`)."""
    return [hash_planes(crop(list(p.planes), p.sps), p.sps.bit_depth)
            for p in pics]
