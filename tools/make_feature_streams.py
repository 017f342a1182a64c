#!/usr/bin/env python3
"""Write the feature-matrix streams `feature_streams/<name>.265`, their
per-picture md5 sidecars and `feature_streams/MANIFEST.json`.

    python tools/make_feature_streams.py                 # every stream
    python tools/make_feature_streams.py --tier B        # the small ones
    python tools/make_feature_streams.py --only 422_p ccp --jobs 4

A tool, not part of the port: it imports the JAX package (its encoder,
`openhevc_tpu/encoder/`, and its scalar decoder `Decoder("np")`) and runs
on a machine with JAX; the streams it writes are committed, so that
machines without JAX decode them (`chip_smoke.py`'s feature-matrix phase
on the GPU, `tests/test_torch_feature_streams.py` on the CPU).

Each stream is encoded from its manifest entry alone (`encode_entry`):
the encoder function and its keyword arguments, the picture maker and
its arguments (pictures come from a seed, with numpy), and an optional
edit of the finished stream (a dropped picture, a flipped SPS flag).
Tier B streams are the cases of the port's CPU tests, with the same
keyword arguments and seeds, so the card and the CPU hold the same
bitstreams; Tier A streams are two 1920x1080 streams of the formats
their users run.

The sidecar holds one md5 a picture in output order, hashed as
`bench_torch.hash_pics` hashes (the cropped Y, U, V planes as uint8, or
uint16 above 8 bits). It comes from `openhevc_tpu.decoder.Decoder("np")`
(native parse), never from the encoder's returned reconstruction (at 10
bits and on tiled inter streams that is not the decode of its own
stream). The same decode records, per picture in decode order, the route
the port is expected to take (`routes`): the parse (native / python), the
in-loop filters (none / device / host: the JAX package's `prep_filters`
giving up), the intra kernel's plan (whole / banded / no_band_plan: the
JAX package's gates, `FUSED_VMEM_BUDGET` and `band_plan`), the number of
intra jobs and whether the picture has inter blocks.

    python tools/make_feature_streams.py --shvc          # two layers

writes the two-layer (SHVC) streams instead, into feature_streams/shvc/
with a manifest of their own (`shvc_entries`): tier B, the two-layer
cases of the CPU tests (tests/test_torch_shvc.py TWO_LAYER and
tests/test_shvc.py's SNR case with every inter-layer tool); tier A,
a 1080p enhancement layer (EL) over 2x, 1.5x and SNR base layers (BL), as
in the SHVC common test conditions. Each has two sidecars, the EL
pictures from the JAX package's `ShvcDecoder("np")` and the BL pictures
from its `Decoder("np")` on layer 0, and per layer the routes above plus
the MC mode, whether the inter-layer picture is a reference and whether
it is TMVP's collocated picture."""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "feature_streams")
MANIFEST = "MANIFEST.json"

# The feature families every manifest must cover (the test holds it):
# each appears in the `features` of at least one stream.
FAMILIES = (
    "422", "bit12", "444_inter", "444_filters", "pcm",
    "pcm_loop_filter_disabled", "lossless", "transform_skip", "rdpcm",
    "rotation", "persistent_rice", "scaling_lists", "ccp",
    "weighted_prediction", "constrained_intra", "intra_smoothing_disabled",
    "ctb16", "ctb32", "ctb16_chroma_halo", "long_term", "multi_slice",
    "concealment", "all_inter")

# What the in-repo encoder cannot write, named once for the manifest.
NOT_ENCODABLE = {
    "explicit_rdpcm": "the encoder's inter path codes no transform skip "
                      "or bypass residual, so no explicit RDPCM flag",
    "pcm_inter": "encode_lowdelay_stream / encode_ra_stream disable PCM",
    "ccp_inter": "encode_lowdelay_stream / encode_ra_stream take no "
                 "cross_component option",
    "transform_skip_inter": "encode_lowdelay_stream takes no "
                            "transform_skip option",
}


# ---- picture makers -----------------------------------------------------------
# fmt_frames and ramps12 are also tests/test_torch_rext.py's makers; ramps
# and noise_fmt copy makers of pre-port tests, and
# tests/test_torch_feature_streams.py holds each copy to its original.

def ramps(W, H, n, seed, smooth=True, bd=8):
    """tests/conftest.py `make_frames` (a ramp plus noise, or noise), the
    planes shifted up to `bd` bits as the port's tests shift them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    fr = []
    for i in range(n):
        if smooth:
            y = ((xx * 2 + yy * 3 + i * 10) % 256 * 0.7 +
                 rng.integers(0, 60, (H, W))).astype(np.uint8)
        else:
            y = rng.integers(0, 256, (H, W), dtype=np.uint8)
        u = ((xx[::2, ::2] + i * 7 + 128) % 256).astype(np.uint8)
        v = ((yy[::2, ::2] * 2 + i * 3) % 256).astype(np.uint8)
        fr.append((y, u, v))
    if bd > 8:
        fr = [tuple(p.astype(np.uint16) << (bd - 8) for p in f) for f in fr]
    return fr


def fmt_frames(W, H, n, seed, idc=1, bd=8, moving=False):
    """Seeded random pictures of one chroma format and depth; moving:
    windows over a larger one (tests/test_torch_rext.py `frames_fmt`)."""
    rng = np.random.default_rng(seed)
    cw = W if idc == 3 else W // 2
    ch = H // 2 if idc == 1 else H
    dt = np.uint16 if bd > 8 else np.uint8
    if not moving:
        return [tuple(rng.integers(0, 1 << bd, shp).astype(dt)
                      for shp in ((H, W), (ch, cw), (ch, cw)))
                for _ in range(n)]
    base = [rng.integers(0, 1 << bd, (2 * h, 2 * w)).astype(dt)
            for h, w in ((H, W), (ch, cw), (ch, cw))]
    out = []
    for _ in range(n):
        dx, dy = int(rng.integers(0, W // 2)), int(rng.integers(0, H // 2))
        sx, sy = W // cw, H // ch
        out.append((base[0][dy:dy + H, dx:dx + W].copy(),
                    base[1][dy // sy:dy // sy + ch,
                            dx // sx:dx // sx + cw].copy(),
                    base[2][dy // sy:dy // sy + ch,
                            dx // sx:dx // sx + cw].copy()))
    return out


def ramps12(W, H, n, seed, chroma_full=False):
    """12-bit ramps plus noise (tests/test_torch_rext.py `frames12`)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    cs = slice(None) if chroma_full else slice(None, None, 2)
    out = []
    for i in range(n):
        y = ((xx * 32 + yy * 48 + i * 160) % 4096 * 0.7 +
             rng.integers(0, 960, (H, W))).astype(np.uint16)
        out.append((y, ((xx[cs, cs] * 16 + 2048) % 4096).astype(np.uint16),
                    ((yy[cs, cs] * 32) % 4096).astype(np.uint16)))
    return out


def noise_fmt(W, H, n, seed, fmt):
    """tests/test_device_filters.py `_frames_fmt`: 8-bit noise of one
    chroma format."""
    rng = np.random.default_rng(seed)
    cw = W if fmt == 3 else W // 2
    ch = H if fmt >= 2 else H // 2
    return [(rng.integers(0, 256, (H, W)).astype(np.uint8),
             rng.integers(0, 256, (ch, cw)).astype(np.uint8),
             rng.integers(0, 256, (ch, cw)).astype(np.uint8))
            for _ in range(n)]


def smooth_moving(W, H, n, seed, idc=1, bd=8, step=(3, 2)):
    """Smooth content under a camera pan: one larger picture of a few
    low-frequency waves per plane (periods of 100-700 samples) and a
    little noise, read through a window that moves `step` (dx, dy)
    samples a picture. Cheap to code, and inter prediction finds it."""
    rng = np.random.default_rng(seed)
    dx, dy = step
    BH, BW = H + dy * n + 8, W + dx * n + 8
    sy, sx = (1 if idc >= 2 else 2), (1 if idc == 3 else 2)
    top = (1 << bd) - 1

    def plane(h, w, scale_y, scale_x):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        yy, xx = yy * scale_y, xx * scale_x
        acc = np.zeros((h, w))
        for _ in range(4):
            fy, fx = rng.uniform(-1, 1, 2) * 2 * np.pi / \
                rng.uniform(100, 700)
            acc += np.cos(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
        acc = 0.5 + 0.11 * acc + rng.normal(0, 0.004, (h, w))
        return np.clip(np.rint(acc * top), 0, top)

    dt = np.uint16 if bd > 8 else np.uint8
    big = [plane(BH, BW, 1, 1), plane(BH // sy, BW // sx, sy, sx),
           plane(BH // sy, BW // sx, sy, sx)]
    out = []
    for i in range(n):
        oy, ox = dy * i, dx * i
        out.append((big[0][oy:oy + H, ox:ox + W].astype(dt),
                    big[1][oy // sy:oy // sy + H // sy,
                           ox // sx:ox // sx + W // sx].astype(dt),
                    big[2][oy // sy:oy // sy + H // sy,
                           ox // sx:ox // sx + W // sx].astype(dt)))
    return out


MAKERS = {"ramps": ramps, "fmt_frames": fmt_frames, "ramps12": ramps12,
          "noise_fmt": noise_fmt, "smooth_moving": smooth_moving}


# ---- the streams -------------------------------------------------------------

def _pics(maker, W, H, n, seed, **kw):
    return dict(maker=maker, W=W, H=H, n=n, seed=seed, **kw)


def _rext(kind, W=64, H=64, seed=0, **kw):
    """tests/test_torch_rext.py `stream`: (encoder, kwargs, pictures)."""
    idc, bd = kw.get("chroma_format_idc", 1), kw.get("bit_depth", 8)
    if kind == "lowdelay":
        return ("encode_lowdelay_stream",
                dict(seed=seed, qp=30, ctb_log2=4, **kw),
                _pics("fmt_frames", W, H, 4, seed, idc=idc, bd=bd,
                      moving=True))
    smooth = kw.pop("smooth", None)
    if smooth is not None:
        pics = _pics("ramps", W, H, 2, seed, smooth=smooth, bd=bd)
    elif bd == 12:
        pics = _pics("ramps12", W, H, 2, seed, chroma_full=idc == 3)
    else:
        pics = _pics("fmt_frames", W, H, 2, seed, idc=idc, bd=bd)
    kw.setdefault("ctb_log2", 4)
    return "encode_intra_stream", dict(seed=seed, **kw), pics


def _lowdelay(seed=21, n=4, W=64, H=64, **kw):
    """tests/test_torch_inter.py `lowdelay`."""
    kw = dict(dict(qp=32, ctb_log2=4), **kw)
    return ("encode_lowdelay_stream", dict(seed=seed, **kw),
            _pics("ramps", W, H, n, seed, bd=kw.get("bit_depth", 8)))


def _ra(seed=31, n=9, W=64, H=64, **kw):
    """tests/test_torch_inter.py `random_access`."""
    kw = dict(dict(qp=31, gop=8, ctb_log2=4), **kw)
    return ("encode_ra_stream", dict(seed=seed, **kw),
            _pics("ramps", W, H, n, seed, bd=kw.get("bit_depth", 8)))


def _filtered(W, H, seed, maker="ramps", fmt=1, **kw):
    """tests/test_torch_filters.py's intra streams: noise pictures, QP
    34, the filters as given."""
    pics = _pics("ramps", W, H, 2, seed, smooth=False) if maker == "ramps" \
        else _pics("noise_fmt", W, H, 2, seed, fmt=fmt)
    return "encode_intra_stream", dict(dict(qp=34, seed=seed), **kw), pics


def _intra(W, H, seed=5, n=2, **kw):
    """tests/test_torch_parse.py `encode` (tests/test_torch_decoder.py)."""
    return ("encode_intra_stream", dict(seed=seed, **kw),
            _pics("ramps", W, H, n, seed))


def _tier_b():
    """name -> (encoder, kwargs, pictures, source, edit)."""
    out = {}

    def add(name, spec, source, edit=None):
        out[name] = (*spec, source, edit)

    rext = "tests/test_torch_rext.py CASES"
    for name, (kind, kw) in {
        "444_nxn": ("intra", dict(seed=41, qp=30, chroma_format_idc=3)),
        "444_filters": ("intra", dict(seed=42, qp=32, chroma_format_idc=3,
                                      sao=True, deblock=True)),
        "444_ten_bit": ("intra", dict(seed=43, qp=30, chroma_format_idc=3,
                                      bit_depth=10)),
        "444_tskip": ("intra", dict(seed=44, qp=30, chroma_format_idc=3,
                                    transform_skip=True)),
        "444_bypass": ("intra", dict(seed=45, qp=30, chroma_format_idc=3,
                                     transquant_bypass=True)),
        "444_tu32": ("intra", dict(seed=46, qp=34, chroma_format_idc=3,
                                   W=96, ctb_log2=5)),
        "444_p": ("lowdelay", dict(seed=51, chroma_format_idc=3, n_refs=1)),
        "444_b_filters": ("lowdelay", dict(seed=52, chroma_format_idc=3,
                                           n_refs=2, b_slices=True, sao=True,
                                           deblock=True)),
        "422_nxn": ("intra", dict(seed=11, qp=26, chroma_format_idc=2)),
        "422_tu_pairs": ("intra", dict(seed=12, qp=34, chroma_format_idc=2,
                                       W=96, ctb_log2=5)),
        "422_filters": ("intra", dict(seed=13, qp=30, chroma_format_idc=2,
                                      sao=True, deblock=True)),
        "422_ten_bit": ("intra", dict(seed=14, qp=30, chroma_format_idc=2,
                                      bit_depth=10)),
        "422_tskip": ("intra", dict(seed=15, qp=30, chroma_format_idc=2,
                                    transform_skip=True)),
        "422_bypass": ("intra", dict(seed=16, qp=30, chroma_format_idc=2,
                                     transquant_bypass=True)),
        "422_pcm": ("intra", dict(seed=17, qp=30, chroma_format_idc=2,
                                  pcm=True)),
        "422_p": ("lowdelay", dict(seed=21, chroma_format_idc=2, n_refs=1)),
        "422_b_filters_tmvp": ("lowdelay", dict(
            seed=22, chroma_format_idc=2, n_refs=2, b_slices=True, sao=True,
            deblock=True, tmvp=True)),
        "422_b_weighted": ("lowdelay", dict(seed=23, chroma_format_idc=2,
                                            n_refs=2, b_slices=True,
                                            weighted=True)),
        "tools_rice": ("intra", dict(seed=141, qp=10, smooth=False,
                                     transform_skip=True,
                                     rext_persistent_rice=True)),
        "tools_rotation": ("intra", dict(seed=141, qp=30, smooth=False,
                                         transform_skip=True,
                                         rext_rotation=True)),
        "tools_rot_rdpcm": ("intra", dict(seed=141, qp=28, smooth=False,
                                          transform_skip=True,
                                          rext_rotation=True,
                                          rext_implicit_rdpcm=True)),
        "tools_lossless_rdpcm": ("intra", dict(seed=141, qp=26, smooth=False,
                                               transquant_bypass=True,
                                               rext_implicit_rdpcm=True)),
        "tools_all": ("intra", dict(seed=141, qp=12, smooth=False,
                                    transform_skip=True,
                                    transquant_bypass=True,
                                    rext_rotation=True,
                                    rext_implicit_rdpcm=True,
                                    rext_persistent_rice=True)),
        "ccp": ("intra", dict(seed=151, qp=30, chroma_format_idc=3,
                              cross_component=True)),
        "main12": ("intra", dict(seed=181, qp=30, bit_depth=12)),
        "main12_filters": ("intra", dict(seed=182, qp=26, bit_depth=12,
                                         ctb_log2=5, sao=True, deblock=True)),
        "main444_12": ("intra", dict(seed=183, qp=30, bit_depth=12,
                                     chroma_format_idc=3)),
        "sl_default_deblock": ("intra", dict(seed=1, qp=30, smooth=True,
                                             scaling_list="default",
                                             deblock=True)),
        "sl_default_sao": ("intra", dict(seed=1, qp=30, smooth=True,
                                         scaling_list="default", sao=True)),
        "twelve_bit_smooth": ("intra", dict(seed=1, qp=30, bit_depth=12)),
        "sl_sps": ("intra", dict(seed=11, qp=30, smooth=True,
                                 scaling_list="sps")),
        "sl_pps_filters_tu32": ("intra", dict(seed=12, qp=26, smooth=True,
                                              scaling_list="pps", ctb_log2=5,
                                              sao=True, deblock=True)),
        "sl_sps_444": ("intra", dict(seed=13, qp=30, chroma_format_idc=3,
                                     scaling_list="sps")),
        "sl_sps_p": ("lowdelay", dict(seed=31, scaling_list="sps")),
    }.items():
        add(name, _rext(kind, **kw), rext)

    inter = "tests/test_torch_inter.py LOWDELAY"
    for name, kw in {
        "ld_p": dict(),
        "ld_two_refs": dict(n_refs=2, max_merge=3),
        "ld_b_weighted_tmvp": dict(b_slices=True, weighted=True, tmvp=True,
                                   n_refs=2),
        "ld_constrained_intra": dict(constrained_intra=True),
        "ld_wpp_amp": dict(wpp=True, amp=True, W=128),
        "ld_long_term": dict(lt_ref=True, n_refs=2),
        "ld_two_slices": dict(num_slices=2),
        "ld_ctb32": dict(ctb_log2=5, W=96),
        "ld_ten_bit": dict(bit_depth=10),
        "ld_ten_bit_weighted_b": dict(bit_depth=10, weighted=True,
                                      b_slices=True),
    }.items():
        add(name, _lowdelay(**kw), inter)
    ra = "tests/test_torch_inter.py RANDOM_ACCESS"
    for name, kw in {
        "ra": dict(),
        "ra_tmvp_wpp": dict(tmvp=True, wpp=True),
        "ra_tiles": dict(tile_cols=2, tile_rows=2, W=128),
        "ra_weighted": dict(weighted=True),
        "ra_cra": dict(intra_period=8, n=17),
        "ra_ten_bit": dict(bit_depth=10, ctb_log2=5),
    }.items():
        add(name, _ra(**kw), ra)
    add("all_inter", _lowdelay(seed=8, W=32, H=32),
        "tests/test_torch_inter.py _all_inter_stream")
    add("concealment", _lowdelay(seed=111),
        "tests/test_torch_inter.py test_missing_reference_is_concealed_like_np",
        edit=dict(drop_picture=1))

    filt = "tests/test_torch_filters.py"
    for name, (kw, src) in {
        "f_ctb16": (dict(W=64, H=64, seed=3, ctb_log2=4, sao=True,
                         deblock=True), "INTRA_FILTERED ctb16"),
        "f_ctb32_wpp": (dict(W=128, H=64, seed=3, ctb_log2=5, wpp=True,
                             sao=True, deblock=True),
                        "INTRA_FILTERED ctb32_wpp"),
        "f_ctb64": (dict(W=128, H=128, seed=3, ctb_log2=6, sao=True,
                         deblock=True), "INTRA_FILTERED ctb64"),
        "f_pcm": (dict(W=64, H=64, seed=3, ctb_log2=4, pcm=True, sao=True,
                       deblock=True), "INTRA_FILTERED pcm"),
        "f_tqb": (dict(W=64, H=64, seed=3, ctb_log2=5,
                       transquant_bypass=True, sao=True, deblock=True),
                  "INTRA_FILTERED tqb"),
        "f_halo_ctb16": (dict(W=64, H=64, seed=2, ctb_log2=4, pcm=False,
                              sao=True, deblock=True),
                         "MATRIX_420 16x16 CTB halo quirk"),
        "f_pcm_deblock_only": (dict(W=64, H=64, seed=7, ctb_log2=4, pcm=True,
                                    sao=False, deblock=True),
                               "MATRIX_420 deblock-only + pcm"),
        "f_pcm_sao_only": (dict(W=64, H=64, seed=8, ctb_log2=4, pcm=True,
                                sao=True, deblock=False),
                           "MATRIX_420 sao-only + pcm"),
        "f_tqb_pcm_ctb16": (dict(W=64, H=64, seed=6, ctb_log2=4, pcm=True,
                                 transquant_bypass=True, sao=True,
                                 deblock=True),
                            "MATRIX_420 everything at once"),
    }.items():
        add(name, _filtered(**kw), f"{filt} {src}")
    for name, (fmt, W, seed, ctb, pcm) in {
        "f_422_ctb16_sao_pcm": (2, 96, 42, 4, True),
        "f_444_ctb16_sao": (3, 96, 41, 4, False),
    }.items():
        add(name, _filtered(W, 64, seed, maker="noise_fmt", fmt=fmt,
                            ctb_log2=ctb, pcm=pcm, sao=True, deblock=True,
                            chroma_format_idc=fmt, min_cb_log2=3),
            f"{filt} MATRIX_FMT")
    # PCM kept out of the filters: one picture (the reference decoder's
    # no-filter map is never reset between pictures, a known quirk that
    # only a single picture avoids)
    add("f_pcm_lf_disabled", (
        "encode_intra_stream",
        dict(qp=34, seed=4, ctb_log2=5, pcm=True, sao=True, deblock=True,
             pcm_loop_filter_disabled=True),
        _pics("ramps", 64, 64, 1, 4, smooth=False)),
        f"{filt} MATRIX_420 pcm, with pcm_loop_filter_disabled, one picture")

    dec = "tests/test_torch_decoder.py CASES"
    add("pcm", _intra(64, 64, qp=26, ctb_log2=4, pcm=True), dec)
    add("wpp_dct32", _intra(128, 64, qp=37, ctb_log2=6, wpp=True), dec)
    add("tiles_25_cols", _intra(400, 64, seed=3, qp=30, ctb_log2=4,
                                tile_cols=25),
        "tests/test_torch_fallback.py 25 tile columns (past the native "
        "core's 24: the Python parser)")
    add("pcm_only", ("encode_pcm_stream", {},
                     _pics("ramps", 64, 64, 2, 9)),
        "encode_pcm_stream: every CTB one PCM CU")
    add("intra_smoothing_disabled",
        _intra(64, 64, seed=61, qp=30, ctb_log2=5, transform_skip=True,
               rext_implicit_rdpcm=True),
        "tests/test_torch_parse.py encode, with the SPS's "
        "intra_smoothing_disabled_flag set after encoding",
        edit=dict(intra_smoothing_disabled=True))
    return out


def _tier_a():
    return {
        # Main 4:2:2 10: broadcast production and contribution
        "f422_10b_1080p_ld": (
            "encode_lowdelay_stream",
            dict(seed=7, qp=32, ctb_log2=5, bit_depth=10,
                 chroma_format_idc=2, n_refs=2, b_slices=True, tmvp=True,
                 weighted=True, sao=True, deblock=True, wpp=True),
            _pics("smooth_moving", 1920, 1080, 5, 7, idc=2, bd=10),
            "Main 4:2:2 10 at 1080p: low-delay B, two references, TMVP, "
            "weighted prediction, deblock + SAO, WPP", None),
        # Main 4:4:4: screen content and graphics
        "f444_8b_1080p_ld": (
            "encode_lowdelay_stream",
            dict(seed=8, qp=30, ctb_log2=6, chroma_format_idc=3, n_refs=1,
                 sao=True, deblock=True),
            _pics("smooth_moving", 1920, 1080, 5, 8, idc=3, bd=8),
            "Main 4:4:4 at 1080p: low-delay P, deblock + SAO; transform "
            "skip and RDPCM dropped (not_encodable)", None),
    }


def entries():
    """name -> manifest entry (without the fields a decode fills in)."""
    out = {}
    for tier, table in (("B", _tier_b()), ("A", _tier_a())):
        for name, (encoder, kw, pics, source, edit) in table.items():
            out[name] = dict(name=name, tier=tier, encoder=encoder,
                             kwargs=kw, pictures=pics, edit=edit or {},
                             source=source)
    return out


# ---- encoding from an entry ---------------------------------------------------

def make_pictures(spec):
    spec = dict(spec)
    maker = MAKERS[spec.pop("maker")]
    return maker(spec.pop("W"), spec.pop("H"), spec.pop("n"),
                 spec.pop("seed"), **spec)


def _nals(data):
    from openhevc_tpu.decoder import split_nals
    return split_nals(data)


def _join(nals):
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def _vcl(nal):
    return ((nal[0] >> 1) & 0x3F) <= 31


def _set_intra_smoothing_disabled(data):
    """The stream with its SPS's intra_smoothing_disabled_flag set: the
    flag's bit is the one whose flip changes that field of the parsed
    SPS and nothing else (the SPS must carry the range extension)."""
    from openhevc_tpu.bitstream.bits import escape_rbsp, unescape_rbsp
    from openhevc_tpu.bitstream.ps import parse_sps
    nals = _nals(data)
    i = next(k for k, n in enumerate(nals) if ((n[0] >> 1) & 0x3F) == 33)
    rbsp = bytearray(unescape_rbsp(nals[i][2:]))
    want = vars(parse_sps(bytes(rbsp)))
    if want["intra_smoothing_disabled"]:
        raise ValueError("the SPS has intra_smoothing_disabled_flag set")
    for bit in range(len(rbsp) * 8):
        rbsp[bit >> 3] ^= 0x80 >> (bit & 7)
        try:
            got = vars(parse_sps(bytes(rbsp)))
        except (ValueError, IndexError):    # a flip that breaks the SPS
            got = None
        if got is not None and got["intra_smoothing_disabled"] == 1 and \
                {k: v for k, v in got.items()
                 if k != "intra_smoothing_disabled"} == \
                {k: v for k, v in want.items()
                 if k != "intra_smoothing_disabled"}:
            nals[i] = nals[i][:2] + escape_rbsp(bytes(rbsp))
            return _join(nals)
        rbsp[bit >> 3] ^= 0x80 >> (bit & 7)
    raise ValueError("no intra_smoothing_disabled_flag bit in the SPS")


def apply_edit(data, edit):
    if edit.get("drop_picture") is not None:
        k, nals = edit["drop_picture"], _nals(data)
        vcl = [i for i, n in enumerate(nals) if _vcl(n)]
        data = _join([n for i, n in enumerate(nals) if i != vcl[k]])
    if edit.get("intra_smoothing_disabled"):
        data = _set_intra_smoothing_disabled(data)
    return data


def encode_entry(entry) -> bytes:
    """The stream's bytes from its manifest entry alone."""
    from openhevc_tpu.encoder import hevc_enc, inter_enc, intra_enc
    fn = {"encode_intra_stream": intra_enc.encode_intra_stream,
          "encode_lowdelay_stream": inter_enc.encode_lowdelay_stream,
          "encode_ra_stream": inter_enc.encode_ra_stream,
          "encode_pcm_stream": hevc_enc.encode_pcm_stream}[entry["encoder"]]
    pics = make_pictures(entry["pictures"])
    W, H = entry["pictures"]["W"], entry["pictures"]["H"]
    out = fn(pics, W, H, **entry["kwargs"])
    data = out[0] if isinstance(out, tuple) else out
    return apply_edit(data, entry["edit"])


# ---- the sidecar and the routes -------------------------------------------------

def _plan(fs):
    """The JAX package's kernel plan for this picture's size, on any
    backend: whole, banded, or no_band_plan (past the whole-frame gate
    with no band plan: the port's whole-frame kernel)."""
    from openhevc_tpu.models.pipeline import JaxEngine
    from openhevc_tpu.ops.intra_fused import band_plan, padded_dims
    sps = fs.sps
    H, W = sps.height, sps.width
    Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
    hl, wl = padded_dims(H, W)
    hc, wc = padded_dims(Hc, Wc)
    if (hl * wl + 2 * hc * wc) * 4 * 2 <= JaxEngine.FUSED_VMEM_BUDGET:
        return "whole"
    if band_plan(H, W, Hc, Wc, sps.ctb_size, sps.vshift1) is None:
        return "no_band_plan"
    return "banded"


def _filters(fs):
    from openhevc_tpu.ops.filters_jax import device_filters_ok, prep_filters
    if fs.deblock_disabled and not (fs.sao_luma or fs.sao_chroma):
        return "none"
    ok = device_filters_ok(fs) and prep_filters(fs) is not None
    return "device" if ok else "host"


def reference_decode(data):
    """(md5 a picture in output order, routes a picture in decode order,
    python slices) from the JAX package's decoder with the native parse."""
    from bench_torch import hash_pics
    from openhevc_tpu.decoder import Decoder

    class Recording(Decoder):
        def _reconstruct(self, fs, refs):
            raw = fs.native_raw
            self.routes.append(dict(
                poc=int(fs.poc),
                parse="native" if raw is not None else "python",
                filters=_filters(fs), plan=_plan(fs),
                jobs=int(len(raw["ij_meta"]) if raw is not None
                         else len(fs.intra_jobs)),
                inter=bool(fs.inter_pbs), pcm=len(fs.pcm_blocks)))
            return super()._reconstruct(fs, refs)

    d = Recording("np", native_parse=True)
    d.routes = []
    pics = d.decode(data) + d.flush()
    return hash_pics(pics), d.routes, d.stats["python_slices"], pics


def _features(entry, routes):
    """Feature tags from the entry's options and its decode's routes."""
    kw, edit = entry["kwargs"], entry["edit"]
    enc, tags = entry["encoder"], set()
    idc, bd = kw.get("chroma_format_idc", 1), kw.get("bit_depth", 8)
    inter = enc in ("encode_lowdelay_stream", "encode_ra_stream")
    filters = kw.get("sao") or kw.get("deblock")
    tags.add({1: "420", 2: "422", 3: "444"}[idc])
    tags.add(f"bit{bd}")
    tags.add("inter" if inter else "intra")
    if idc == 3 and inter:
        tags.add("444_inter")
    if idc == 3 and filters:
        tags.add("444_filters")
    if enc == "encode_pcm_stream":
        tags.add("pcm")
    ctb = kw.get("ctb_log2", 4)
    tags.add(f"ctb{1 << ctb}")
    for opt, tag in (("pcm", "pcm"), ("transquant_bypass", "lossless"),
                     ("transform_skip", "transform_skip"),
                     ("rext_implicit_rdpcm", "rdpcm"),
                     ("rext_rotation", "rotation"),
                     ("rext_persistent_rice", "persistent_rice"),
                     ("scaling_list", "scaling_lists"),
                     ("cross_component", "ccp"),
                     ("weighted", "weighted_prediction"),
                     ("constrained_intra", "constrained_intra"),
                     ("lt_ref", "long_term"), ("tmvp", "tmvp"),
                     ("wpp", "wpp"), ("amp", "amp"), ("b_slices", "b_slices"),
                     ("sao", "sao"), ("deblock", "deblock"),
                     ("intra_period", "cra")):
        if kw.get(opt):
            tags.add(tag)
    if kw.get("pcm") and kw.get("pcm_loop_filter_disabled") and filters:
        tags.add("pcm_loop_filter_disabled")
    if kw.get("num_slices", 1) > 1:
        tags.add("multi_slice")
    if kw.get("tile_cols", 1) * kw.get("tile_rows", 1) > 1:
        tags.add("tiles")
    if kw.get("n_refs", 1) > 1:
        tags.add("two_refs")
    if enc == "encode_ra_stream":
        tags.add("random_access")
    if ctb == 4 and kw.get("sao") and kw.get("deblock"):
        tags.add("ctb16_chroma_halo")
    if edit.get("drop_picture") is not None:
        tags.add("concealment")
    if edit.get("intra_smoothing_disabled"):
        tags.add("intra_smoothing_disabled")
    if any(r["inter"] and r["jobs"] == 0 for r in routes):
        tags.add("all_inter")
    return sorted(tags)


def make_stream(entry, out_dir=OUT_DIR):
    """Encode one entry, write its stream and sidecar, and return the
    entry completed from its decode."""
    t0 = time.perf_counter()
    data = encode_entry(entry)
    t1 = time.perf_counter()
    md5s, routes, py_slices, pics = reference_decode(data)
    t2 = time.perf_counter()
    name = entry["name"]
    with open(os.path.join(out_dir, f"{name}.265"), "wb") as f:
        f.write(data)
    with open(os.path.join(out_dir, f"{name}.265.md5"), "w") as f:
        f.write("".join(h + "\n" for h in md5s))
    sps = pics[0].sps
    entry = dict(entry)
    entry.update(
        width=int(sps.width), height=int(sps.height),
        chroma_format_idc=int(sps.chroma_format_idc),
        bit_depth=int(sps.bit_depth), ctb_size=int(sps.ctb_size),
        frames=len(md5s), bytes=len(data),
        sidecar="openhevc_tpu.decoder.Decoder('np'), native parse",
        python_slices=int(py_slices), routes=routes,
        features=_features(entry, routes))
    print(f"{name}: {len(md5s)} pictures, {len(data)} B, encode "
          f"{t1 - t0:.1f} s, sidecar {t2 - t1:.1f} s", flush=True)
    return entry


# ---- two-layer (SHVC) streams: feature_streams/shvc/ -------------------------
# Each entry is one `encode_shvc_stream` call (the JAX package's SHVC
# encoder: an intra or low-delay P base layer (BL), an enhancement layer
# (EL) predicted from the upsampled BL picture of its access unit (AU)).
# Two sidecars, both from the JAX package's decoders with the native
# parse: `<name>.md5` the EL pictures (`ShvcDecoder("np")`, what the
# display layer shows) and `<name>.bl.md5` the BL pictures
# (`Decoder("np")`, layer 0).

SHVC_DIR = os.path.join(OUT_DIR, "shvc")
SHVC_FLAGS = ("bl_inter", "el_temporal", "el_tmvp", "col_il",
              "nonzero_il_mv")

SHVC_NOT_ENCODABLE = {
    "el_deblock_sao": "encode_shvc_stream takes no sao / deblock option: "
                      "both layers keep the encoder's default (filters "
                      "off)",
    "bit10": "encode_shvc_stream takes no bit_depth option (8 bits)",
    "422_444": "encode_shvc_stream takes no chroma_format_idc option "
               "(4:2:0)",
    "b_slices": "both layers are intra or P chains (the EL writes "
                "slice_type P)",
}


def noise_frames(w, h, n, rng):
    """tests/test_torch_shvc.py `_frames` (tests/test_shvc.py's): 8-bit
    4:2:0 noise pictures from the generator `rng`."""
    return [tuple([rng.integers(0, 256, (h, w)).astype(np.uint8),
                   rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
                   rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)])
            for _ in range(n)]


def noise_layers(bl, el, n, seed):
    """(BL pictures, EL pictures) as tests/test_torch_shvc.py
    `shvc_stream` makes them: one generator, the BL pictures first."""
    rng = np.random.default_rng(seed)
    blf = noise_frames(*bl, n, rng)
    return blf, noise_frames(*el, n, rng)


def _area_taps(n_in, n_out):
    """(idx, wt) int64 [n_out, k] of an area average from n_in samples to
    n_out: the input samples that output sample i covers ([i, i + 1) *
    n_in / n_out) and their overlaps, in units of 1 / n_out of a sample
    (each row of wt sums to n_in)."""
    k = -(-n_in // n_out) + 1
    lo = np.arange(n_out, dtype=np.int64) * n_in
    idx = (lo // n_out)[:, None] + np.arange(k)[None, :]
    wt = np.clip(np.minimum(lo[:, None] + n_in, (idx + 1) * n_out) -
                 np.maximum(lo[:, None], idx * n_out), 0, None)
    return np.minimum(idx, n_in - 1), wt


def area_downscale(plane, h, w):
    """The plane averaged down to h x w over the area each output sample
    covers (a 2x2 box filter at ratio 2, the plane itself at ratio 1), in
    integers, rounded to nearest."""
    iy, wy = _area_taps(plane.shape[0], h)
    ix, wx = _area_taps(plane.shape[1], w)
    rows = (plane.astype(np.int64)[iy] * wy[:, :, None]).sum(1)
    acc = (rows[:, ix] * wx[None]).sum(2)
    d = plane.shape[0] * plane.shape[1]
    return ((acc + d // 2) // d).astype(plane.dtype)


def scene_layers(bl, el, n, seed):
    """One scene in both layers, as SHVC carries it: the EL pictures are
    `smooth_moving` at EL size, the BL pictures the same pictures
    averaged down to BL size (`area_downscale`)."""
    elf = smooth_moving(*el, n, seed)
    blf = [tuple(area_downscale(p, p.shape[0] * bl[1] // el[1],
                                p.shape[1] * bl[0] // el[0]) for p in f)
           for f in elf]
    return blf, elf


LAYER_MAKERS = {"noise_layers": noise_layers, "scene_layers": scene_layers}

# tests/test_torch_shvc.py TWO_LAYER (tests/test_shvc.py's cases), and
# tests/test_shvc.py::test_shvc_il_motion_x15_snr's SNR case:
# name -> (BL size, EL size, seed, AUs, flags)
SHVC_TIER_B = {
    "x2": ((32, 32), (64, 64), 31, 4, {}),
    "x1_5": ((32, 32), (48, 48), 41, 4, {}),
    "snr": ((48, 48), (48, 48), 42, 4, {}),
    "x2_rect_ctb32": ((48, 32), (96, 64), 43, 4, dict(ctb_log2=5)),
    "bl_motion": ((32, 32), (64, 64), 51, 5, dict(bl_inter=True)),
    "mixed_l0": ((32, 32), (64, 64), 52, 5, dict(bl_inter=True,
                                                 el_temporal=True)),
    "il_fractional_mv": ((32, 32), (64, 64), 53, 5,
                         dict(bl_inter=True, el_temporal=True,
                              nonzero_il_mv=True)),
    "el_tmvp": ((32, 32), (64, 64), 54, 5, dict(bl_inter=True,
                                                el_temporal=True,
                                                el_tmvp=True)),
    "col_il": ((32, 32), (64, 64), 55, 5, dict(bl_inter=True,
                                               el_temporal=True, el_tmvp=True,
                                               col_il=True)),
    "col_il_mv": ((32, 32), (64, 64), 56, 5,
                  dict(bl_inter=True, el_temporal=True, el_tmvp=True,
                       col_il=True, nonzero_il_mv=True)),
    "col_il_mv_x1_5": ((32, 32), (48, 48), 57, 4,
                       dict(bl_inter=True, el_temporal=True, el_tmvp=True,
                            col_il=True, nonzero_il_mv=True)),
    "snr_col_il_mv": ((48, 48), (48, 48), 58, 4,
                      dict(bl_inter=True, el_temporal=True, el_tmvp=True,
                           col_il=True, nonzero_il_mv=True)),
}

# The SHVC common test conditions (JCTVC-Q1009, "Common SHM test
# conditions"): a 1080p EL over spatial 2x, spatial 1.5x and SNR BLs,
# low delay P; CTB 64, BL QP 32, EL QP 30, every inter-layer tool on.
# name -> (BL size, EL size, seed, what was cut)
SHVC_TIER_A = {
    "shvc_x2_1080p_ld": (
        (960, 544), (1920, 1088), 61,
        ["BL 960x540 -> 960x544 and EL 1920x1080 -> 1920x1088: the "
         "encoder writes no conformance window, so both sizes are "
         "multiples of 8 (hevc_enc.py:289)"]),
    "shvc_x1_5_1080p_ld": ((1280, 720), (1920, 1080), 62, []),
    "shvc_snr_1080p_ld": ((1920, 1080), (1920, 1080), 63, []),
}
SHVC_TIER_A_AUS = 5


def shvc_entries():
    """name -> two-layer manifest entry (without the fields a decode
    fills in)."""
    out = {}
    for name, (bl, el, seed, n, kw) in SHVC_TIER_B.items():
        out[name] = dict(
            name=name, tier="B", encoder="encode_shvc_stream",
            kwargs=dict(bl_size=list(bl), el_size=list(el), qp=30,
                        seed=seed, **kw),
            pictures=dict(maker="noise_layers", bl=list(bl), el=list(el),
                          n=n, seed=seed),
            source="tests/test_torch_shvc.py TWO_LAYER" if name !=
            "snr_col_il_mv" else
            "tests/test_shvc.py::test_shvc_il_motion_x15_snr (SNR)",
            reduced=["the CPU test's sizes and AU count"])
    for name, (bl, el, seed, cut) in SHVC_TIER_A.items():
        out[name] = dict(
            name=name, tier="A", encoder="encode_shvc_stream",
            kwargs=dict(bl_size=list(bl), el_size=list(el), qp=32, el_qp=30,
                        ctb_log2=6, seed=seed,
                        **{f: True for f in SHVC_FLAGS}),
            pictures=dict(maker="scene_layers", bl=list(bl), el=list(el),
                          n=SHVC_TIER_A_AUS, seed=seed),
            source="JCTVC-Q1009 Common SHM test conditions: 1080p EL, "
                   "low delay P, every inter-layer tool; BL = the EL "
                   "pictures averaged down",
            reduced=cut + [f"{SHVC_TIER_A_AUS} AUs (the CTC sequences "
                           f"run 2-10 s)"])
    return out


def make_layer_pictures(spec):
    """(BL pictures, EL pictures) of a two-layer entry's `pictures`."""
    return LAYER_MAKERS[spec["maker"]](tuple(spec["bl"]), tuple(spec["el"]),
                                       spec["n"], spec["seed"])


def encode_shvc_entry(entry) -> bytes:
    """The two-layer stream's bytes from its manifest entry alone."""
    from openhevc_tpu.encoder.shvc_enc import encode_shvc_stream
    kw = dict(entry["kwargs"])
    blf, elf = make_layer_pictures(entry["pictures"])
    return encode_shvc_stream(blf, elf, tuple(kw.pop("bl_size")),
                              tuple(kw.pop("el_size")), **kw)[0]


def shvc_route(fs, refs, col_il):
    """The two-layer route fields of one picture beside phase 8's: the
    MC mode of its inter blocks (the JAX package's gate,
    `JaxEngine.MC_PAIRS_MAX_PIXELS`; none without inter blocks), whether
    its references hold the inter-layer picture (which carries the
    picture's own POC) and whether TMVP's collocated picture is it."""
    from openhevc_tpu.models.pipeline import JaxEngine
    pairs = fs.sps.height * fs.sps.width <= JaxEngine.MC_PAIRS_MAX_PIXELS
    return dict(mc=("pair" if pairs else "tap") if fs.inter_pbs else "none",
                il_ref=fs.poc in refs, col_il=bool(col_il))


def reference_decode_layers(data):
    """The JAX package's decodes of a two-layer stream, native parse:
    `ShvcDecoder("np")` (EL md5s, both layers' routes in decode order,
    both layers' Python-parsed slices) and `Decoder("np")` on layer 0
    alone (BL md5s, and its routes, which must equal the BL's in the
    two-layer decode). Returns a dict."""
    from bench_torch import hash_pics
    from chip_smoke import _col_il
    from openhevc_tpu.decoder import Decoder, ShvcDecoder

    class Recording(Decoder):
        def _build_ref_lists(self, sh, sps, poc, il=None):
            lists = super()._build_ref_lists(sh, sps, poc, il=il)
            self.col[poc] = _col_il(self, sh, lists, poc)
            return lists

        def _reconstruct(self, fs, refs):
            raw = fs.native_raw
            self.routes.append(dict(
                poc=int(fs.poc),
                parse="native" if raw is not None else "python",
                filters=_filters(fs), plan=_plan(fs),
                jobs=int(len(raw["ij_meta"]) if raw is not None
                         else len(fs.intra_jobs)),
                inter=bool(fs.inter_pbs), pcm=len(fs.pcm_blocks),
                **shvc_route(fs, refs, self.col.pop(fs.poc, False))))
            return super()._reconstruct(fs, refs)

    def recording(d):
        d.__class__ = Recording
        d.routes, d.col = [], {}
        return d

    two = ShvcDecoder("np")
    for d in (two.bl, two.el):
        recording(d)
    el_pics = two.decode(data) + two.flush()
    bl = recording(Decoder("np", native_parse=True))
    bl_pics = bl.decode(data) + bl.flush()
    if bl.routes != two.bl.routes:
        raise AssertionError("the BL alone takes other routes than in the "
                             "two-layer decode")
    return dict(el_md5=hash_pics(el_pics), bl_md5=hash_pics(bl_pics),
                routes=dict(bl=two.bl.routes, el=two.el.routes),
                python_slices=dict(bl=two.bl.stats["python_slices"],
                                   el=two.el.stats["python_slices"]),
                el_pics=el_pics, bl_pics=bl_pics)


def _ratio(bl, el):
    return {2.0: "x2", 1.5: "x1_5", 1.0: "snr"}[el[0] / bl[0]]


def make_shvc_stream(entry, out_dir=SHVC_DIR):
    """Encode one two-layer entry, write its stream and both sidecars,
    and return the entry completed from its decodes."""
    t0 = time.perf_counter()
    data = encode_shvc_entry(entry)
    t1 = time.perf_counter()
    ref = reference_decode_layers(data)
    t2 = time.perf_counter()
    name = entry["name"]
    with open(os.path.join(out_dir, f"{name}.265"), "wb") as f:
        f.write(data)
    for suffix, md5s in (("md5", ref["el_md5"]), ("bl.md5", ref["bl_md5"])):
        with open(os.path.join(out_dir, f"{name}.{suffix}"), "w") as f:
            f.write("".join(h + "\n" for h in md5s))
    el_sps, bl_sps = ref["el_pics"][0].sps, ref["bl_pics"][0].sps
    kw = entry["kwargs"]
    entry = dict(entry)
    entry.update(
        width=int(el_sps.width), height=int(el_sps.height),
        bl_width=int(bl_sps.width), bl_height=int(bl_sps.height),
        chroma_format_idc=int(el_sps.chroma_format_idc),
        bit_depth=int(el_sps.bit_depth), ctb_size=int(el_sps.ctb_size),
        frames=len(ref["el_md5"]), bl_frames=len(ref["bl_md5"]),
        bytes=len(data),
        sidecar="openhevc_tpu.decoder.ShvcDecoder('np'), native parse: "
                "EL pictures",
        bl_sidecar="openhevc_tpu.decoder.Decoder('np'), native parse, "
                   "layer 0: BL pictures",
        python_slices=ref["python_slices"], routes=ref["routes"],
        features=sorted({_ratio(kw["bl_size"], kw["el_size"]),
                         f"ctb{1 << kw.get('ctb_log2', 4)}"} |
                        {f for f in SHVC_FLAGS if kw.get(f)}))
    print(f"{name}: {entry['frames']} EL / {entry['bl_frames']} BL "
          f"pictures, {len(data)} B, encode {t1 - t0:.1f} s, sidecars "
          f"{t2 - t1:.1f} s", flush=True)
    return entry


def _run(args):
    name, out_dir, shvc = args
    if shvc:
        return make_shvc_stream(shvc_entries()[name], out_dir)
    return make_stream(entries()[name], out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tier", choices=("A", "B"))
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--shvc", action="store_true",
                    help="the two-layer streams (feature_streams/shvc/)")
    a = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    table = shvc_entries() if a.shvc else entries()
    out_dir = a.out or (SHVC_DIR if a.shvc else OUT_DIR)
    names = [n for n, e in table.items()
             if (a.tier is None or e["tier"] == a.tier)
             and (not a.only or n in a.only)]
    unknown = set(a.only or ()) - set(table)
    if unknown:
        print(f"unknown streams: {sorted(unknown)}", file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    with ProcessPoolExecutor(max(1, a.jobs),
                             multiprocessing.get_context("spawn")) as ex:
        made = {e["name"]: e for e in ex.map(
            _run, [(n, out_dir, a.shvc) for n in names])}
    path = os.path.join(out_dir, MANIFEST)
    streams = {}
    if os.path.exists(path):
        with open(path) as f:
            streams = {e["name"]: e for e in json.load(f)["streams"]
                       if e["name"] in table}
    streams.update(made)
    if a.shvc:
        manifest = {
            "about": "Two-layer (SHVC) feature-matrix streams, written by "
                     "tools/make_feature_streams.py --shvc; sidecars: md5 "
                     "a picture in output order, <name>.md5 the EL "
                     "pictures from the JAX package's ShvcDecoder('np'), "
                     "<name>.bl.md5 the BL pictures from its Decoder('np') "
                     "on layer 0; routes: a picture in decode order, per "
                     "layer.",
            "not_encodable": SHVC_NOT_ENCODABLE}
    else:
        manifest = {
            "about": "Feature-matrix streams, written by "
                     "tools/make_feature_streams.py; sidecars: md5 a "
                     "picture in output order from the JAX package's "
                     "Decoder('np'); routes: a picture in decode order.",
            "families": list(FAMILIES),
            "not_encodable": NOT_ENCODABLE}
    manifest["streams"] = [streams[n] for n in table if n in streams]
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
