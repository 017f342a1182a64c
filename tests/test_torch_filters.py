"""Port in-loop filters: the filter plan (`plan_filters`: `prep_filters`'
control arrays, the per-edge arrays of `edge_params`, `apply_filters_device`)
of the port (ops/filters.py) vs the JAX package's `prep_filters` +
`apply_filters_device` (ops/filters_jax.py, plain XLA, runs on the CPU)
and vs the reference-exact scalar schedule
(ops/filters_sched.py), on the matrix of tests/test_device_filters.py:
CTB 16 / 32, PCM, transquant bypass, deblock-only, SAO-only, and, for
the filter functions alone, 4:2:2 / 4:4:4. Then whole decodes with the
filters on, intra and inter, vs `Decoder("np")`, and a halo pattern
outside the model, which takes the host-scheduled filters. Tolerance:
none (integer samples)."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import make_frames
from test_device_filters import _capture_frames, _frames_fmt
from test_torch_banded import _force_banded
from openhevc_tpu_torch.ops.filters import edge_params_ref
from test_torch_edge_params import (EDGE_STREAMS, ROOT, assert_edges_equal,
                                    deblocked, device_edges,
                                    one_thread)  # noqa: F401  (a fixture)
from test_torch_inter import (assert_same, decode, lowdelay, np_decode,
                              random_access, stream)

MATRIX_420 = [
    (64, 64, 5, 1, False, False, True, True),    # baseline
    (64, 64, 4, 2, False, False, True, True),    # 16x16 CTB halo quirk
    (96, 64, 4, 3, False, False, True, True),    # non-square, ctb16
    (64, 64, 5, 4, True, False, True, True),     # PCM no-filter blocks
    (64, 64, 5, 5, False, True, True, True),     # transquant bypass
    (64, 64, 4, 6, True, True, True, True),      # everything at once
    (64, 64, 4, 7, True, False, False, True),    # deblock-only + pcm
    (64, 64, 4, 8, True, False, True, False),    # sao-only + pcm
    (128, 128, 6, 9, False, False, True, True),  # CTB 64
    (72, 40, 4, 10, False, False, True, True),   # chroma dims not 8-multiples
]
MATRIX_FMT = [
    (2, 64, 64, 5, 31, False, False, True, True),   # 4:2:2 baseline
    (2, 96, 64, 5, 32, True, False, True, True),    # 4:2:2 + PCM
    (2, 64, 64, 5, 33, False, True, True, True),    # 4:2:2 + tqb
    (2, 64, 64, 5, 34, False, False, False, True),  # 4:2:2 deblock only
    (3, 64, 64, 5, 35, False, False, True, True),   # 4:4:4 baseline
    (3, 96, 64, 5, 36, True, False, True, True),    # 4:4:4 + PCM
    (3, 64, 64, 5, 37, False, True, True, True),    # 4:4:4 + tqb
    (3, 64, 64, 5, 38, False, False, True, False),  # 4:4:4 SAO only
    (2, 64, 64, 4, 39, False, False, False, True),  # 4:2:2 ctb16 dbk-only
    (2, 64, 64, 4, 40, False, False, True, True),   # 4:2:2 ctb16 + SAO
    (3, 96, 64, 4, 41, False, False, True, True),   # 4:4:4 ctb16 + SAO
    (2, 96, 64, 4, 42, True, False, True, True),    # 4:2:2 ctb16+SAO+PCM
]


def _jax_filter(pre, fs):
    import jax.numpy as jnp
    from openhevc_tpu.ops import filters_jax as F
    pff = F.prep_filters(fs)
    fargs = tuple(jnp.asarray(a) for a in F.fargs_arrays(pff))
    sps = fs.sps
    out = F.apply_filters_device(
        *(jnp.asarray(np.asarray(p, np.int32)) for p in pre), *fargs,
        bd=sps.bit_depth, bdc=sps.bit_depth_chroma, cs=1 << sps.log2_ctb,
        do_deblock=pff["do_deblock"], do_sao=pff["do_sao"], hs=sps.hshift1,
        vs=sps.vshift1)
    return pff, [np.asarray(o) for o in out]


def port_plan(fs):
    """The picture's filter plan (device route) and its arguments made on
    the CPU from the plan's arrays, as the engine makes them from its
    upload (`plan.args`: the control arrays, and the per-edge arrays of
    the plain `edge_params`)."""
    from openhevc_tpu_torch.ops import filters as F
    plan = F.plan_filters(fs)
    assert plan.route == "device"
    up = {k: torch.from_numpy(np.ascontiguousarray(a))
          for k, a in plan.arrays.items()}
    return plan, plan.args(up)


def _port_prep(plan, args):
    """The plan in the JAX package's `prep_filters` layout: its flags
    and its arguments by name, as numpy."""
    return dict({k: a.numpy() for k, a in args.items()},
                do_deblock=plan.do_deblock, do_sao=plan.do_sao)


def _port_filter(pre, fs, views=False):
    plan, args = port_plan(fs)
    planes = [torch.from_numpy(np.asarray(p, np.int32)) for p in pre]
    if views:       # un-padded views of larger buffers, as the engine's
        big = [torch.full((p.shape[0] + 9, p.shape[1] + 5), -5,
                          dtype=torch.int32) for p in planes]
        for b, p in zip(big, planes):
            b[3:3 + p.shape[0], 2:2 + p.shape[1]] = p
        planes = [b[3:3 + p.shape[0], 2:2 + p.shape[1]]
                  for b, p in zip(big, planes)]
    sps = fs.sps
    stages = []

    class stage:
        def __init__(self, name):
            stages.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    assert plan.cs == 1 << sps.log2_ctb
    out = plan.apply(*planes, args, stage=stage)
    assert stages == ["deblock"] * plan.do_deblock + ["sao"] * plan.do_sao
    if views:
        assert all((b == -5).sum() == b.numel() - p.numel()
                   for b, p in zip(big, planes))
    return _port_prep(plan, args), [o.numpy() for o in out]


def _check_stream(data, views=False):
    n = 0
    for pre, fs, truth in _capture_frames(data):
        jp, want = _jax_filter(pre, fs)
        pp, got = _port_filter(pre, fs, views)
        assert set(jp) == set(pp)
        for k in jp:                      # the filters' inputs, one by one
            a, b = np.asarray(jp[k]), np.asarray(pp[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for c in range(3):
            assert got[c].dtype == np.int32
            assert np.array_equal(got[c], want[c]), c
            assert np.array_equal(got[c].astype(np.int64), truth[c]), c
        n += 1
    assert n == 2


@pytest.mark.parametrize("W,H,ctb,seed,pcm,tqb,sao,dbk", MATRIX_420)
def test_filters_match_jax_and_schedule(W, H, ctb, seed, pcm, tqb, sao, dbk):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = make_frames(W, H, 2, np.random.default_rng(seed), smooth=False)
    kw = dict(qp=34, ctb_log2=ctb, seed=seed, pcm=pcm, sao=sao, deblock=dbk)
    if tqb:
        kw["transquant_bypass"] = True
    data, _ = encode_intra_stream(frames, W, H, **kw)
    _check_stream(data, views=seed % 2 == 0)


@pytest.mark.parametrize("fmt,W,H,ctb,seed,pcm,tqb,sao,dbk", MATRIX_FMT)
def test_filters_chroma_formats_match_jax(fmt, W, H, ctb, seed, pcm, tqb,
                                          sao, dbk):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = _frames_fmt(W, H, 2, np.random.default_rng(seed), fmt)
    kw = dict(qp=34, ctb_log2=ctb, seed=seed, pcm=pcm, sao=sao, deblock=dbk,
              chroma_format_idc=fmt, min_cb_log2=3)
    if tqb:
        kw["transquant_bypass"] = True
    data, _ = encode_intra_stream(frames, W, H, **kw)
    _check_stream(data)


def test_filter_tables_and_keys_match():
    from openhevc_tpu.ops import deblock_np, filters_jax
    from openhevc_tpu_torch.ops import filters, tables
    assert np.array_equal(tables.TC_TABLE, deblock_np.TC_TABLE)
    assert np.array_equal(tables.BETA_TABLE, deblock_np.BETA_TABLE)
    assert filters.FARG_KEYS == filters_jax.FARG_KEYS


def test_inter_boundary_strengths_match_jax():
    """The MV / reference rule of the boundary strengths, on pictures
    with uni- and bi-predicted blocks."""
    from openhevc_tpu.ops import filters_jax
    from openhevc_tpu_torch.ops import filters
    from test_torch_inter import _captured
    data = lowdelay("b_weighted_tmvp", deblock=True, sao=True)
    seen = 0
    for fs, _refs in _captured(data):
        want = filters_jax.boundary_strengths_vec(fs)
        got = filters.boundary_strengths_vec(fs)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        seen += int((got[0] == 1).any())
        jp, pp = filters_jax.prep_filters(fs), _port_prep(*port_plan(fs))
        assert set(jp) == set(pp)
        assert all(np.array_equal(np.asarray(jp[k]), np.asarray(pp[k]))
                   for k in jp)
    assert seen > 0


# ---- the per-edge parameters on the device (`edge_params`) -----------------

def _numpy(pff):
    """A `prep_filters` dict of the JAX package, its arrays as numpy."""
    return {k: np.asarray(v) for k, v in pff.items()}


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("path", EDGE_STREAMS)
def test_edge_params_plain_version_equals_prep_filters(path):
    """Every deblocked picture of the benchmark's 1080p stream and of the
    deblocked feature streams: the plain PyTorch `edge_params` gives the
    JAX package's `prep_filters`' eight per-edge arrays, array for
    array."""
    from openhevc_tpu.ops import filters_jax
    pics = deblocked(path)
    assert pics
    for fs in pics:
        got = device_edges(fs, "cpu", edge_params_ref)
        assert_edges_equal(got, _numpy(filters_jax.prep_filters(fs)))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("path,offsets", [
    ("feature_streams/422_b_filters_tmvp.265", (-12, 12, 7, -5)),
    ("feature_streams/444_b_filters.265", (6, 4, -12, 12)),
    ("feature_streams/main12_filters.265", (12, -12, 12, -12)),
    ("feature_streams/f_pcm_lf_disabled.265", (-6, -2, 3, 3)),
])
def test_edge_params_with_offsets(path, offsets):
    """No committed stream carries non-zero beta / tc offsets or slice
    chroma QP offsets: set on the parsed pictures (every version reads
    the same fields), they move the clips and the chroma tables alike in
    the plain version and the JAX package's `prep_filters`."""
    from openhevc_tpu.ops import filters_jax
    bo, to, cb, cr = offsets
    for fs in deblocked(path):
        plain = device_edges(fs, "cpu", edge_params_ref)
        fs.beta_offset, fs.tc_offset = bo, to
        fs.slice_cb_qp_offset, fs.slice_cr_qp_offset = cb, cr
        got = device_edges(fs, "cpu", edge_params_ref)
        assert any(not torch.equal(a, b) for a, b in zip(got, plain))
        assert_edges_equal(got, _numpy(filters_jax.prep_filters(fs)))


def test_mv_rule_needs_no_reference_index():
    """`_mv_bs_vec`'s test of identical motion (reference indices too)
    never changes a strength: the plain version without it agrees on
    random motion with equal and unequal indices, every flag pairing."""
    from openhevc_tpu_torch.ops.filters import _mv_bs_ref, _mv_bs_vec
    rng = np.random.default_rng(7)
    h4, w4 = 64, 96
    mc = SimpleNamespace(
        pred_flag=rng.integers(0, 4, (h4, w4)).astype(np.uint8),
        mv=rng.integers(-5, 5, (h4, w4, 2, 2)).astype(np.int32),
        ref_idx=rng.integers(0, 2, (h4, w4, 2)).astype(np.int8),
        refpoc=rng.choice(np.array([0, 4, 8], np.int32), (h4, w4, 2)))
    # half the pairs copy p's motion to q: identical motion, either index
    same = rng.random((h4, w4 // 2)) < 0.5
    for a in (mc.pred_flag, mc.mv, mc.refpoc):
        a[:, 1::2][same] = a[:, 0::2][same]
    want = _mv_bs_vec(mc, (slice(None), slice(0, w4, 2)),
                      (slice(None), slice(1, w4, 2)))
    flat = [torch.from_numpy(np.ascontiguousarray(a)).reshape(-1, *a.shape[2:])
            for a in (mc.pred_flag, mc.mv, mc.refpoc)]
    idx = torch.arange(h4 * w4).reshape(h4, w4)
    got = _mv_bs_ref(flat[0].to(torch.int32), flat[1], flat[2],
                     idx[:, 0::2], idx[:, 1::2])
    assert np.array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.9
    ri_differs = same & (mc.ref_idx[:, 1::2] != mc.ref_idx[:, 0::2]).any(-1)
    assert ri_differs.sum() > 100 and not want[ri_differs].any()


@pytest.mark.usefixtures("one_thread")
def test_edge_params_keep_poc_identity_with_a_reference_missing():
    """An inter picture one of whose references is missing from
    `ref_planes`: the MC maps that reference onto the first one's cache
    slot (`_pack_inter`), which would merge the two in the MV rule; the
    engine's per-edge parameters follow the parser's POCs and equal the
    JAX package's `prep_filters`' arrays and the plain version's on the
    parser's grids."""
    import copy
    from openhevc_tpu.ops import filters_jax
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import filters
    from test_torch_inter import _captured
    base, kw = INTER_FILTERED["p_ctb32_two_refs"]
    data = stream(base, **dict(dict(sao=True, deblock=True), **kw))
    checked = 0
    for fs, refs in _captured(data):
        for gone in sorted(refs):
            left = {p: v for p, v in refs.items() if p != gone}
            kept = sorted(p for p in set(fs.ref_poc_l0) | set(fs.ref_poc_l1)
                          if p in left)
            if not kept:
                continue
            # the strengths by cache slot: a POC not at hand is the first's
            by_slot = copy.copy(fs)
            by_slot.motion = copy.copy(fs.motion)
            rp = fs.motion.refpoc
            by_slot.motion.refpoc = np.where(np.isin(rp, kept), rp, kept[0])
            if all(np.array_equal(a, b) for a, b in zip(
                    filters.boundary_strengths_vec(by_slot),
                    filters.boundary_strengths_vec(fs))):
                continue
            k = TorchEngine("cpu").prepare(fs, left)
            edges = [k["filter_args"][e] for e in filters.EDGE_KEYS]
            assert_edges_equal(edges, _numpy(filters_jax.prep_filters(fs)))
            want = device_edges(fs, "cpu", edge_params_ref)
            assert all(torch.equal(a, b) for a, b in zip(edges, want))
            checked += 1
    assert checked


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["f_ctb64", "p_ctb64",
                                  "f_ctb64_tile_axis"])
def test_engine_makes_no_numpy_boundary_strengths(name, monkeypatch):
    """Filtered 4:2:0 CTB-64 pictures through the CPU engine (the intra
    feature stream; a low-delay P stream) and through the tile axis of a
    2 x 2 mesh: neither calls `boundary_strengths_vec` (it raises here),
    and every picture equals the sidecar's md5 / `Decoder("np")`."""
    from bench_torch import hash_pics
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import filters
    from openhevc_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh([["cpu"] * 2] * 2, ("frame", "tile")) \
        if name.endswith("tile_axis") else None
    if name.startswith("f_ctb64"):
        path = os.path.join(ROOT, "feature_streams", "f_ctb64.265")
        with open(path, "rb") as f:
            data = f.read()
        with open(path + ".md5") as f:
            want = f.read().split()
    else:
        data = stream("p", sao=True, deblock=True, ctb_log2=6, W=128,
                      H=128)
        want = np_decode(data)

    def refuse(fs):
        raise AssertionError("boundary_strengths_vec on the engine's route")

    monkeypatch.setattr(filters, "boundary_strengths_vec", refuse)
    got, pics = decode(Decoder(device="cpu", mesh=mesh), data)
    assert all(p.planes.device_filtered and p.sps.log2_ctb == 6
               for p in pics)
    if name.startswith("f_ctb64"):
        assert hash_pics(pics) == want
    else:
        assert_same(got, want)
        assert len(pics) == 4


# ---- whole decodes with the filters on ------------------------------------

INTRA_FILTERED = {
    "ctb16": dict(W=64, H=64, ctb_log2=4),
    "ctb32_wpp": dict(W=128, H=64, ctb_log2=5, wpp=True),
    "ctb64": dict(W=128, H=128, ctb_log2=6),
    "pcm": dict(W=64, H=64, ctb_log2=4, pcm=True),
    "tqb": dict(W=64, H=64, ctb_log2=5, transquant_bypass=True),
    "tiles": dict(W=128, H=64, ctb_log2=4, tile_cols=2, tile_rows=2),
    "deblock_only": dict(W=64, H=64, ctb_log2=4, sao=False),
    "sao_only": dict(W=64, H=64, ctb_log2=4, deblock=False),
    "odd_chroma": dict(W=72, H=40, ctb_log2=4),
    "ten_bit": dict(W=64, H=64, ctb_log2=4, bit_depth=10),
}


def _intra_filtered(name):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    kw = dict(sao=True, deblock=True, qp=34)
    kw.update(INTRA_FILTERED[name])
    W, H = kw.pop("W"), kw.pop("H")
    bd = kw.get("bit_depth", 8)
    frames = make_frames(W, H, 2, np.random.default_rng(3), smooth=False)
    if bd > 8:
        frames = [tuple(p.astype(np.uint16) << (bd - 8) for p in f)
                  for f in frames]
    return encode_intra_stream(frames, W, H, seed=3, **kw)[0], W, \
        1 << kw["ctb_log2"]


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(INTRA_FILTERED))
def test_port_decoder_filtered_intra_matches_np(name, banded, monkeypatch):
    from openhevc_tpu_torch.decoder import Decoder
    data, W, cs = _intra_filtered(name)
    want = np_decode(data)
    if banded:
        _force_banded(monkeypatch, W, cs)
    got, pics = decode(Decoder(device="cpu"), data)
    assert_same(got, want)
    assert all(p.planes.device_filtered for p in pics)


INTER_FILTERED = {       # name -> (test_torch_inter's stream, more options)
    "p": ("p", dict()),
    "p_ctb32_two_refs": ("p", dict(ctb_log2=5, W=96, n_refs=2)),
    "p_deblock_only": ("p", dict(sao=False)),
    "b_weighted_tmvp": ("b_weighted_tmvp", dict()),
    "ten_bit": ("ten_bit", dict()),
    "ra": ("ra", dict()),
    "ra_tiles": ("ra_tiles", dict(ctb_log2=5)),
    "ra_tmvp_wpp": ("ra_tmvp_wpp", dict()),
}


@pytest.mark.parametrize("name", sorted(INTER_FILTERED))
def test_port_decoder_filtered_inter_matches_np(name):
    """The DPB entry is the filtered picture: an error in the filters
    shows in the pictures that predict from it."""
    from openhevc_tpu_torch.decoder import Decoder
    base, kw = INTER_FILTERED[name]
    data = stream(base, **dict(dict(sao=True, deblock=True), **kw))
    got, pics = decode(Decoder(device="cpu"), data)
    assert_same(got, np_decode(data))
    assert all(p.planes.device_filtered for p in pics)


def test_port_decoder_filtered_matches_jax_decoder():
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data = random_access("ra_tiles", sao=True, deblock=True, ctb_log2=5)
    assert_same(decode(Decoder(device="cpu"), data)[0],
                decode(JaxDecoder("jax"), data)[0])


def test_filter_pattern_outside_the_model_raises(monkeypatch):
    """Where `prep_filters` gives up on a CTB-16 halo pattern the picture's
    filter plan takes the host route, the host-scheduled filters
    (ops/filters_sched.py), as in the JAX package: it is returned
    filtered, equal to `Decoder("np")`."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import filters
    data, _, _ = _intra_filtered("ctb16")
    want = np_decode(data)
    monkeypatch.setattr(filters, "_chroma_stale_reads", lambda fs: None)
    got, pics = decode(Decoder(device="cpu"), data)
    assert_same(got, want)
    assert not any(p.planes.device_filtered for p in pics)
    monkeypatch.undo()
    monkeypatch.setattr(filters, "prep_filters", lambda fs: None)
    got, pics = decode(Decoder(device="cpu"), data)
    assert_same(got, want)
    assert not any(p.planes.device_filtered for p in pics)


def test_filters_ride_in_the_one_upload(monkeypatch):
    """A filtered inter picture makes one host-to-device copy, by name:
    arenas, meta, the filters' control arrays the picture has (CTB 16
    with SAO: the three stale-read masks and the SAO parameters; no
    placeholder) and, in place of the eight per-edge parameter arrays,
    the grids that `edge_params` makes them from (five per-4x4 grids, the
    chroma QP tables, three motion grids), then the motion deltas."""
    from openhevc_tpu_torch.models import pipeline
    from test_torch_inter import _captured
    fs, refs = _captured(lowdelay("p", sao=True, deblock=True))[-1]
    eng = pipeline.TorchEngine("cpu")
    eng.prepare(fs, refs)                      # stage 1 of the references
    uploads = []
    orig = pipeline.upload
    monkeypatch.setattr(pipeline, "upload",
                        lambda arrays, dev: (uploads.append(list(arrays)),
                                             orig(arrays, dev))[1])
    k = eng.prepare(fs, refs)
    assert uploads == [["arena4", "arena16", "esc", "meta6", "st_b0",
                        "st_b2", "st_a3", "sao", "pred_mode", "cbf",
                        "bounds_v", "bounds_h", "qp", "qlut", "pred_flag",
                        "mv", "refpoc", "md_idx", "md_vals"]]
    f, a = k["filters"], k["filter_args"]
    assert f.route == "device" and f.do_deblock and f.do_sao and f.cs == 16
    assert list(a) == ["st_b0", "st_b2", "st_a3", "sao", "beta_v", "tc_v",
                       "beta_h", "tc_h", "tc_cv1", "tc_ch1", "tc_cv2",
                       "tc_ch2"]
    assert a["beta_v"].dtype == torch.int16
    assert a["beta_v"].shape == (16, 8)        # beta_v [H/4, W/8]


def test_unfiltered_pictures_carry_no_filter_tensors():
    from openhevc_tpu_torch.models import pipeline
    from test_torch_inter import _captured
    fs, refs = _captured(lowdelay("p"))[0]
    k = pipeline.TorchEngine("cpu").prepare(fs, refs)
    assert k["filters"] is None
    assert fs.deblock_disabled and not fs.sao_luma


@pytest.mark.parametrize("fmt", [2, 3])
def test_decoder_still_stops_other_chroma_formats(fmt):
    """The decoder no longer stops 4:2:2 / 4:4:4 (tests/test_torch_rext.py
    holds them at length): the filtered stream this test saw refused now
    decodes, equal to `Decoder("np")`. The one chroma format it still
    stops is monochrome, naming no ROADMAP item."""
    from types import SimpleNamespace
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import check_slice
    frames = _frames_fmt(64, 64, 1, np.random.default_rng(fmt), fmt)
    data, _ = encode_intra_stream(frames, 64, 64, qp=34, ctb_log2=5, seed=1,
                                  sao=True, deblock=True,
                                  chroma_format_idc=fmt, min_cb_log2=3)
    assert_same(decode(Decoder(device="cpu"), data)[0], np_decode(data))
    mono = SimpleNamespace(chroma_format_idc=0, bit_depth=8,
                           bit_depth_chroma=8)
    with pytest.raises(NotImplementedError, match="monochrome") as e:
        check_slice(SimpleNamespace(sps=mono, pps=None, poc=0,
                                    native_raw=None))
    assert "item" not in str(e.value)


def test_shift_params_and_expand_ctb():
    from openhevc_tpu_torch.ops.filters import _expand_ctb, _shift_params
    a = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    assert _shift_params(a).tolist() == [[1, 2, 3, 0], [5, 6, 7, 4],
                                         [9, 10, 11, 8]]
    assert _shift_params(a).dtype == torch.int32
    g = _expand_ctb(a, (2, 3), 5, 10)
    assert g.shape == (5, 10)
    assert g[:, 0].tolist() == [0, 0, 4, 4, 8] and g[0, 2:5].tolist() == \
        [0, 1, 1]
    assert torch.equal(_expand_ctb(a, 2, 6, 8),
                       a.repeat_interleave(2, 0).repeat_interleave(2, 1))
