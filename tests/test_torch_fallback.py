"""The routes of pictures off the port's main path, each held against the
JAX package on the CPU: pictures from the Python parser (every slice with
`native_parse=False`, more than 24 tile columns, a slice the native core
refuses), their per-level job sets, meta and CCP map; the host-scheduled
in-loop filters (`ops/filters_sched.py`, function by function and in
whole decodes with `prep_filters` forced to None); an inter picture with
PCM blocks and one with no usable reference (the starting planes of the
JAX package's packed path); and frames with no band plan, which take the
whole-frame kernel. Whole decodes are held to `Decoder("np")` and
`Decoder("jax")`. Tolerance: none (integer samples).
Tiled inter streams are held in tests/test_torch_pyparse_tiles.py against
the native parse and `Decoder("np")`: the JAX package's Python parser
takes merge / AMVP candidates from another tile, so
`Decoder("jax", native_parse=False)` is no yardstick there."""
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_inter as inter
import test_torch_rext as rext
from conftest import make_frames
from test_device_filters import _capture_frames, _frames_fmt
from test_torch_filters import _intra_filtered
from test_torch_levels import _port_level_sets
from test_torch_parse import _parsed, encode, parsed_port

# streams of tests/test_torch_rext.py and tests/test_torch_inter.py
PY_RExt = ["ccp", "sl_sps", "sl_sps_p", "422_p", "422_pcm",
           "444_b_filters", "main12_filters", "tools_all"]
PY_INTER = ["p", "b_weighted_tmvp", "ra", "ra_tmvp_wpp", "ten_bit",
            "wpp_amp", "two_slices", "long_term"]


def _stream(name):
    return rext.stream(name) if name in rext.CASES else inter.stream(name)


def _jax(data, **kw):
    from openhevc_tpu.decoder import Decoder
    return rext.decode(Decoder("jax", **kw), data)


def _np(data):
    from openhevc_tpu.decoder import Decoder
    return rext.decode(Decoder("np"), data)


def _port(**kw):
    from openhevc_tpu_torch.decoder import Decoder
    return Decoder(device="cpu", **kw)


def parsed_python(data, jax=False):
    """FrameSymbols of every picture from the Python parser (the port's,
    or the JAX package's with jax=True), in decode order."""
    if jax:
        from openhevc_tpu.decoder import Decoder
        return _parsed(Decoder, data, engine="jax", native_parse=False)
    from openhevc_tpu_torch.decoder import Decoder
    return _parsed(Decoder, data, device="cpu", native_parse=False)


# ---- Python-parsed pictures -------------------------------------------------

@pytest.mark.parametrize("name", PY_RExt + PY_INTER)
def test_python_parsed_decode_matches_jax_and_np(name):
    data = _stream(name)
    dec = _port(native_parse=False)
    got = rext.decode(dec, data)
    rext.assert_same(got, _jax(data, native_parse=False))
    rext.assert_same(got, _np(data))
    assert dec.stats["native_slices"] == 0
    assert dec.stats["python_slices"] >= len(got)


def test_more_than_24_tile_columns():
    """25 tile columns of one 16-wide CTB each: the native core's limit
    is 24, so the decoder parses these pictures in Python."""
    data, recons = encode(400, 64, n=2, seed=3, qp=30, ctb_log2=4,
                          tile_cols=25)
    dec = _port()
    got = rext.decode(dec, data)
    rext.assert_same(got, _np(data))
    rext.assert_same(got, [list(r) for r in recons])
    assert dec.stats == dict(dec.stats, native_slices=0, python_slices=2)


def test_native_refusal_takes_the_python_parser(monkeypatch):
    """A slice the native core refuses (ValueError) is parsed in Python
    in the parse worker, counted in stats["python_slices"]."""
    from openhevc_tpu_torch.bitstream import native
    data = inter.stream("b_weighted_tmvp")
    orig = native.parse_slice_native
    calls = []

    def refuse_second(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("refused for the test")
        return orig(*a, **kw)
    monkeypatch.setattr(native, "parse_slice_native", refuse_second)
    dec = _port()
    got = rext.decode(dec, data)
    rext.assert_same(got, _np(data))
    assert dec.stats["python_slices"] == 1
    assert dec.stats["native_slices"] == len(got) - 1


def _jax_object_level_sets(fs):
    """Per level, the set of (plane, x, y, size, mode) the JAX package's
    object packer (`_pack_from_objects`) schedules there."""
    from openhevc_tpu.models.pipeline import _pack_from_objects
    _res, intra, n_levels = _pack_from_objects(fs, fs.sps.width,
                                               fs.sps.height)
    out = [set() for _ in range(n_levels)]
    for s, a in intra.items():
        if a is None:
            continue
        for lvl, i in zip(*np.nonzero(a["valid"])):
            out[lvl].add((int(a["plane"][lvl, i]), int(a["x"][lvl, i]),
                          int(a["y"][lvl, i]), s, int(a["mode"][lvl, i])))
    return out


@pytest.mark.parametrize("name", ["pcm", "wpp_dct32", "constrained_intra",
                                  "444_nxn", "422_tu_pairs"])
def test_object_levels_match_pack_from_objects(name):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    if name == "pcm":
        data, _ = encode(64, 64, n=2, seed=5, qp=26, ctb_log2=4, pcm=True)
    elif name == "wpp_dct32":
        data, _ = encode(128, 64, n=2, seed=5, qp=37, ctb_log2=6, wpp=True)
    else:
        data = _stream(name)
    port = parsed_python(data)
    ref = parsed_python(data, jax=True)
    assert len(port) == len(ref) > 0
    eng = TorchEngine("cpu")
    seen = 0
    for a, b in zip(port, ref):
        assert a.native_raw is None and b.native_raw is None
        want = _jax_object_level_sets(b)
        got = _port_level_sets(a, eng.prepare(a, {}))
        assert got == want
        seen += len(got)
    assert seen > 1


@pytest.mark.parametrize("name", ["pcm", "444_nxn", "tools_all"])
def test_object_levels_equal_the_native_levels(name):
    """The Python parser's jobs get the level the native core gives the
    same job: `object_levels` applies the native parser's rule."""
    from openhevc_tpu_torch.ops.intra_fused import object_levels
    data = (encode(64, 64, n=2, seed=5, qp=26, ctb_log2=4, pcm=True)[0]
            if name == "pcm" else _stream(name))
    for py, nat in zip(parsed_python(data), parsed_port(data)):
        im = nat.native_raw["ij_meta"]
        got = object_levels(py.intra_jobs, py.sps.height, py.sps.width)
        assert [(j.plane, j.x, j.y, j.size) for j in py.intra_jobs] == \
            [tuple(r) for r in im[:, :4].tolist()]
        assert np.array_equal(got, im[:, 6])


@pytest.mark.parametrize("name", ["ccp", "444_nxn", "sl_sps_444"])
def test_pack_meta_objects_matches_jax(name):
    from openhevc_tpu.ops.intra_fused import pack_meta_objects as jax_meta
    from openhevc_tpu_torch.ops.intra_fused import (meta6_objects,
                                                    pack_meta_native,
                                                    pack_meta_objects)
    data = _stream(name)
    for a, b, nat in zip(parsed_python(data), parsed_python(data, jax=True),
                         parsed_port(data)):
        got = pack_meta_objects(a.intra_jobs)
        assert got.dtype == np.int16 and got.shape[1] > 0
        assert np.array_equal(got, jax_meta(b.intra_jobs))
        assert np.array_equal(got, pack_meta_native(nat.native_raw))
        m6, n_levels = meta6_objects(a.intra_jobs, a.sps.height, a.sps.width)
        assert np.array_equal(m6[:5], got)
        assert n_levels == m6[5].max() == nat.native_raw["n_levels"]


def test_res_buckets_objects_match_the_raw_branch():
    """The objects branch packs the same TUs as the raw one; with the
    JAX package's padding rows dropped, its buckets equal the JAX
    package's objects branch."""
    from openhevc_tpu.models.pipeline import _res_buckets as jax_buckets
    from openhevc_tpu_torch.models.pipeline import _res_buckets, host_pack
    for name in ("sl_sps_p", "tools_all", "444_nxn"):
        data = _stream(name)
        for a, b, nat in zip(parsed_python(data),
                             parsed_python(data, jax=True),
                             parsed_port(data)):
            got, want, raw = _res_buckets(a), jax_buckets(b), \
                _res_buckets(nat)
            assert sorted(got) == sorted(want) == sorted(raw)
            for s in got:
                n = len(got[s]["qp"])
                order = np.lexsort((got[s]["x"], got[s]["y"],
                                    got[s]["plane"]))
                rorder = np.lexsort((raw[s]["x"], raw[s]["y"],
                                     raw[s]["plane"]))
                for k in ("levels", "qp", "flags", "plane", "x", "y", "sm"):
                    g, w = got[s][k], want[s][k]
                    if g is None:
                        assert w is None and raw[s][k] is None
                        continue
                    assert np.array_equal(g, np.asarray(w)[:n]), (s, k)
                    assert np.array_equal(g[order], raw[s][k][rorder]), (s, k)
            pk = host_pack(a)
            assert pk["n"] == len(a.intra_jobs)


def test_ccp_scale_map_objects_branch_matches_jax():
    from openhevc_tpu.models.pipeline import ccp_scale_map as jax_map
    from openhevc_tpu_torch.models.pipeline import ccp_scale_map
    data = _stream("ccp")
    seen = 0
    for a, b, nat in zip(parsed_python(data), parsed_python(data, jax=True),
                         parsed_port(data)):
        got, want = ccp_scale_map(a), jax_map(b)
        assert got.dtype == want.dtype == np.int8
        assert np.array_equal(got, want)
        assert np.array_equal(got, ccp_scale_map(nat))
        seen += int(got.any())
    assert seen > 0
    for fs in parsed_python(_stream("444_nxn")):
        assert ccp_scale_map(fs) is None


# ---- host-scheduled in-loop filters ----------------------------------------

FILTER_420 = [   # W, H, ctb_log2, seed, pcm, tqb (tests/test_torch_filters.py)
    (64, 64, 4, 2, False, False),
    (64, 64, 5, 4, True, False),
    (64, 64, 5, 5, False, True),
    (128, 128, 6, 9, False, False),
]
FILTER_FMT = [   # fmt, W, H, ctb_log2, seed, pcm, tqb
    (2, 96, 64, 5, 32, True, False),
    (2, 96, 64, 4, 42, True, False),
    (3, 64, 64, 5, 37, False, True),
    (3, 96, 64, 4, 41, False, False),
]


def _filter_stream(fmt, W, H, ctb, seed, pcm, tqb):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    rng = np.random.default_rng(seed)
    kw = dict(qp=34, ctb_log2=ctb, seed=seed, pcm=pcm, sao=True,
              deblock=True)
    if fmt == 1:
        frames = make_frames(W, H, 2, rng, smooth=False)
    else:
        frames = _frames_fmt(W, H, 2, rng, fmt)
        kw.update(chroma_format_idc=fmt, min_cb_log2=3)
    if tqb:
        kw["transquant_bypass"] = True
    return encode_intra_stream(frames, W, H, **kw)[0]


@pytest.mark.parametrize("case", [(1,) + c for c in FILTER_420] + FILTER_FMT)
def test_apply_loop_filters_matches_jax(case):
    """The port's `apply_loop_filters` on the JAX package's unfiltered
    planes and the port's own FrameSymbols of the same pictures equals
    the JAX package's (and so the reference's CTB schedule); its
    boundary strengths and no-filter mask equal `deblock_np`'s."""
    from openhevc_tpu.ops import deblock_np
    from openhevc_tpu_torch.ops import filters
    from openhevc_tpu_torch.ops.filters_sched import apply_loop_filters
    data = _filter_stream(*case)
    ref = _capture_frames(data)
    port = parsed_port(data)
    assert len(ref) == len(port) == 2
    for (pre, fs_ref, want), fs in zip(ref, port):
        for g, w in zip(filters.boundary_strengths_vec(fs),
                        deblock_np.boundary_strengths(fs_ref)):
            assert np.array_equal(g, w)
        m, mw = filters._no_filter_mask(fs), deblock_np._no_filter_mask(fs_ref)
        assert (m is None) == (mw is None)
        assert m is None or np.array_equal(m, mw)
        got = apply_loop_filters([np.array(p) for p in pre], fs)
        for c in range(3):
            assert np.array_equal(np.asarray(got[c], np.int64), want[c]), c


def test_inter_boundary_strengths_equal_deblock_np():
    from openhevc_tpu.ops import deblock_np
    from openhevc_tpu_torch.ops import filters
    data = inter.stream("b_weighted_tmvp", deblock=True, sao=True)
    port = [fs for fs in parsed_port(data) if fs.inter_pbs]
    ref = [fs for _pre, fs, _t in _capture_frames(data) if fs.inter_pbs]
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        for g, w in zip(filters.boundary_strengths_vec(a),
                        deblock_np.boundary_strengths(b)):
            assert np.array_equal(g, w)


HOST_FILTERED = ["intra:ctb16", "intra:ctb64", "intra:pcm", "intra:tqb",
                 "intra:ten_bit", "inter:p", "inter:ra", "inter:ra_tiles",
                 "rext:444_b_filters", "rext:422_filters"]


def _host_filtered_stream(key):
    kind, name = key.split(":")
    if kind == "intra":
        return _intra_filtered(name)[0]
    if kind == "inter":
        kw = dict(sao=True, deblock=True)
        if name == "ra_tiles":
            kw["ctb_log2"] = 5
        return inter.stream(name, **kw)
    return rext.stream(name)


@pytest.mark.parametrize("key", HOST_FILTERED)
def test_host_filter_route_matches_np(key, monkeypatch):
    """With `prep_filters` forced to None every filtered picture's filter
    plan takes the host route: fetched unfiltered, filtered on the CTB
    schedule, kept on the host, and read there as a reference."""
    from openhevc_tpu_torch.models import pipeline
    from openhevc_tpu_torch.ops import filters
    data = _host_filtered_stream(key)
    want = _np(data)
    monkeypatch.setattr(filters, "prep_filters", lambda fs: None)

    class Timed(pipeline.TorchEngine):
        def __init__(self, device):
            super().__init__(device, sync_timers=True)
    monkeypatch.setattr(pipeline, "TorchEngine", Timed)
    dec = _port()
    got, pics = inter.decode(dec, data)
    rext.assert_same(got, want)
    assert not any(p.planes.device_filtered for p in pics)
    stages = dec._engine().stage_ms
    assert stages["host_filters"] > 0
    assert "deblock" not in stages and "sao" not in stages


def test_host_filter_route_matches_jax_decoder(monkeypatch):
    from openhevc_tpu_torch.ops import filters
    data = _intra_filtered("ctb16")[0]
    want = _jax(data)
    monkeypatch.setattr(filters, "prep_filters", lambda fs: None)
    rext.assert_same(rext.decode(_port(), data), want)


# ---- the starting planes of the JAX package's packed path ------------------

def _captured_pairs(data):
    """(port FrameSymbols, port refs, JAX FrameSymbols, JAX refs) of every
    inter picture, both from the Python parser."""
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder

    def capture(cls, **kw):
        class Capture(cls):
            def _reconstruct(self, fs, refs):
                self.seen.append((fs, refs))
                return super()._reconstruct(fs, refs)
        d = Capture(**kw)
        d.seen = []
        d.decode(data)
        d.flush()
        return [s for s in d.seen if s[0].inter_pbs]
    port = capture(Decoder, device="cpu", native_parse=False)
    ref = capture(JaxDecoder, engine="jax", native_parse=False)
    assert len(port) == len(ref) > 0
    return [a + b for a, b in zip(port, ref)]


def _jax_reconstruct(fs, refs):
    from openhevc_tpu.models.pipeline import JaxEngine
    out = JaxEngine().reconstruct(fs, refs)
    return [np.asarray(c) for c in (out.get() if hasattr(out, "get")
                                    else out)]


def _port_reconstruct(fs, refs):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    return [np.asarray(c) for c in TorchEngine("cpu").reconstruct(fs, refs)]


def _add_pcm(fs, x, y, size, rng, pcm_cls):
    """Make the size x size block at (x, y) of an inter picture a PCM
    block: no prediction there (pred_flag 0), random samples."""
    sps = fs.sps
    fs.motion.pred_flag[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2] = 0
    cs = (size >> sps.vshift1, size >> sps.hshift1)
    fs.pcm_blocks = list(fs.pcm_blocks) + [pcm_cls(
        x=x, y=y, size=size,
        samples_y=rng.integers(0, 256, (size, size)).astype(np.int32),
        samples_cb=rng.integers(0, 256, cs).astype(np.int32),
        samples_cr=rng.integers(0, 256, cs).astype(np.int32))]


def test_inter_picture_with_pcm_matches_jax_engine():
    """An inter picture with PCM blocks (the in-repo inter encoders write
    none, so two are put into parsed pictures, in both packages' symbols
    alike): the PCM samples over the inter prefill equal the JAX
    package's packed path (zeros + PCM, then inter_combine)."""
    from openhevc_tpu.symbols import PcmBlock as JaxPcm
    from openhevc_tpu_torch.symbols import PcmBlock
    for fs, refs, jfs, jrefs in _captured_pairs(inter.stream("p"))[:2]:
        pf = np.asarray(fs.motion.pred_flag)
        ys, xs = np.nonzero((pf[:-1:2, :-1:2] > 0) & (pf[1::2, 1::2] > 0))
        assert len(ys) >= 2
        for k in (0, len(ys) - 1):
            for f, cls in ((fs, PcmBlock), (jfs, JaxPcm)):
                _add_pcm(f, 8 * int(xs[k]), 8 * int(ys[k]), 8,
                         np.random.default_rng(k), cls)
        got = _port_reconstruct(fs, refs)
        for c in range(3):
            assert np.array_equal(got[c], _jax_reconstruct(jfs, jrefs)[c]), c
        p = fs.pcm_blocks[0]
        assert np.array_equal(got[0][p.y:p.y + 8, p.x:p.x + 8], p.samples_y)


@pytest.mark.parametrize("name", ["p", "constrained_intra", "ra"])
def test_inter_picture_with_no_usable_reference_matches_jax_engine(name):
    """None of the picture's references at hand: inter blocks stay 0
    (their residual dropped), intra blocks predict from that."""
    for fs, refs, jfs, jrefs in _captured_pairs(inter.stream(name))[:2]:
        for ours, theirs in (({}, {}),
                             ({p + 1000: r for p, r in refs.items()},
                              {p + 1000: r for p, r in jrefs.items()})):
            got = _port_reconstruct(fs, ours)
            want = _jax_reconstruct(jfs, theirs)
            for c in range(3):
                assert np.array_equal(got[c], want[c]), c


# ---- frames with no band plan -----------------------------------------------

@pytest.mark.parametrize("name", ["intra:ctb4", "inter:ra_tiles",
                                  "rext:444_b_filters", "rext:ccp"])
def test_no_band_plan_takes_the_whole_frame_kernel(name, monkeypatch):
    """Past the whole-frame gate with no band plan (as 4:2:2 UHD at CTB
    64, 4:4:4 from 2440 wide, 8K 4:2:0), every picture runs the
    whole-frame kernel on the padded frame; the output is
    `Decoder("jax")`'s."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as port
    kind, base = name.split(":")
    if kind == "intra":
        data = encode(64, 64, n=2, seed=5, qp=30, ctb_log2=4)[0]
    elif kind == "inter":
        data = inter.stream(base)
    else:
        data = rext.stream(base)
    want = _jax(data)
    monkeypatch.setattr(TorchEngine, "FUSED_VMEM_BUDGET", 0)
    monkeypatch.setattr(port, "VMEM_SCRATCH_BUDGET", 0)
    calls = {"intra_fused_ref": 0, "intra_fused_banded_ref": 0}
    for fn in calls:
        orig = getattr(port, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            calls[_fn] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(port, fn, spy)
    got = rext.decode(_port(), data)
    rext.assert_same(got, want)
    assert calls["intra_fused_ref"] == len(got)
    assert calls["intra_fused_banded_ref"] == 0


def test_refusals_that_stay_name_no_item():
    from openhevc_tpu_torch.models.pipeline import check_slice
    for sps, what in (
            (SimpleNamespace(chroma_format_idc=0, bit_depth=8,
                             bit_depth_chroma=8), "monochrome"),
            (SimpleNamespace(chroma_format_idc=1, bit_depth=8,
                             bit_depth_chroma=10), "unequal luma / chroma"),
            (SimpleNamespace(chroma_format_idc=3, bit_depth=14,
                             bit_depth_chroma=14), "bit depth 14")):
        with pytest.raises(NotImplementedError, match=what) as e:
            check_slice(SimpleNamespace(sps=sps, poc=0))
        assert "item" not in str(e.value)

