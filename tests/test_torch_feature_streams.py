"""The feature-matrix streams (feature_streams/, written by
tools/make_feature_streams.py) on the CPU: the manifest is well formed
and covers every feature family; each small (tier B) stream is what the
JAX package's encoder makes from its manifest entry, byte for byte, and
the CPU tests' own stream functions make the same bytes; its md5 sidecar
and predicted routes are the JAX package's `Decoder("np")`'s; the port's
`Decoder(device="cpu")` gives the sidecar's md5s on every picture and
takes the predicted route on every picture (parse, filters, kernel plan,
jobs), through the same observer `chip_smoke.py`'s phase 8 uses on the
card; on the two 1080p (tier A) streams, the port's CPU decode of the
first picture matches the sidecar. The phase itself runs on the card
(marker `gpu`). Tolerance: none (md5 of integer samples)."""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bench_torch import first_frames, hash_pics
from tools import make_feature_streams as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(ROOT, "feature_streams")
ENTRIES = chip_smoke.feature_manifest()
BY_NAME = {e["name"]: e for e in ENTRIES}
TIER_B = [e["name"] for e in ENTRIES if e["tier"] == "B"]
TIER_A = [e["name"] for e in ENTRIES if e["tier"] == "A"]
# tier B streams of the content no bench stream has, decoded on the CPU
# on the forced banded plan too (the card decodes every tier B stream so)
BANDED_CPU = ["422_pcm", "444_bypass", "tools_lossless_rdpcm", "ccp",
              "main444_12", "sl_pps_filters_tu32", "ld_constrained_intra",
              "f_pcm_lf_disabled", "f_halo_ctb16", "f_tqb_pcm_ctb16"]


def _load(name):
    return chip_smoke.feature_stream(BY_NAME[name])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's decodes: on pictures this
    small torch's thread pool only adds overhead (the port's CPU decode
    of 444_p took 0.25 s with one thread and 1.3-6.8 s with eight, on an
    8-core CPU), and the test run shares its cores among workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_manifest_is_well_formed():
    with open(os.path.join(DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["families"] == list(M.FAMILIES)
    assert len(BY_NAME) == len(ENTRIES)
    assert 40 <= len(TIER_B) <= 80 and len(TIER_A) == 2
    # the tool's table and the manifest hold the same streams
    assert sorted(BY_NAME) == sorted(M.entries())
    total = 0
    for e in ENTRIES:
        data, md5s = _load(e["name"])
        total += len(data) + 33 * len(md5s)
        assert len(data) == e["bytes"]
        assert len(md5s) == e["frames"] == len(e["routes"]) > 0
        assert all(len(h) == 32 for h in md5s)
        assert e["sidecar"].startswith("openhevc_tpu.decoder.Decoder('np')")
        for key in ("encoder", "kwargs", "pictures", "edit", "source",
                    "features", "width", "height", "chroma_format_idc",
                    "bit_depth", "python_slices"):
            assert key in e, (e["name"], key)
        assert (e["width"], e["height"]) == (e["pictures"]["W"],
                                             e["pictures"]["H"])
        for r in e["routes"]:
            assert r["parse"] in ("native", "python")
            assert r["filters"] in ("none", "device", "host")
            assert r["plan"] in ("whole", "banded", "no_band_plan")
    assert total < 10 * 2 ** 20
    covered = {f for e in ENTRIES for f in e["features"]}
    assert sorted(set(M.FAMILIES) - covered) == []
    for name in TIER_A:
        e = BY_NAME[name]
        assert (e["width"], e["height"]) == (1920, 1080)
        assert e["frames"] == 5
        assert {r["plan"] for r in e["routes"]} == {"banded"}
        assert {r["filters"] for r in e["routes"]} == {"device"}
    assert BY_NAME["f422_10b_1080p_ld"]["chroma_format_idc"] == 2
    assert BY_NAME["f422_10b_1080p_ld"]["bit_depth"] == 10
    assert BY_NAME["f444_8b_1080p_ld"]["chroma_format_idc"] == 3


def test_tool_table_is_the_cpu_tests_cases():
    """Tier B takes the CPU tests' cases with their keyword arguments and
    seeds: the tool's entries equal the tests' own tables, and the tests'
    stream functions make the committed bytes."""
    import test_torch_filters as tf
    import test_torch_inter as ti
    import test_torch_rext as tr
    for name, (kind, kw) in tr.CASES.items():
        enc, kwargs, pics = M._rext(kind, **kw)
        e = BY_NAME[name]
        assert (e["encoder"], e["kwargs"], e["pictures"]) == \
            (enc, kwargs, pics), name
    for name, kw in ti.LOWDELAY.items():
        assert BY_NAME[f"ld_{name}"]["kwargs"] == \
            dict(dict(qp=32, ctb_log2=4, seed=21),
                 **{k: v for k, v in kw.items() if k != "W"}), name
    for name, kw in ti.RANDOM_ACCESS.items():
        assert BY_NAME[name]["kwargs"] == \
            dict(dict(qp=31, gop=8, ctb_log2=4, seed=31),
                 **{k: v for k, v in kw.items() if k not in ("W", "n")}), \
            name
    for name in ("ctb16", "ctb32_wpp", "ctb64", "pcm", "tqb"):
        kw = dict(tf.INTRA_FILTERED[name])
        e = BY_NAME[f"f_{name}"]
        assert (e["pictures"]["W"], e["pictures"]["H"]) == \
            (kw.pop("W"), kw.pop("H"))
        assert e["kwargs"] == dict(dict(sao=True, deblock=True, qp=34,
                                        seed=3), **kw), name
    for name, data in (("422_b_filters_tmvp", tr.stream("422_b_filters_tmvp")),
                       ("main444_12", tr.stream("main444_12")),
                       ("ld_two_slices", ti.stream("two_slices")),
                       ("ra_tiles", ti.stream("ra_tiles")),
                       ("f_pcm", tf._intra_filtered("pcm")[0]),
                       ("f_422_ctb16_sao_pcm", _matrix_fmt_stream(
                           2, 96, 64, 4, 42, pcm=True, sao=True,
                           deblock=True))):
        assert _load(name)[0] == data, name


def _matrix_fmt_stream(fmt, W, H, ctb, seed, **kw):
    """A stream of tests/test_torch_filters.py's MATRIX_FMT, built as
    its test builds it (pictures from tests/test_device_filters.py)."""
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    from test_device_filters import _frames_fmt
    frames = _frames_fmt(W, H, 2, np.random.default_rng(seed), fmt)
    return encode_intra_stream(frames, W, H, qp=34, ctb_log2=ctb, seed=seed,
                               chroma_format_idc=fmt, min_cb_log2=3,
                               **kw)[0]


@pytest.mark.parametrize("case", ["ramps", "ramps_noise", "ramps_10bit",
                                  "noise_fmt_422", "noise_fmt_444"])
def test_copied_picture_maker_is_its_original(case):
    """The tool's copies of two pre-port tests' picture makers make the
    same pictures as their originals (tests/conftest.py `make_frames`,
    shifted up as tests/test_torch_filters.py shifts it, and
    tests/test_device_filters.py `_frames_fmt`)."""
    from conftest import make_frames
    from test_device_filters import _frames_fmt
    rng = np.random.default_rng(7)
    if case.startswith("noise_fmt"):
        fmt = 2 if case.endswith("422") else 3
        got = M.noise_fmt(96, 64, 3, 7, fmt)
        want = _frames_fmt(96, 64, 3, rng, fmt)
    else:
        smooth, bd = case == "ramps", 10 if case == "ramps_10bit" else 8
        got = M.ramps(96, 64, 3, 7, smooth=smooth, bd=bd)
        want = make_frames(96, 64, 3, rng, smooth=smooth)
        if bd > 8:
            want = [tuple(p.astype(np.uint16) << (bd - 8) for p in f)
                    for f in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", TIER_B)
def test_tier_b_stream_regenerates_from_its_entry(name):
    assert M.encode_entry(BY_NAME[name]) == _load(name)[0]


@pytest.mark.parametrize("name", TIER_B)
def test_sidecar_and_routes_are_the_np_decoders(name):
    e = BY_NAME[name]
    data, md5s = _load(name)
    got, routes, py_slices, pics = M.reference_decode(data)
    assert got == md5s == hash_pics(pics)
    assert routes == e["routes"]
    assert py_slices == e["python_slices"]


@pytest.mark.parametrize("name", TIER_B)
def test_port_cpu_decode_matches_sidecar_and_routes(name):
    """Every picture md5-exact and on its predicted route, through the
    observer of chip_smoke.py's phase 8."""
    e = BY_NAME[name]
    dec, pics, out = chip_smoke.decode_feature_stream(e, {}, device="cpu")
    assert out["md5_ok"] == out["frames"] == e["frames"]
    assert dec.routes == e["routes"]
    dt = np.uint16 if e["bit_depth"] > 8 else np.uint8
    assert pics[0].planes.get()[0].dtype == dt


@pytest.mark.parametrize("name", BANDED_CPU)
def test_port_cpu_decode_on_the_forced_banded_plan(name):
    """Phase 8's second decode of a tier B stream, every picture forced
    onto the banded plan with one CTB row a band: the sidecar's md5s,
    and every picture planned banded (PCM, lossless, scaling lists, CCP,
    12 bits, 4:2:2 / 4:4:4, constrained intra, the CTB-16 halo)."""
    e = BY_NAME[name]
    dec, _pics, out = chip_smoke.decode_feature_stream(e, {}, banded=True,
                                                       device="cpu")
    assert out["md5_ok"] == out["frames"] == e["frames"]
    assert [r["plan"] for r in dec.routes] == ["banded"] * e["frames"]
    from types import SimpleNamespace
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    idc = e["chroma_format_idc"]
    sps = SimpleNamespace(height=e["height"], width=e["width"],
                          ctb_size=e["ctb_size"], hshift1=int(idc < 3),
                          vshift1=int(idc == 1))
    with chip_smoke.forced_banded(e["width"], e["ctb_size"], idc):
        plan = TorchEngine("cpu").fused_plan(SimpleNamespace(sps=sps, poc=0))
    assert plan[0] == "banded" and plan[2] == e["ctb_size"]
    assert plan[3] == -(-e["height"] // e["ctb_size"]) > 1


@pytest.mark.parametrize("name", TIER_A)
def test_tier_a_first_picture_matches_sidecar(name):
    e = BY_NAME[name]
    data, md5s = _load(name)
    dec = chip_smoke.feature_decoder(lambda fs: False, device="cpu")
    pics = dec.decode(first_frames(data, 1)) + dec.flush()
    assert len(pics) == 1
    assert hash_pics(pics) == md5s[:1]
    assert dec.routes == e["routes"][:1]
    assert dec.routes[0]["plan"] == "banded"


def test_routes_check_catches_a_wrong_prediction():
    e = json.loads(json.dumps(BY_NAME["ld_p"]))
    routes = [dict(r) for r in e["routes"]]
    stats = {"python_slices": 0}
    chip_smoke.check_feature_routes(e, routes, stats)
    need = chip_smoke.check_feature_routes(
        e, routes, stats, {"intra_fused": 4, "intra_fused_banded": 0,
                           "intra_fused_serial": 0})
    assert need["intra_fused"] == sum(r["jobs"] > 0 for r in routes) == 4
    for bad in ({"plan": "banded"}, {"filters": "host"},
                {"parse": "python"}):
        wrong = [dict(routes[0], **bad)] + routes[1:]
        with pytest.raises(AssertionError, match="routes differ"):
            chip_smoke.check_feature_routes(e, wrong, stats)
    with pytest.raises(AssertionError, match="Python parser"):
        chip_smoke.check_feature_routes(e, routes, {"python_slices": 1})
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_feature_routes(
            e, routes, stats, {"intra_fused": 3, "intra_fused_banded": 0,
                               "intra_fused_serial": 0})


def test_intra_smoothing_edit_sets_only_that_flag():
    from openhevc_tpu.bitstream.ps import parse_sps
    from openhevc_tpu.bitstream.bits import unescape_rbsp
    from openhevc_tpu.decoder import split_nals

    def sps(data):
        nal = next(n for n in split_nals(data) if (n[0] >> 1) & 0x3F == 33)
        return vars(parse_sps(unescape_rbsp(nal[2:])))
    e = dict(BY_NAME["intra_smoothing_disabled"], edit={})
    before, after = sps(M.encode_entry(e)), sps(_load(e["name"])[0])
    assert before["intra_smoothing_disabled"] == 0
    assert after == dict(before, intra_smoothing_disabled=1)


@pytest.mark.parametrize("name", ["wpp_dct32", "ld_constrained_intra",
                                  "444_tu32", "422_pcm"])
def test_phase8_kernel_checks_run_on_the_cpu(name):
    """Part 3 of phase 8 on the CPU, where both wrappers run their plain
    versions: the kept pictures (the constrained-intra stream's inter
    one too), the whole-frame layout and the forced one-CTB-row band
    plan (one band on a one-row picture), one check a layout."""
    e = BY_NAME[name]
    dec = chip_smoke.feature_decoder(chip_smoke._keeper(e), device="cpu")
    dec.decode(_load(name)[0])
    dec.flush()
    out = chip_smoke.feature_kernels(e, dec.kept, 1, device="cpu")
    n = 2 if name == "ld_constrained_intra" else 1
    assert out == {"pictures": n, "launches": {"intra_fused": n,
                                                "intra_fused_banded": n}}
    assert any(fs.inter_pbs for fs, _ in dec.kept) == (n == 2)


@pytest.mark.gpu
def test_feature_matrix_phase_on_the_card():
    """Phase 8 of chip_smoke.py, alone (the card's machine has no JAX:
    this test file imports none at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    from openhevc_tpu_torch.ops import intra_fused as ifm
    counters = {"intra_fused": ifm.intra_fused,
                "intra_fused_banded": ifm.intra_fused_banded,
                "intra_fused_serial": ifm.intra_fused_serial}
    out = chip_smoke.run_feature_matrix(counters)
    assert out["streams"] == len(ENTRIES)
    assert out["pictures"] == sum(e["frames"] for e in ENTRIES)
    assert all(r["md5_ok"] == r["frames"] for r in out["by_stream"].values())


@pytest.mark.parametrize("name", [e["name"] for e in ENTRIES
                                  if "pcm" in e["features"]
                                  and e["tier"] == "B"])
def test_pcm_store_indices_never_repeat(name):
    """The engine writes PCM samples into the starting planes with one
    indexed store a plane; on a card the order of such a store is
    undefined where indices repeat, so they must not."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine, pcm_scatter
    seen = 0
    for fs in chip_smoke.parse_only(_load(name)[0], device="cpu"):
        if not fs.pcm_blocks:
            continue
        hl, wl, hc, wc = TorchEngine("cpu").fused_plan(fs)[1]
        il, _vl, ic, _vc = pcm_scatter(fs, wl, wc, hc)
        assert len(np.unique(il)) == len(il) > 0
        assert len(np.unique(ic)) == len(ic) > 0
        seen += 1
    assert seen
