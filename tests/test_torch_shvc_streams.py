"""The two-layer (SHVC) feature-matrix streams (feature_streams/shvc/,
written by tools/make_feature_streams.py --shvc) on the CPU: the manifest
is well formed; its small (tier B) streams are the CPU tests' two-layer
cases, each what the JAX package's encoder makes from its manifest entry,
byte for byte; both sidecars (EL pictures from the JAX package's
`ShvcDecoder("np")`, BL pictures from its `Decoder("np")` on layer 0) and
the predicted routes are those decoders'; the port's CPU decodes
(`ShvcDecoder(device="cpu")` and `Decoder(device="cpu")` on layer 0,
through the observer of chip_smoke.py's phase 9) give both sidecars'
md5s on every picture and take the predicted route on every picture of
both layers, on the default plan and on the forced one-CTB-row banded
plan; on the three 1080p (tier A) streams the first access unit. Phase
9's other helpers (the kernel checks, the generalised upsample check,
pair / tap mode, the CLI with -l 1 / -l 0) run here on the CPU; the
phase itself runs on the card (marker `gpu`). Tolerance: none (md5 of
integer samples)."""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bench_torch import first_frames, hash_pics
from tools import make_feature_streams as M

ENTRIES = chip_smoke.shvc_manifest()
BY_NAME = {e["name"]: e for e in ENTRIES}
TIER_B = [e["name"] for e in ENTRIES if e["tier"] == "B"]
TIER_A = [e["name"] for e in ENTRIES if e["tier"] == "A"]
ALL_FLAGS = dict(bl_inter=True, el_temporal=True, el_tmvp=True, col_il=True,
                 nonzero_il_mv=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's decodes (the pictures are
    small; torch's thread pool only adds overhead on them, and the test
    run shares its cores among workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_manifest_is_well_formed():
    with open(os.path.join(chip_smoke.SHVC_DIR, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert set(manifest["not_encodable"]) == set(M.SHVC_NOT_ENCODABLE)
    assert sorted(BY_NAME) == sorted(M.shvc_entries())
    assert len(TIER_B) == 12 and len(TIER_A) == 3
    total = 0
    for e in ENTRIES:
        data, el, bl = chip_smoke.shvc_stream(e)
        total += len(data) + 33 * (len(el) + len(bl))
        assert len(data) == e["bytes"]
        assert e["encoder"] == "encode_shvc_stream"
        assert len(el) == e["frames"] == len(e["routes"]["el"]) > 0
        assert len(bl) == e["bl_frames"] == len(e["routes"]["bl"]) == \
            e["frames"]
        assert all(len(h) == 32 for h in el + bl)
        assert e["sidecar"].startswith("openhevc_tpu.decoder.ShvcDecoder")
        assert e["bl_sidecar"].startswith("openhevc_tpu.decoder.Decoder")
        assert e["python_slices"] == {"bl": 0, "el": 0}
        assert [e["bl_width"], e["bl_height"]] == e["kwargs"]["bl_size"] \
            == e["pictures"]["bl"]
        assert [e["width"], e["height"]] == e["kwargs"]["el_size"] == \
            e["pictures"]["el"]
        assert e["reduced"]
        for lay in ("bl", "el"):
            for r in e["routes"][lay]:
                assert r["parse"] == "native" and r["filters"] == "none"
                assert r["plan"] in ("whole", "banded")
                assert r["mc"] == ("pair" if r["inter"] else "none")
                assert r["il_ref"] == (lay == "el" and r["inter"])
                assert not r["col_il"] or r["il_ref"]
        el_routes = e["routes"]["el"]
        assert any(r["col_il"] for r in el_routes) == \
            ("col_il" in e["features"])
        assert not el_routes[0]["inter"]            # the EL's IDR
    assert total < 12 * 2 ** 20
    for name in TIER_A:
        e = BY_NAME[name]
        assert e["frames"] == 5 and e["ctb_size"] == 64
        assert {r["plan"] for r in e["routes"]["el"]} == {"banded"}
        assert set(M.SHVC_FLAGS) <= set(e["features"])
        assert e["width"] == 1920 and e["height"] in (1080, 1088)
    assert {r["plan"] for r in BY_NAME["shvc_x2_1080p_ld"]["routes"]["bl"]} \
        == {"whole"}
    assert {r["plan"] for r in BY_NAME["shvc_snr_1080p_ld"]["routes"]["bl"]} \
        == {"banded"}
    ratios = {e["name"]: {"x2", "x1_5", "snr"} & set(e["features"])
              for e in ENTRIES}
    assert all(len(r) == 1 for r in ratios.values())
    assert {r.pop() for n, r in ratios.items() if n in TIER_A} == \
        {"x2", "x1_5", "snr"}


def test_tool_table_is_the_cpu_tests_cases():
    """Tier B is tests/test_torch_shvc.py's TWO_LAYER, with the same
    sizes, seeds, AU counts and flags, plus tests/test_shvc.py's SNR case
    with every inter-layer tool."""
    import test_torch_shvc as S
    table = dict(M.SHVC_TIER_B)
    assert table.pop("snr_col_il_mv") == ((48, 48), (48, 48), 58, 4,
                                          ALL_FLAGS)
    assert table == S.TWO_LAYER
    for name, (bl, el, seed, n, kw) in M.SHVC_TIER_B.items():
        e = BY_NAME[name]
        assert e["kwargs"] == dict(bl_size=list(bl), el_size=list(el), qp=30,
                                   seed=seed, **kw)
        assert e["pictures"] == dict(maker="noise_layers", bl=list(bl),
                                     el=list(el), n=n, seed=seed)


@pytest.mark.parametrize("bl,el,n,seed", [((32, 32), (64, 64), 4, 31),
                                          ((48, 32), (96, 64), 2, 43)])
def test_copied_picture_maker_is_its_original(bl, el, n, seed):
    import test_torch_shvc as S
    got = M.noise_frames(*el, n, np.random.default_rng(seed))
    want = S._frames(*el, n, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    got_layers = M.noise_layers(bl, el, n, seed)
    want_layers = (S._frames(*bl, n, rng), S._frames(*el, n, rng))
    for g_list, w_list in ((got, want), *zip(got_layers, want_layers)):
        assert len(g_list) == len(w_list) == n
        for g, w in zip(g_list, w_list):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_scene_layers_average_the_el_pictures_down():
    """Tier A's BL pictures: a 2x2 box filter at 2x, the EL picture at
    ratio 1, an area average at 1.5x (a flat plane stays flat, and each
    output sample lies between its inputs' extremes)."""
    bl, el = M.scene_layers((32, 16), (64, 32), 2, 5)
    for b, e in zip(bl, el):
        for p, q in zip(b, e):
            q = q.astype(np.int64)
            box = (q[0::2, 0::2] + q[1::2, 0::2] + q[0::2, 1::2] +
                   q[1::2, 1::2] + 2) // 4
            assert p.dtype == np.uint8 and np.array_equal(p, box)
    bl, el = M.scene_layers((48, 24), (48, 24), 2, 5)
    assert all(np.array_equal(p, q) for b, e in zip(bl, el)
               for p, q in zip(b, e))
    flat = np.full((30, 48), 77, np.uint8)
    assert np.array_equal(M.area_downscale(flat, 20, 32),
                          np.full((20, 32), 77, np.uint8))
    ramp = np.tile(np.arange(48, dtype=np.uint8) * 5, (3, 1))
    got = M.area_downscale(ramp, 2, 32)[0].astype(int)
    # output i covers input [1.5 i, 1.5 i + 1.5)
    lo = ramp[0, (np.arange(32) * 3) // 2].astype(int)
    hi = ramp[0, np.minimum((np.arange(32) * 3 + 2) // 2, 47)].astype(int)
    assert ((lo <= got) & (got <= hi)).all() and (np.diff(got) > 0).all()


@pytest.mark.parametrize("name", TIER_B)
def test_tier_b_stream_regenerates_from_its_entry(name):
    data = chip_smoke.shvc_stream(BY_NAME[name])[0]
    assert M.encode_shvc_entry(BY_NAME[name]) == data
    if name in M.SHVC_TIER_B and name != "snr_col_il_mv":
        import test_torch_shvc as S
        assert S._stream(name)[0] == data


@pytest.mark.parametrize("name", TIER_B)
def test_sidecars_and_routes_are_the_np_decoders(name):
    e = BY_NAME[name]
    data, el, bl = chip_smoke.shvc_stream(e)
    ref = M.reference_decode_layers(data)
    assert ref["el_md5"] == el == hash_pics(ref["el_pics"])
    assert ref["bl_md5"] == bl
    assert ref["routes"] == e["routes"]
    assert ref["python_slices"] == e["python_slices"]


@pytest.mark.parametrize("banded", [False, True], ids=["default", "banded"])
@pytest.mark.parametrize("name", TIER_B)
def test_port_cpu_decode_matches_both_sidecars(name, banded):
    """Phase 9's decodes on the CPU: both layers through `ShvcDecoder`
    (EL md5s) and layer 0 alone (BL md5s), every picture of each layer
    on its predicted route (with `banded`, forced onto the banded plan,
    one CTB row a band at its own width)."""
    e = BY_NAME[name]
    decs, pics, out = chip_smoke.decode_shvc(e, {}, banded=banded,
                                             device="cpu")
    assert out["md5_ok"] == out["frames"] == e["frames"]
    assert all(p.sps.width == e["width"] for p in pics)
    for lay, d in decs.items():
        assert [r["plan"] for r in d.routes] == \
            [("banded" if banded else r["plan"]) for r in e["routes"][lay]]
        assert d.stats["python_slices"] == 0
    decs, pics, out = chip_smoke.decode_shvc(e, {}, two_layers=False,
                                             banded=banded, device="cpu")
    assert out["md5_ok"] == out["frames"] == e["bl_frames"]
    assert all(p.sps.width == e["bl_width"] for p in pics)
    assert list(decs) == ["bl"]


def test_jax_decoder_matches_the_sidecar():
    from openhevc_tpu.decoder import ShvcDecoder
    data, el, _bl = chip_smoke.shvc_stream(BY_NAME["col_il_mv"])
    dec = ShvcDecoder("jax")
    assert hash_pics(dec.decode(data) + dec.flush()) == el


@pytest.mark.parametrize("name", TIER_A)
def test_tier_a_first_au_matches_sidecars(name):
    """The first AU (its BL and EL pictures: two VCL NALs) through the
    port on the CPU: EL and BL md5s (the BL picture as the two-layer
    decode holds it) and routes as the manifest has them (the EL on the
    banded plan)."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    e = BY_NAME[name]
    data, el, bl = chip_smoke.shvc_stream(e)
    layer = chip_smoke.shvc_layer_class({}, lambda _l, _fs: False)
    dec = type("CpuShvc", (ShvcDecoder,), {"layer_class": layer})(
        device="cpu")
    assert hash_pics(dec.decode(first_frames(data, 2)) + dec.flush()) == \
        el[:1]
    assert hash_pics([dec.bl.ref_pics[0]]) == bl[:1]
    assert dec.el.routes == e["routes"]["el"][:1]
    assert dec.bl.routes == e["routes"]["bl"][:1]
    assert dec.el.routes[0]["plan"] == "banded"


@pytest.mark.parametrize("name", ["x2", "col_il_mv_x1_5", "snr_col_il_mv"])
def test_phase9_stream_check_runs_on_the_cpu(name):
    """check_shvc_stream on the CPU, where both wrappers run their plain
    versions: every decode, the kernel checks on the kept pictures (each
    layer's first with jobs, the EL's first inter picture)."""
    out = chip_smoke.check_shvc_stream(BY_NAME[name], {}, repeats=1,
                                       device="cpu")
    e = BY_NAME[name]
    for key in ("bl_alone", "banded", "bl_banded"):
        assert out[key]["md5_ok"] == out[key]["frames"] > 0
    n = out["checked"]["pictures"]
    assert n == 2 + any(r["inter"] and r["jobs"]
                        for r in e["routes"]["el"])
    assert out["checked"]["launches"] == {"intra_fused": n,
                                          "intra_fused_banded": n}


@pytest.mark.parametrize("name", ["x2", "x1_5", "snr"])
def test_upsample_check_runs_on_the_cpu(name):
    """The generalised phase-9 upsample check on a BL picture decoded on
    the CPU, at 2x, 1.5x and ratio 1: no time off a card."""
    from openhevc_tpu_torch.decoder import Decoder
    e = BY_NAME[name]
    dec = Decoder(device="cpu")
    pic = (dec.decode(first_frames(chip_smoke.shvc_stream(e)[0], 1)) +
           dec.flush())[0]
    out = chip_smoke.check_upsample(pic, e["width"], e["height"], 8)
    assert out["max_abs_err"] == 0 and out["ms"] is None
    assert out["bl"] == [e["bl_width"], e["bl_height"]]
    assert out["el"] == [e["width"], e["height"]]
    assert out["bound_ms"] > 0


def test_upsample_check_catches_a_wrong_plan(monkeypatch):
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import upsample as up
    e = BY_NAME["x1_5"]
    dec = Decoder(device="cpu")
    pic = (dec.decode(first_frames(chip_smoke.shvc_stream(e)[0], 1)) +
           dec.flush())[0]
    orig = up.upsample_plane_dev
    monkeypatch.setattr(up, "upsample_plane_dev",
                        lambda *a: orig(*a).flip(-1))
    with pytest.raises(AssertionError, match="per-sample"):
        chip_smoke.check_upsample(pic, e["width"], e["height"], 8)


def test_mc_modes_on_an_el_picture_with_two_references():
    """Phase 9's pair / tap check on the CPU: the EL's second AU of the
    1.5x stream with every tool, whose L0 holds the temporal and the
    inter-layer picture."""
    e = BY_NAME["col_il_mv_x1_5"]
    decs, _pics, _out = chip_smoke.decode_shvc(
        e, {}, keep=chip_smoke._shvc_keeper(), device="cpu")
    fs, refs = next((fs, r) for fs, r in decs["el"].kept if fs.inter_pbs)
    assert fs.poc == 1 and {0, 1} <= set(refs) and \
        {0, 1} <= set(fs.ref_poc_l0)
    out = chip_smoke.check_mc_modes(e["name"], fs, refs, "cpu", "phase9")
    assert out["pair"]["references"] == out["tap"]["references"] == 2


def test_shvc_routes_check_catches_a_wrong_prediction():
    e = json.loads(json.dumps(BY_NAME["col_il"]))
    for key, bad in (("il_ref", False), ("col_il", False), ("mc", "tap"),
                     ("plan", "banded")):
        e["routes"]["el"][2][key] = bad
        with pytest.raises(AssertionError, match="routes differ"):
            chip_smoke.decode_shvc(e, {}, device="cpu")
        e = json.loads(json.dumps(BY_NAME["col_il"]))
    e["python_slices"]["bl"] = 1
    with pytest.raises(AssertionError, match="Python parser"):
        chip_smoke.decode_shvc(e, {}, two_layers=False, device="cpu")


def test_cli_writes_both_layers_on_the_cpu():
    """Phase 9's CLI check with `-d cpu`: -l 1 writes the EL pictures and
    -l 0 the BL pictures, every frame md5-exact."""
    out = chip_smoke.check_shvc_cli([BY_NAME["col_il_mv"]], device="cpu")
    assert {k: v["frames"] for k, v in out.items()} == \
        {("col_il_mv", 1): 5, ("col_il_mv", 0): 5}


def test_upsample_plans_are_keyed_by_the_canonical_device(monkeypatch):
    """"cuda" and "cuda:0" are one card: the plan cache gives both the
    same entry (a raw torch.device key would miss and build the plans a
    second time)."""
    from openhevc_tpu_torch.ops import upsample as P
    monkeypatch.setattr(P, "_PLAN_CACHE", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    plans = P._plans(32, 32, 48, 48, True, "cpu")
    P._PLAN_CACHE[(32, 32, 48, 48, True, torch.device("cuda", 0))] = plans
    assert P._plans(32, 32, 48, 48, True, "cuda") is plans
    assert P._plans(32, 32, 48, 48, True, torch.device("cuda")) is plans
    assert P._plans(32, 32, 48, 48, True, "cuda:0") is plans


@pytest.mark.gpu
def test_shvc_matrix_phase_on_the_card():
    """Phase 9 of chip_smoke.py, alone (the card's machine has no JAX:
    this test file imports none at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    from openhevc_tpu_torch.ops import intra_fused as ifm
    counters = {"intra_fused": ifm.intra_fused,
                "intra_fused_banded": ifm.intra_fused_banded,
                "intra_fused_serial": ifm.intra_fused_serial}
    out = chip_smoke.run_shvc_matrix(counters)
    assert out["streams"] == len(ENTRIES)
    assert out["md5_ok"]["el"] == out["pictures"]["el"] == \
        sum(e["frames"] for e in ENTRIES)
    assert out["md5_ok"]["bl"] == out["pictures"]["bl"]
