"""Range extensions in the port: 4:2:2 / 4:4:4, 12 bits, scaling lists
and cross-component prediction.

Per function, on the same seeded inputs: the Python packer
(`_res_buckets`, `_pack_arena`, `pack_meta_native`, `ccp_scale_map`), the
device reader with scaling matrices (`_arena_levels`), the dequant
(`residual_bucket(sm=...)`) and `_apply_ccp` against their twins in the
JAX package. As a whole: `Decoder(device="cpu")` against the JAX
package's `Decoder("np")` and `Decoder("jax")` on small streams of the
repo's own encoders (the cases of tests/test_profiles.py's RExt tests,
scaling lists with and without in-loop filters, a frame forced onto the
banded plan with chroma bands as tall as luma bands). None needs the C
reference build. The CUDA kernels on such meta run only with a card
(marker `gpu`). Tolerance: none (integer samples, exact equality)."""
import numpy as np
import pytest
import torch

from conftest import make_frames
# the picture makers live in the feature-stream tool, so that its
# feature_streams/ and these tests encode the same pictures
from tools.make_feature_streams import fmt_frames as frames_fmt
from tools.make_feature_streams import ramps12 as frames12
from test_torch_intra import cuda  # noqa: F401  (a fixture)
from test_torch_parse import parsed_jax, parsed_port


# ---- streams ---------------------------------------------------------------

# name -> (kind, encoder keywords); kind "intra" / "lowdelay". W, H, n,
# seed are popped before the encoder sees the rest.
CASES = {
    # tests/test_profiles.py::test_rext_444_intra
    "444_nxn": ("intra", dict(seed=41, qp=30, chroma_format_idc=3)),
    "444_filters": ("intra", dict(seed=42, qp=32, chroma_format_idc=3,
                                  sao=True, deblock=True)),
    "444_ten_bit": ("intra", dict(seed=43, qp=30, chroma_format_idc=3,
                                  bit_depth=10)),
    "444_tskip": ("intra", dict(seed=44, qp=30, chroma_format_idc=3,
                                transform_skip=True)),
    "444_bypass": ("intra", dict(seed=45, qp=30, chroma_format_idc=3,
                                 transquant_bypass=True)),
    "444_tu32": ("intra", dict(seed=46, qp=34, chroma_format_idc=3, W=96,
                               ctb_log2=5)),
    # ::test_rext_444_inter
    "444_p": ("lowdelay", dict(seed=51, chroma_format_idc=3, n_refs=1)),
    "444_b_filters": ("lowdelay", dict(seed=52, chroma_format_idc=3,
                                       n_refs=2, b_slices=True, sao=True,
                                       deblock=True)),
    # ::test_rext_422_intra
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
    # ::test_rext_422_inter
    "422_p": ("lowdelay", dict(seed=21, chroma_format_idc=2, n_refs=1)),
    "422_b_filters_tmvp": ("lowdelay", dict(seed=22, chroma_format_idc=2,
                                            n_refs=2, b_slices=True, sao=True,
                                            deblock=True, tmvp=True)),
    "422_b_weighted": ("lowdelay", dict(seed=23, chroma_format_idc=2,
                                        n_refs=2, b_slices=True,
                                        weighted=True)),
    # ::test_rext_tools (rotation, implicit RDPCM, persistent Rice)
    "tools_rice": ("intra", dict(seed=141, qp=10, smooth=False,
                                 transform_skip=True,
                                 rext_persistent_rice=True)),
    "tools_rotation": ("intra", dict(seed=141, qp=30, smooth=False,
                                     transform_skip=True,
                                     rext_rotation=True)),
    "tools_rot_rdpcm": ("intra", dict(seed=141, qp=28, smooth=False,
                                      transform_skip=True, rext_rotation=True,
                                      rext_implicit_rdpcm=True)),
    "tools_lossless_rdpcm": ("intra", dict(seed=141, qp=26, smooth=False,
                                           transquant_bypass=True,
                                           rext_implicit_rdpcm=True)),
    "tools_all": ("intra", dict(seed=141, qp=12, smooth=False,
                                transform_skip=True, transquant_bypass=True,
                                rext_rotation=True, rext_implicit_rdpcm=True,
                                rext_persistent_rice=True)),
    # ::test_cross_component_prediction
    "ccp": ("intra", dict(seed=151, qp=30, chroma_format_idc=3,
                          cross_component=True)),
    # ::test_main12_intra, _filters, ::test_main444_12_intra
    "main12": ("intra", dict(seed=181, qp=30, bit_depth=12)),
    "main12_filters": ("intra", dict(seed=182, qp=26, bit_depth=12,
                                     ctb_log2=5, sao=True, deblock=True)),
    "main444_12": ("intra", dict(seed=183, qp=30, bit_depth=12,
                                 chroma_format_idc=3)),
    # the three streams tests/test_torch_decoder.py held to be refused
    "sl_default_deblock": ("intra", dict(seed=1, qp=30, smooth=True,
                                         scaling_list="default",
                                         deblock=True)),
    "sl_default_sao": ("intra", dict(seed=1, qp=30, smooth=True,
                                     scaling_list="default", sao=True)),
    "twelve_bit_smooth": ("intra", dict(seed=1, qp=30, bit_depth=12)),
    # explicit lists in the SPS / the PPS, with and without filters
    "sl_sps": ("intra", dict(seed=11, qp=30, smooth=True,
                             scaling_list="sps")),
    "sl_pps_filters_tu32": ("intra", dict(seed=12, qp=26, smooth=True,
                                          scaling_list="pps", ctb_log2=5,
                                          sao=True, deblock=True)),
    "sl_sps_444": ("intra", dict(seed=13, qp=30, chroma_format_idc=3,
                                 scaling_list="sps")),
    "sl_sps_p": ("lowdelay", dict(seed=31, scaling_list="sps")),
}


def stream(name):
    from openhevc_tpu.encoder.inter_enc import encode_lowdelay_stream
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    kind, kw = CASES[name]
    kw = dict(kw)
    W, H, seed = kw.pop("W", 64), kw.pop("H", 64), kw.pop("seed")
    idc, bd = kw.get("chroma_format_idc", 1), kw.get("bit_depth", 8)
    if kind == "lowdelay":
        fr = frames_fmt(W, H, 4, seed, idc, bd, moving=True)
        return encode_lowdelay_stream(fr, W, H, seed=seed, qp=30, ctb_log2=4,
                                      **kw)[0]
    smooth = kw.pop("smooth", None)
    if smooth is not None:
        fr = make_frames(W, H, 2, np.random.default_rng(seed), smooth=smooth)
        if bd > 8:
            fr = [tuple(p.astype(np.uint16) << (bd - 8) for p in f)
                  for f in fr]
    elif bd == 12:
        fr = frames12(W, H, 2, seed, chroma_full=idc == 3)
    else:
        fr = frames_fmt(W, H, 2, seed, idc, bd)
    kw.setdefault("ctb_log2", 4)
    return encode_intra_stream(fr, W, H, seed=seed, **kw)[0]


def decode(dec, data):
    pics = dec.decode(data) + dec.flush()
    return [[np.asarray(c) for c in p.cropped()] for p in pics]


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c in range(3):
            assert g[c].shape == w[c].shape, (i, c)
            assert np.array_equal(g[c], w[c]), (i, c)


# ---- whole decodes ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_port_decoder_rext_matches_np(name):
    from openhevc_tpu.decoder import Decoder as NpDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data = stream(name)
    dec = Decoder(device="cpu")
    got = decode(dec, data)
    assert_same(got, decode(NpDecoder("np"), data))
    assert dec.stats["python_slices"] == 0
    bd = CASES[name][1].get("bit_depth", 8)
    assert all(c.dtype == (np.uint16 if bd > 8 else np.uint8)
               for g in got for c in g)


@pytest.mark.parametrize("name", ["444_filters", "422_b_filters_tmvp", "ccp",
                                  "main12", "sl_sps", "sl_default_deblock"])
def test_port_decoder_rext_matches_jax_decoder(name):
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data = stream(name)
    assert_same(decode(Decoder(device="cpu"), data),
                decode(JaxDecoder("jax"), data))


def _force_banded(monkeypatch, W, cs, hs, vs):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as port
    monkeypatch.setattr(TorchEngine, "FUSED_VMEM_BUDGET", 0)
    monkeypatch.setattr(port, "VMEM_SCRATCH_BUDGET",
                        port.one_row_budget(W, cs, hs, vs))


@pytest.mark.parametrize("name", ["444_nxn", "444_tu32", "444_b_filters",
                                  "422_tu_pairs", "422_p", "ccp",
                                  "sl_sps_444"])
def test_banded_plan_with_tall_chroma_bands(name, monkeypatch):
    """vs = 0: a chroma band is as tall as a luma band (4:4:4, and 4:2:2
    with half the width). One CTB row a band, so every top reference
    crosses a band."""
    from openhevc_tpu.decoder import Decoder as NpDecoder
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import intra_fused as port
    kw = CASES[name][1]
    hs = 0 if kw["chroma_format_idc"] == 3 else 1
    data = stream(name)
    want = decode(NpDecoder("np"), data)
    _force_banded(monkeypatch, kw.get("W", 64), 1 << kw.get("ctb_log2", 4),
                  hs, 0)
    plans, calls = [], []
    orig = port.intra_fused_banded_ref
    monkeypatch.setattr(port, "intra_fused_banded_ref",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    dec = Decoder(device="cpu")
    eng = dec._engine()
    plan = eng.fused_plan
    eng.fused_plan = lambda fs: (plans.append(plan(fs)), plans[-1])[1]
    assert_same(decode(dec, data), want)
    assert plans and all(p[0] == "banded" and p[3] > 1 for p in plans)
    # chroma planes as tall as the luma plane
    assert all(p[1][0] == p[1][2] for p in plans)
    assert len(calls) == len(want)


def test_rext_444_bench_dims_take_the_banded_plan():
    """832x480 4:4:4: 15.7 MiB of padded planes, above the whole-frame
    gate that 832x480 4:2:0 passes; three bands of three CTB rows."""
    from types import SimpleNamespace
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    eng = TorchEngine("cpu")
    sps = SimpleNamespace(height=480, width=832, vshift1=0, hshift1=0,
                          ctb_size=64)
    plan = eng.fused_plan(SimpleNamespace(sps=sps, poc=0))
    assert plan == ("banded", (648, 1280, 648, 1280), 192, 3)
    sps = SimpleNamespace(height=480, width=832, vshift1=1, hshift1=1,
                          ctb_size=64)
    assert eng.fused_plan(SimpleNamespace(sps=sps, poc=0))[0] == "whole"


# ---- the Python packer against the JAX package's ---------------------------

PACKED = ["sl_default_deblock", "sl_sps", "sl_pps_filters_tu32",
          "sl_sps_444", "sl_sps_p", "422_tskip", "tools_all", "main12"]


@pytest.mark.parametrize("name", PACKED)
def test_res_buckets_match_jax(name):
    """The port packs exactly the n TUs of a size; the JAX package pads
    each bucket to a geometric row count with far-away coordinates.
    The first n rows must be equal, field for field."""
    from openhevc_tpu.models.pipeline import _res_buckets as jax_buckets
    from openhevc_tpu_torch.models.pipeline import _res_buckets
    data = stream(name)
    for a, b in zip(parsed_port(data), parsed_jax(data)):
        got, want = _res_buckets(a), jax_buckets(b)
        assert set(got) == set(want) and got
        for s in got:
            n = len(got[s]["qp"])
            assert n == int((np.asarray(want[s]["x"]) >= 0).sum())
            for key in ("levels", "qp", "flags", "plane", "x", "y"):
                assert np.array_equal(got[s][key], want[s][key][:n]), (s, key)
            if name.startswith("sl_"):
                assert np.array_equal(got[s]["sm"], want[s]["sm"][:n]), s
                assert got[s]["sm"].max() > 16 or got[s]["sm"].min() < 16 \
                    or "default" in name
            else:
                assert got[s]["sm"] is None and want[s]["sm"] is None


@pytest.mark.parametrize("name", PACKED)
def test_pack_arena_bytes_match_jax(name):
    """Same buckets in (the JAX package's, padding rows included): the
    sideband is byte-identical, the payload identical up to the JAX
    package's zero tail, the escapes identical once its (-1, -1) padding
    pairs are dropped, the caps identical but for the escape count."""
    from openhevc_tpu.models.pipeline import _pack_arena as jax_pack
    from openhevc_tpu.models.pipeline import _res_buckets as jax_buckets
    from openhevc_tpu_torch.models.pipeline import _pack_arena
    for fs in parsed_jax(stream(name)):
        buckets = jax_buckets(fs)
        a4, a16, esc, caps = _pack_arena(buckets)
        j4, j16, jesc, jcaps = jax_pack(buckets)
        assert a16.dtype == j16.dtype and np.array_equal(a16, j16)
        assert a4.dtype == j4.dtype == np.uint8
        n4 = len(a4) if any(c[1] for c in caps) else 0
        assert np.array_equal(a4[:n4], j4[:n4]) and not j4[n4:].any()
        assert esc.dtype == jesc.dtype == np.int32
        jpairs = jesc.reshape(-1, 2)
        jpairs = jpairs[jpairs[:, 0] >= 0]
        pairs = esc.reshape(-1, 2)
        if not sum(c[3] for c in caps):
            pairs = pairs[:0]
            jpairs = jpairs[:sum(c[3] for c in jcaps)]
        assert np.array_equal(pairs, jpairs)
        assert [c[:3] for c in caps] == [c[:3] for c in jcaps]
        assert all(c[3] <= j[3] for c, j in zip(caps, jcaps))


@pytest.mark.parametrize("name", PACKED + ["ccp"])
def test_arena_levels_read_both_packers(name):
    """`_arena_levels` on the port's exact arenas gives back every TU's
    levels, coordinates and scaling matrix; on the JAX package's padded
    arenas of the same picture it equals the JAX package's reader."""
    from openhevc_tpu.models.pipeline import _arena_levels as jax_levels
    from openhevc_tpu.models.pipeline import _pack_arena as jax_pack
    from openhevc_tpu.models.pipeline import _res_buckets as jax_buckets
    from openhevc_tpu_torch.models.pipeline import (_arena_levels,
                                                    _pack_arena, _res_buckets)
    data = stream(name)
    for a, b in zip(parsed_port(data), parsed_jax(data)):
        buckets = _res_buckets(a)
        arenas = _pack_arena(buckets)
        seen = 0
        for s, cap, x, y, qpf, sm, lv in _arena_levels(
                *(torch.from_numpy(t) for t in arenas[:3]), arenas[3]):
            bk = buckets[s]
            assert cap == len(bk["qp"])
            assert np.array_equal(lv.numpy(), bk["levels"])
            assert np.array_equal(x.numpy(), bk["x"])
            assert np.array_equal(y.numpy(), bk["y"])
            assert np.array_equal((qpf >> 7).numpy(), bk["qp"])
            assert np.array_equal((qpf & 3).numpy(), bk["plane"])
            if bk["sm"] is None:
                assert sm is None
            else:
                assert np.array_equal(sm.numpy(), bk["sm"])
            seen += 1
        assert seen == len(buckets)
        j4, j16, jesc, jcaps = jax_pack(jax_buckets(b))
        got = list(_arena_levels(torch.from_numpy(j4), torch.from_numpy(j16),
                                 torch.from_numpy(jesc), jcaps))
        want = list(jax_levels(j4, j16, jesc, jcaps))
        assert len(got) == len(want) == seen
        for (s, cap, x, y, qpf, sm, lv), w in zip(got, want):
            assert (s, cap) == w[:2]
            assert np.array_equal(lv.numpy(), np.asarray(w[8]))
            assert np.array_equal(qpf.numpy(), np.asarray(w[6]))
            assert (sm is None) == (w[7] is None)
            if sm is not None:
                assert np.array_equal(sm.numpy(), np.asarray(w[7]))


@pytest.mark.parametrize("name", ["sl_sps", "sl_sps_444", "422_tu_pairs",
                                  "444_tu32", "444_ten_bit"])
def test_pack_meta_native_matches_jax(name):
    from openhevc_tpu.ops.intra_fused import pack_meta_native as jax_meta
    from openhevc_tpu_torch.models.pipeline import host_pack
    from openhevc_tpu_torch.ops.intra_fused import (meta6_native,
                                                    pack_meta_native)
    data = stream(name)
    for a, b in zip(parsed_port(data), parsed_jax(data)):
        got = pack_meta_native(a.native_raw)
        want = jax_meta(b.native_raw)
        assert got.dtype == want.dtype == np.int16 and got.shape[1] > 0
        assert np.array_equal(got, want)
        m6 = meta6_native(a.native_raw)
        n = m6.shape[1]
        assert np.array_equal(m6[:5], got)
        assert np.array_equal(m6[5], a.native_raw["ij_meta"][:, 6])
        assert m6[5].max() == a.native_raw["n_levels"]
        npk = host_pack(a)
        if name.startswith("sl_"):
            assert a.native_pack is None and npk["n"] == n
            assert np.array_equal(npk["meta6"], m6)
        else:
            # the native packer's meta (padded to its bucket) is the same
            assert npk is a.native_pack and npk["n"] == n
            assert np.array_equal(npk["meta6"][:, :n], m6)
            assert not npk["meta6"][:, n:].any()


def test_native_pack_is_skipped_exactly_with_scaling_lists():
    for name, has_pack in (("sl_sps", False), ("sl_default_sao", False),
                           ("main12", True), ("444_nxn", True)):
        for fs in parsed_port(stream(name)):
            assert (fs.native_pack is not None) == has_pack
            assert (fs.active_scaling() is None) == has_pack


def test_ccp_scale_map_matches_jax():
    from openhevc_tpu.models.pipeline import ccp_scale_map as jax_map
    from openhevc_tpu_torch.models.pipeline import ccp_scale_map
    data = stream("ccp")
    for a, b in zip(parsed_port(data), parsed_jax(data)):
        got, want = ccp_scale_map(a), jax_map(b)
        assert got.dtype == want.dtype == np.int8 and got.any()
        assert np.array_equal(got, want)
    for fs in parsed_port(stream("444_nxn")):
        assert ccp_scale_map(fs) is None


# ---- device functions against the JAX package's ----------------------------

@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_residual_bucket_with_scaling_matrices(s, bd):
    """Seeded levels, QPs up to the depth's maximum, scaling factors
    1..255, and rows of every kind: DST, transform skip, bypass, RDPCM."""
    import jax.numpy as jnp
    from openhevc_tpu.ops.idct import residual_bucket as jax_bucket
    from openhevc_tpu_torch.ops.idct import residual_bucket
    rng = np.random.default_rng(1000 * s + bd)
    n = 96
    lv = rng.integers(-40, 41, (n, s, s)).astype(np.int32)
    lv[rng.random((n, s, s)) < 0.6] = 0
    lv[:8] = rng.integers(-32768, 32768, (8, s, s))      # saturating rows
    qp = rng.integers(0, 52 + 6 * (bd - 8), n).astype(np.int32)
    sm = rng.integers(1, 256, (n, s, s)).astype(np.int32)
    is_dst = rng.random(n) < (0.3 if s == 4 else 0.0)
    tskip = rng.random(n) < 0.25
    bypass = ~tskip & (rng.random(n) < 0.2)
    has_rdpcm = (tskip | bypass) & (rng.random(n) < 0.5)
    vert = rng.random(n) < 0.5
    assert tskip.any() and bypass.any() and has_rdpcm.any()
    flags = (is_dst, tskip, bypass, vert, has_rdpcm)
    for m in (sm, None):
        want = np.asarray(jax_bucket(
            jnp.asarray(lv), jnp.asarray(qp), *(jnp.asarray(f) for f in flags),
            s=s, bit_depth=bd, sm=None if m is None else jnp.asarray(m)))
        got = residual_bucket(
            torch.from_numpy(lv), torch.from_numpy(qp),
            *(torch.from_numpy(f) for f in flags), s=s, bit_depth=bd,
            sm=None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_apply_ccp_matches_jax_with_int16_wrap():
    import jax.numpy as jnp
    from openhevc_tpu.models.pipeline import _apply_ccp as jax_ccp
    from openhevc_tpu_torch.models.pipeline import _apply_ccp
    rng = np.random.default_rng(7)
    H, W = 24, 40
    acc_l = rng.integers(-32768, 32768, (H, W)).astype(np.int32)
    acc_c = rng.integers(-32768, 32768, (2, H, W)).astype(np.int32)
    smap = rng.choice(np.array([0, 0, -8, -4, -2, -1, 1, 2, 4, 8], np.int8),
                      (2, H, W))
    want = np.asarray(jax_ccp(jnp.asarray(acc_l), jnp.asarray(acc_c),
                              jnp.asarray(smap), H, W))
    got = _apply_ccp(torch.from_numpy(acc_l), torch.from_numpy(acc_c),
                     torch.from_numpy(smap)).numpy()
    assert np.array_equal(got, want)
    tot = acc_c + ((smap.astype(np.int32) * acc_l[None]) >> 3)
    wraps = (smap != 0) & ((tot > 32767) | (tot < -32768))
    assert wraps.any() and np.array_equal(got[smap == 0], acc_c[smap == 0])
    assert np.all((got[wraps] >= -32768) & (got[wraps] <= 32767))


def test_derive_meta16_filters_chroma_only_in_444():
    """Row 5 (the smoothing filter) is set for chroma TUs in 4:4:4 and
    never otherwise; rows 10 and 12 (strong smoothing, edge filters) stay
    luma-only in both."""
    import jax.numpy as jnp
    from openhevc_tpu.models.pipeline import _derive_meta16 as jax_derive
    from openhevc_tpu_torch.ops.intra_fused import (derive_meta16,
                                                    pack_meta_native)
    fs = parsed_port(stream("444_tu32"))[0]
    m5 = pack_meta_native(fs.native_raw)
    for c444 in (True, False):
        got = derive_meta16(torch.from_numpy(m5), sdis=False, c444=c444,
                            strong=True).numpy()
        want = np.asarray(jax_derive(jnp.asarray(m5), False, c444, True))
        assert np.array_equal(got, want)
        chroma = got[4] > 0
        assert chroma.any() and bool(got[5][chroma].any()) == c444
        assert not got[10][chroma].any() and not got[12][chroma].any()


# ---- what still lies outside -----------------------------------------------

def test_unequal_bit_depths_raise():
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    fs = parsed_port(stream("444_nxn"))[0]
    fs.sps.bit_depth_chroma = 10
    with pytest.raises(NotImplementedError, match="unequal luma / chroma"):
        TorchEngine("cpu").reconstruct(fs)
    fs.sps.bit_depth = fs.sps.bit_depth_chroma = 14
    with pytest.raises(NotImplementedError, match="bit depth 14"):
        TorchEngine("cpu").reconstruct(fs)


# ---- the CUDA kernels on 4:4:4 / 4:2:2 meta (needs a card) -----------------

@pytest.mark.gpu
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", ["444_tu32", "444_filters", "444_b_filters",
                                  "422_tu_pairs", "422_pcm", "422_p",
                                  "main444_12", "ccp", "sl_sps_444"])
def test_kernels_on_rext_meta_match_plain(name, banded, monkeypatch,
                                          cuda):  # noqa: F811
    """Both level-parallel kernels on every picture of a 4:2:2 / 4:4:4
    stream (chroma TUs up to 32x32 with the smoothing filter, chroma bands
    as tall as luma bands) == their plain versions == the serial-order
    entry."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded,
                                                    intra_fused_banded_ref,
                                                    intra_fused_ref,
                                                    intra_fused_serial)

    class Capture(Decoder):
        def _reconstruct(self, fs, refs):
            self.seen.append((fs, refs))
            return super()._reconstruct(fs, refs)

    kw = CASES[name][1]
    if banded:
        _force_banded(monkeypatch, kw.get("W", 64),
                      1 << kw.get("ctb_log2", 4),
                      0 if kw["chroma_format_idc"] == 3 else 1, 0)
    d = Capture(device=cuda)
    d.seen = []
    d.decode(stream(name))
    d.flush()
    eng = TorchEngine(cuda)
    for fs, refs in d.seen:
        k = eng.prepare(fs, refs)
        assert (k["bounds"] is not None) == banded
        lead = (k["bounds"],) if banded else ()
        fn = intra_fused_banded if banded else intra_fused
        plain = intra_fused_banded_ref if banded else intra_fused_ref

        def run(f, *extra, lead=lead):
            luma, chroma = k["luma"].clone(), k["chroma"].clone()
            f(k["meta"], *lead, k["n"], luma, chroma, k["res_l"],
              k["res_c"], k["bd"], *extra)
            torch.cuda.synchronize()
            return luma, chroma

        before = fn.launches
        got = run(fn, k["order"], k["level_bounds"])
        assert fn.launches == before + (k["n"] > 0)
        for other in (run(plain), run(intra_fused_serial, lead=())):
            assert torch.equal(got[0], other[0])
            assert torch.equal(got[1], other[1])
