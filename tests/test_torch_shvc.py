"""SHVC in the port: the inter-layer upsample (`ops/upsample.py`) and the
host parts copied from the JAX package (`ops/upsample_np.py`) against
their twins on seeded inputs, and `ShvcDecoder(device="cpu")` against the
encoder's reconstruction and the JAX package's `ShvcDecoder("np")` /
`ShvcDecoder("jax")` on the small two-layer streams of
tests/test_shvc.py (x2, x1.5, SNR, rectangular; inter-layer motion,
mixed reference lists, TMVP with the inter-layer picture collocated).
None needs the C reference build. Tolerance: none (integer samples)."""
import numpy as np
import pytest
import torch


def _planes(w, h, bd, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if bd > 8 else np.uint8
    return [rng.integers(0, 1 << bd, shp).astype(dt)
            for shp in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


# ---- the upsample ----------------------------------------------------------

@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bl,el", [((32, 24), (64, 48)),     # x2
                                   ((32, 32), (48, 48)),     # x1.5
                                   ((48, 32), (48, 32)),     # SNR
                                   ((40, 24), (96, 64))])    # uneven ratio
def test_upsample_matches_jax_and_numpy(bl, el, bd):
    import jax.numpy as jnp
    from openhevc_tpu.ops.upsample import upsample_il_frame_dev as jax_up
    from openhevc_tpu.ops.upsample_np import upsample_il_frame
    from openhevc_tpu_torch.ops.upsample import upsample_il_frame_dev
    src = _planes(*bl, bd, seed=bl[0] * 100 + el[0] + bd)
    got = upsample_il_frame_dev(
        [torch.from_numpy(p.astype(np.int32)) for p in src], *el,
        bit_depth=bd)
    want_np = upsample_il_frame(src, *el, bit_depth=bd)
    want_jax = jax_up([jnp.asarray(p.astype(np.int32)) for p in src], *el,
                      bit_depth=bd)
    for c in range(3):
        assert got[c].dtype == torch.int32
        assert got[c].shape == ((el[1], el[0]) if c == 0
                                else (el[1] >> 1, el[0] >> 1))
        assert np.array_equal(got[c].numpy(), want_np[c]), c
        assert np.array_equal(got[c].numpy(), np.asarray(want_jax[c])), c
    if bl == el:
        assert np.array_equal(got[0].numpy(), src[0])   # phase 0: a copy


def test_upsample_reads_integer_planes_of_any_dtype():
    """The BL picture arrives as the int32 views of its uint8 / uint16
    flat output; other integer dtypes give the same samples."""
    from openhevc_tpu_torch.ops.upsample import upsample_il_frame_dev
    src = _planes(32, 32, 8, seed=3)
    want = upsample_il_frame_dev(
        [torch.from_numpy(p.astype(np.int32)) for p in src], 64, 64)
    got = upsample_il_frame_dev([torch.from_numpy(p) for p in src], 64, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kw", [dict(), dict(end_minus1=True),
                                dict(end_minus1=True, off16=-4)])
@pytest.mark.parametrize("luma", [True, False])
def test_axis_plan_matches_jax(luma, kw):
    """The port's plan has no scaled-reference-layer offsets (its window
    is the whole picture): it equals the JAX package's with a zero
    window."""
    from openhevc_tpu.ops import upsample as J
    from openhevc_tpu_torch.ops import upsample as P
    from openhevc_tpu_torch.ops.upsample_np import (UP_FILTER_CHROMA,
                                                    UP_FILTER_LUMA, scale_add)
    filt = UP_FILTER_LUMA if luma else UP_FILTER_CHROMA
    for n_in, n_out in ((32, 64), (32, 48), (40, 96), (48, 48)):
        scale, add = scale_add(n_in, n_out, phase=0 if luma else 1)
        got = P._axis_plan(n_out, n_in, scale, add, filt, **kw)
        want = J._axis_plan(n_out, n_in, scale, add, filt.shape[1], filt,
                            **kw)
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)


def test_plans_are_cached_per_mapping_and_device():
    from openhevc_tpu_torch.ops import upsample as P
    a = P._plans(32, 32, 64, 64, True, "cpu")
    assert P._plans(32, 32, 64, 64, True, torch.device("cpu")) is a
    assert P._plans(32, 32, 48, 48, True, "cpu") is not a
    assert P._plans(32, 32, 64, 64, False, "cpu") is not a
    assert P._plans(32, 32, 64, 64, True, "meta") is not a
    assert a[0].shape == (8, 64) and a[2].shape == (8, 64)
    assert a[0].dtype == torch.int64 and a[1].dtype == torch.int32


def test_host_parts_equal_the_jax_packages():
    from openhevc_tpu.ops import upsample_np as J
    from openhevc_tpu_torch.ops import upsample_np as P
    assert np.array_equal(P.UP_FILTER_LUMA, J.UP_FILTER_LUMA)
    assert np.array_equal(P.UP_FILTER_CHROMA, J.UP_FILTER_CHROMA)
    for bl, el, ph in ((32, 64, 0), (32, 48, 1), (416, 832, 0), (7, 7, 2)):
        assert P.scale_add(bl, el, ph) == J.scale_add(bl, el, ph)


@pytest.mark.parametrize("nb_list", [1, 2])
@pytest.mark.parametrize("bl,el", [((32, 32), (64, 64)), ((32, 32), (48, 48)),
                                   ((48, 48), (48, 48))])
def test_upscale_mv_field_matches_jax(bl, el, nb_list):
    from openhevc_tpu.ops.upsample_np import upscale_mv_field as jax_up
    from openhevc_tpu_torch.ops.upsample_np import upscale_mv_field
    rng = np.random.default_rng(bl[0] + el[0] + nb_list)
    h4, w4 = bl[1] // 4, bl[0] // 4
    motion = (rng.integers(0, 4, (h4, w4)).astype(np.uint8),
              rng.integers(-2000, 2000, (h4, w4, 2, 2)).astype(np.int32),
              rng.integers(0, 5, (h4, w4, 2)).astype(np.int32))
    args = (motion, *bl, *el, el[1] // 4, el[0] // 4, nb_list)
    got, want = upscale_mv_field(*args), jax_up(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].any()


# ---- whole decodes ---------------------------------------------------------

def _frames(w, h, n, rng):
    return [tuple([rng.integers(0, 256, (h, w)).astype(np.uint8),
                   rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
                   rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)])
            for _ in range(n)]


def shvc_stream(bl, el, seed, n=4, **kw):
    from openhevc_tpu.encoder.shvc_enc import encode_shvc_stream
    rng = np.random.default_rng(seed)
    blf = _frames(*bl, n, rng)
    elf = _frames(*el, n, rng)
    return encode_shvc_stream(blf, elf, bl, el, qp=30, seed=seed, **kw)


def decode(dec, data):
    pics = dec.decode(data) + dec.flush()
    return [[np.asarray(c) for c in p.cropped()] for p in pics]


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c in range(3):
            assert np.array_equal(g[c], np.asarray(w[c])), (i, c)


# tests/test_shvc.py::test_shvc_2layer and ::test_shvc_il_motion
TWO_LAYER = {
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
}


def _stream(name):
    bl, el, seed, n, kw = TWO_LAYER[name]
    return shvc_stream(bl, el, seed, n=n, **kw)


@pytest.mark.parametrize("name", sorted(TWO_LAYER))
def test_port_shvc_matches_recon_and_np(name):
    from openhevc_tpu.decoder import ShvcDecoder as NpShvc
    from openhevc_tpu_torch.decoder import ShvcDecoder
    data, recons = _stream(name)
    dec = ShvcDecoder(device="cpu")
    got = decode(dec, data)
    assert_same(got, recons)
    assert_same(got, decode(NpShvc("np"), data))
    el = TWO_LAYER[name][1]
    assert all(g[0].shape == (el[1], el[0]) for g in got)   # EL pictures only
    for d in (dec.bl, dec.el):
        assert d.stats["python_slices"] == 0


@pytest.mark.parametrize("name", ["x2", "col_il_mv"])
def test_port_shvc_matches_jax_decoder(name):
    from openhevc_tpu.decoder import ShvcDecoder as JaxShvc
    from openhevc_tpu_torch.decoder import ShvcDecoder
    data, _ = _stream(name)
    assert_same(decode(ShvcDecoder(device="cpu"), data),
                decode(JaxShvc("jax"), data))


def test_il_motion_is_live(monkeypatch):
    """Zeroing the upscaled inter-layer motion field must change a col_il
    stream's decode (TMVP really reads it)."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    from openhevc_tpu_torch.ops import upsample_np as U
    data, recons = _stream("col_il")
    orig = U.upscale_mv_field
    monkeypatch.setattr(U, "upscale_mv_field", lambda *a, **k: tuple(
        np.zeros_like(x) for x in orig(*a, **k)))
    got = decode(ShvcDecoder(device="cpu"), data)
    assert any(not np.array_equal(g[0], np.asarray(r[0]))
               for g, r in zip(got, recons))


def test_base_layer_is_never_copied_to_the_host(monkeypatch):
    """Outputs are fetched lazily and only EL pictures come out: no
    picture of either layer reaches the host while the stream decodes,
    and BL pictures and inter-layer references never do."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    from openhevc_tpu_torch.models import pipeline
    made, fetched = [], []
    init, get = pipeline.TorchPlanes.__init__, pipeline.TorchPlanes.get

    def spy_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def spy_get(self):
        fetched.append(self)
        return get(self)
    monkeypatch.setattr(pipeline.TorchPlanes, "__init__", spy_init)
    monkeypatch.setattr(pipeline.TorchPlanes, "get", spy_get)
    data, recons = _stream("mixed_l0")
    dec = ShvcDecoder(device="cpu")
    pics = dec.decode(data) + dec.flush()
    n = len(recons)
    # n BL pictures, n EL pictures, and an inter-layer reference for each
    # EL picture that predicts from its BL picture
    assert len(pics) == n and 2 * n < len(made) <= 3 * n and not fetched
    assert all(p._mat is None for p in made)
    assert_same([[np.asarray(c) for c in p.cropped()] for p in pics], recons)
    outs = {id(p.planes) for p in pics}
    assert {id(p) for p in fetched} == outs
    assert all((p._mat is not None) == (id(p) in outs) for p in made)
    small = [p for p in made if p._dims[:2] == (32, 32)]
    assert len(small) == n and all(p._mat is None for p in small)


def test_il_reference_leaves_the_stage1_cache():
    """The inter-layer reference lives for one picture: the EL's stage-1
    cache reuses its slot instead of growing with the stream, and no
    live entry outlasts the decoder's reference set."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    data, recons = _stream("x2")               # IL reference only
    dec = ShvcDecoder(device="cpu")
    assert_same(decode(dec, data), recons)
    cache = dec.el._engine()._stage1[True]
    assert cache.misses >= len(recons) - 1 and cache.hits == 0
    assert cache.bufs[0].shape[0] == 1
    data, recons = _stream("mixed_l0")         # temporal + IL references
    dec = ShvcDecoder(device="cpu")
    assert_same(decode(dec, data), recons)
    cache = dec.el._engine()._stage1[True]
    assert cache.bufs[0].shape[0] <= 3
    alive = [ref() for ref, _slot in cache.entries.values()
             if ref() is not None]
    held = {id(p.planes) for p in dec.el.ref_pics.values()}
    assert all(id(o) in held for o in alive)
    assert dec.bl._engine()._stage1[True].bufs is None or \
        dec.bl._engine()._stage1[True].bufs[0].shape[0] <= 2


def test_upsample_is_a_timed_stage():
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine

    class Timed(Decoder):
        def _engine(self):
            if self._torch_engine is None:
                self._torch_engine = TorchEngine(self.device,
                                                 sync_timers=True)
            return self._torch_engine

    class TimedShvc(ShvcDecoder):
        layer_class = Timed

    data, recons = _stream("x2")
    dec = TimedShvc(device="cpu")
    assert_same(decode(dec, data), recons)
    assert dec.el._engine().stage_ms["upsample"] > 0
    assert "upsample" not in dec.bl._engine().stage_ms


def test_shvc_entry_point_refuses_what_is_not_ported():
    """A `parallel.DeviceMesh` is taken (both layers decode in waves
    over it, their helpers on its first device when no device is given);
    any other mesh raises TypeError; without a card the default device
    raises."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    from openhevc_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh(["cpu"] * 2)
    dec = ShvcDecoder(mesh=mesh)
    assert dec.bl.device == dec.el.device == torch.device("cpu")
    assert dec.el.mesh is mesh and dec.el._wave_max() == 2
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShvcDecoder(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShvcDecoder()


def test_el_without_its_base_layer_names_its_reason():
    """An EL decoder whose BL decoder holds no picture builds no
    inter-layer reference; its pictures then have no usable reference
    and take the packed path's starting planes (inter blocks 0), as in
    the JAX package: the output equals its EL decoder's, fed alike."""
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = _stream("x2")
    el = Decoder(device="cpu", layer=1)
    el.shvc_bl = Decoder(device="cpu")         # never fed
    ref = JaxDecoder("jax", layer=1)
    ref.shvc_bl = JaxDecoder("jax")
    got, want = decode(el, data), decode(ref, data)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for c in range(3):
            assert np.array_equal(np.asarray(g[c]), np.asarray(w[c])), c
