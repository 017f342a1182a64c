"""Port picture waves on the frame axis (openhevc_tpu_torch/parallel/):
`WaveScheduler` against the JAX package's on seeded add sequences;
`DeviceMesh` (the port's stand-in for `jax.sharding.Mesh`); whole
decodes through `Decoder(device="cpu", mesh=DeviceMesh(["cpu"] * 4))`
against the JAX package's `Decoder("jax", mesh=Mesh(4 virtual CPU
devices))` and `Decoder("np")`, with the POCs of every wave equal to
the JAX package's; `ShvcDecoder(mesh=...)` against `ShvcDecoder("np")`.
Tolerance: none (integer samples, exact equality)."""
import numpy as np
import pytest
import torch

from conftest import make_frames


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices("cpu")
    assert len(devs) >= n, "tests/conftest.py gives 8 virtual CPU devices"
    return Mesh(np.array(devs[:n]), ("frame",))


def _cpu_mesh(n):
    from openhevc_tpu_torch.parallel import DeviceMesh
    return DeviceMesh(["cpu"] * n, ("frame",))


def _decode(dec, data):
    pics = dec.decode(data) + dec.flush()
    return [[np.asarray(c, np.int64) for c in p.cropped()] for p in pics], \
        pics


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c in range(3):
            assert np.array_equal(g[c], w[c]), (i, c)


class _WaveSpy:
    """Records, per call of `cls.reconstruct_wave`, each member's (POC,
    has inter blocks, has weights, width)."""

    def __init__(self, cls, monkeypatch):
        self.waves = []
        orig = cls.reconstruct_wave

        def spy(this, fs_list, refs_list=None):
            self.waves.append([(fs.poc, bool(fs.inter_pbs),
                                fs.weights is not None, fs.sps.width)
                               for fs in fs_list])
            return orig(this, fs_list, refs_list)

        monkeypatch.setattr(cls, "reconstruct_wave", spy)

    def pocs(self):
        return [[m[0] for m in w] for w in self.waves]


# ---- the scheduler -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_wave_scheduler_matches_jax(seed):
    """Random keys, each referencing a random subset of earlier keys,
    through both schedulers: the same waves flushed after every add, the
    same length, the same tail."""
    from openhevc_tpu.parallel.frames import WaveScheduler as JaxSched
    from openhevc_tpu_torch.parallel import WaveScheduler
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(0, 6))             # 0: clamped to 1
    ours, theirs = WaveScheduler(depth), JaxSched(depth)
    assert ours.max_wave == theirs.max_wave
    flushed = 0
    for key in range(60):
        k = int(rng.integers(0, key + 1))
        refs = {int(r) for r in rng.integers(0, key + 1, k)} \
            if rng.random() < 0.6 else set()
        a = ours.add(key, refs, ("item", key))
        b = theirs.add(key, refs, ("item", key))
        assert a == b
        flushed += bool(a)
        assert len(ours) == len(theirs)
    assert flushed > 3
    assert ours.flush() == theirs.flush()
    assert len(ours) == 0


# ---- the mesh ------------------------------------------------------------------

def test_device_mesh_shape_and_devices():
    from openhevc_tpu_torch.parallel import DeviceMesh
    m = DeviceMesh(["cpu", "cpu:0", torch.device("cpu")], ("frame",))
    assert list(m.shape.items()) == [("frame", 3)]
    assert m.devices.shape == (3,) and m.devices.dtype == object
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m2 = DeviceMesh([["cpu"] * 3] * 2, ("frame", "tile"))
    assert list(m2.shape.items()) == [("frame", 2), ("tile", 3)]
    assert m2.shape["frame"] == 2 and m2.devices.shape == (2, 3)


@pytest.mark.parametrize("devices,axes,err", [
    (["cpu"] * 2, ("tile",), ValueError),
    (["cpu"] * 2, ("frame", "tile"), ValueError),
    ([["cpu"] * 2] * 2, ("frame",), ValueError),
    ([], ("frame",), ValueError),
    (["cpu", "meta"], ("frame",), ValueError),
])
def test_device_mesh_rejects_bad_layouts(devices, axes, err):
    from openhevc_tpu_torch.parallel import DeviceMesh
    with pytest.raises(err):
        DeviceMesh(devices, axes)


def test_device_mesh_never_remaps_a_missing_card():
    """A CUDA entry past the cards there are raises RuntimeError, here
    (no card at all) and on a machine with cards alike."""
    from openhevc_tpu_torch.parallel import DeviceMesh
    past = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMesh(["cpu", past], ("frame",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceMesh(["cuda"], ("frame",))


def test_decoder_takes_only_a_device_mesh():
    from openhevc_tpu_torch.decoder import Decoder
    for bad in (object(), _jax_mesh(4), ["cpu"] * 4):
        with pytest.raises(TypeError, match="DeviceMesh"):
            Decoder(device="cpu", mesh=bad)
    dec = Decoder(mesh=_cpu_mesh(2))
    assert dec.device == torch.device("cpu")    # the mesh's first device
    assert dec._wave_max() == 2
    assert Decoder(device="cpu", mesh=_cpu_mesh(2), wave_depth=5) \
        ._wave_max() == 5


# ---- whole decodes on the frame axis -------------------------------------------

def _intra(W, H, n, seed, **kw):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = make_frames(W, H, n, np.random.default_rng(seed),
                         smooth=kw.pop("smooth", True))
    return encode_intra_stream(frames, W, H, seed=seed, **kw)[0]


def _ra(seed, **kw):
    from openhevc_tpu.encoder.inter_enc import encode_ra_stream
    frames = make_frames(64, 64, 17, np.random.default_rng(seed))
    return encode_ra_stream(frames, 64, 64, qp=31, gop=8, seed=seed, **kw)[0]


# tests/test_parallel.py's streams: name -> (stream, mesh size, pictures)
FRAME_AXIS = {
    "intra16": (lambda: _intra(64, 64, 16, 21, qp=30), 4, 16),
    "intra_filters_pcm": (lambda: _intra(64, 64, 9, 22, qp=34, ctb_log2=4,
                                         smooth=False, pcm=True, sao=True,
                                         deblock=True), 4, 9),
    "ra_gop8": (lambda: _ra(23, intra_period=8), 4, 17),
    "weighted_ra": (lambda: _ra(25, weighted=True), 4, 17),
    "odd5_mesh8": (lambda: _intra(48, 32, 5, 24, qp=30), 8, 5),
}


@pytest.mark.parametrize("name", sorted(FRAME_AXIS))
def test_frame_axis_decode_matches_jax_mesh_and_np(name, monkeypatch):
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu.parallel import MeshFrameDecoder as JaxMesh
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.parallel import MeshFrameDecoder
    make, n_mesh, n = FRAME_AXIS[name]
    data = make()
    ours = _WaveSpy(MeshFrameDecoder, monkeypatch)
    theirs = _WaveSpy(JaxMesh, monkeypatch)
    dec = Decoder(device="cpu", mesh=_cpu_mesh(n_mesh))
    got, pics = _decode(dec, data)
    want_np = _decode(JaxDecoder("np"), data)[0]
    want_jax = _decode(JaxDecoder("jax", mesh=_jax_mesh(n_mesh)), data)[0]
    assert len(got) == n
    _assert_same(got, want_np)
    _assert_same(got, want_jax)
    assert ours.pocs() == theirs.pocs()
    assert sum(len(w) for w in ours.waves) == n
    assert max(len(w) for w in ours.waves) <= n_mesh
    assert len(dec._wave_sched) == 0                 # flushed
    assert dec._pending is None
    filtered = name == "intra_filters_pcm"
    assert all(p.planes.device_filtered == filtered for p in pics)
    if name == "intra16":
        assert [len(w) for w in ours.waves] == [4] * 4
    if name == "odd5_mesh8":
        assert ours.pocs() == [[0] * 5]              # one wave, no padding
    inter_waves = [w for w in ours.waves if any(m[1] for m in w)]
    if name in ("ra_gop8", "weighted_ra"):
        assert max(len(w) for w in inter_waves) >= 3, ours.waves
    if name == "weighted_ra":
        assert [w for w in inter_waves if any(m[2] for m in w)
                and len(w) >= 3], ours.waves


def test_wave_depth_caps_the_waves(monkeypatch):
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.parallel import MeshFrameDecoder
    data = FRAME_AXIS["intra16"][0]()
    spy = _WaveSpy(MeshFrameDecoder, monkeypatch)
    got = _decode(Decoder(device="cpu", mesh=_cpu_mesh(4), wave_depth=3),
                  data)[0]
    _assert_same(got, _decode(JaxDecoder("np"), data)[0])
    assert [len(w) for w in spy.waves] == [3] * 5 + [1]


def test_one_engine_per_distinct_device():
    """Entries that look different but name one device share one
    TorchEngine (one stage-1 cache), however many waves run."""
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.parallel import DeviceMesh
    data = _ra(23, intra_period=8)
    mesh = DeviceMesh(["cpu", "cpu:0", torch.device("cpu"), "cpu"])
    dec = Decoder(device="cpu", mesh=mesh)
    got = _decode(dec, data)[0]
    _assert_same(got, _decode(JaxDecoder("np"), data)[0])
    assert list(dec._mesh_dec._engines) == [torch.device("cpu")]
    cache = dec._mesh_dec._engines[torch.device("cpu")]._stage1[True]
    assert cache.hits > 0


def test_shvc_decoder_takes_the_mesh(monkeypatch):
    """Both layers reconstruct in waves; the EL's inter-layer reference
    adds no dependency, so EL pictures batch; the BL's wave is flushed
    before the EL reads a BL picture."""
    from openhevc_tpu.decoder import ShvcDecoder as NpShvc
    from openhevc_tpu_torch.decoder import ShvcDecoder
    from openhevc_tpu_torch.parallel import MeshFrameDecoder
    from test_torch_shvc import _stream
    data, recons = _stream("x2")
    spy = _WaveSpy(MeshFrameDecoder, monkeypatch)
    dec = ShvcDecoder(device="cpu", mesh=_cpu_mesh(4))
    assert dec.bl.mesh is dec.el.mesh
    got, pics = _decode(dec, data)
    _assert_same(got, _decode(NpShvc("np"), data)[0])
    _assert_same(got, [[np.asarray(c, np.int64) for c in r] for r in recons])
    el_waves = [w for w in spy.waves
                if w[0][3] == 64 and len(w) >= 2 and any(m[1] for m in w)]
    assert el_waves, spy.waves
    assert all(p.sps.width == 64 for p in pics)
