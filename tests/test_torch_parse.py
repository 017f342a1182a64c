"""Port parser and tables vs the JAX package's: the host half of
openhevc_tpu_torch is its own copy, so its native parse core must yield
byte-identical packed arenas (`native_pack`) and raw arrays
(`native_raw`), and its constant tables must equal the JAX package's.
Tolerance: none (integers, exact equality)."""
import numpy as np
import pytest
import torch

from conftest import make_frames


def encode(W, H, n=2, seed=0, smooth=True, **kw):
    """Seeded intra test stream -> (bytes, encoder recon planes)."""
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = make_frames(W, H, n, np.random.default_rng(seed), smooth=smooth)
    return encode_intra_stream(frames, W, H, seed=seed, **kw)


def _parsed(dec_cls, data, **kw):
    class _Parse(dec_cls):
        def _reconstruct(self, fs, refs):
            self.parsed.append(fs)

    d = _Parse(**kw)
    d.parsed = []
    d.decode(data)
    d.flush()
    return d.parsed


def parsed_port(data):
    """FrameSymbols of every picture from the port's parser."""
    from openhevc_tpu_torch.decoder import Decoder
    return _parsed(Decoder, data, device="cpu")


def parsed_jax(data):
    """FrameSymbols of every picture from the JAX package's parser."""
    from openhevc_tpu.decoder import Decoder
    return _parsed(Decoder, data, engine="jax", native_parse=True)


STREAMS = {
    "plain": dict(W=64, H=64, qp=30, ctb_log2=4),
    "wpp": dict(W=128, H=64, qp=30, ctb_log2=4, wpp=True),
    "pcm": dict(W=64, H=64, qp=26, ctb_log2=4, pcm=True),
    "dense": dict(W=64, H=64, qp=4, ctb_log2=5, smooth=False),
}


def stream(name, seed=0):
    kw = dict(STREAMS[name])
    return encode(kw.pop("W"), kw.pop("H"), seed=seed, **kw)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_pack_and_raw_identical(name):
    data, _ = stream(name)
    port, ref = parsed_port(data), parsed_jax(data)
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        pa, pb = a.native_pack, b.native_pack
        assert pa is not None and pb is not None
        assert pa["caps"] == pb["caps"] and pa["n"] == pb["n"]
        for k in ("arena4", "arena16", "esc", "meta"):
            assert pa[k].dtype == pb[k].dtype, k
            assert np.array_equal(pa[k], pb[k]), k
        ra, rb = a.native_raw, b.native_raw
        assert ra["n_levels"] == rb["n_levels"]
        for k in ("cb_meta", "cb_levels", "ij_meta", "ij_avail"):
            assert np.array_equal(ra[k], rb[k]), k
        assert len(a.pcm_blocks) == len(b.pcm_blocks)
        for p, q in zip(a.pcm_blocks, b.pcm_blocks):
            assert (p.x, p.y, p.size) == (q.x, q.y, q.size)
            assert np.array_equal(p.samples_y, q.samples_y)
    if name == "pcm":
        assert port[0].pcm_blocks, "stream has no PCM block"


def _jax_tables():
    from openhevc_tpu.ops import coeff_scan, transforms_np
    from openhevc_tpu.ops.intra_fused import _ANG, _INV
    d = {"DST4": transforms_np.DST4, "LEVEL_SCALE": transforms_np.LEVEL_SCALE,
         "ANG": _ANG, "INV": _INV}
    for s in (4, 8, 16, 32):
        d[f"DCT{s}"] = transforms_np.DCT[s]
        d[f"SCAN{s}"] = coeff_scan.SCAN[s]
        d[f"INV_SCAN{s}"] = coeff_scan.INV_SCAN[s]
    return d


def test_tables_from_numpy_round_trip():
    from openhevc_tpu_torch.ops.tables import (TABLES, numpy_tables,
                                               tables_from_numpy)
    ref = _jax_tables()
    got = tables_from_numpy(ref)
    assert set(got) == set(TABLES) == set(numpy_tables())
    for k, v in got.items():
        assert np.array_equal(v.numpy(), ref[k]), k
        assert torch.equal(v, TABLES[k]), k


def test_tables_from_numpy_rejects_mismatch():
    from openhevc_tpu_torch.ops.tables import tables_from_numpy
    ref = _jax_tables()
    with pytest.raises(KeyError):
        tables_from_numpy({k: v for k, v in ref.items() if k != "ANG"})
    bad = dict(ref, DST4=np.zeros((3, 3), np.int32))
    with pytest.raises(ValueError):
        tables_from_numpy(bad)
