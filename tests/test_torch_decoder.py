"""The whole slice: openhevc_tpu_torch `Decoder(device="cpu")` vs the
encoder's reconstruction and the JAX package's decoders on small intra
streams (WPP and PCM included), and NotImplementedError for what lies
outside the port (a mesh). Inter and filtered streams:
tests/test_torch_inter.py, tests/test_torch_filters.py; range extensions:
tests/test_torch_rext.py; two layers: tests/test_torch_shvc.py; the
routes off the main path: tests/test_torch_fallback.py. Tolerance: none
(8-bit samples)."""
import numpy as np
import pytest
import torch

from test_torch_parse import encode

CASES = {
    "ctb4": dict(W=64, H=64, qp=30, ctb_log2=4),
    "wpp_dct32": dict(W=128, H=64, qp=37, ctb_log2=6, wpp=True),
    "pcm": dict(W=64, H=64, qp=26, ctb_log2=4, pcm=True),
}


def _decode(dec, data):
    return [p.cropped() for p in dec.decode(data) + dec.flush()]


def _case(name, n=2):
    kw = dict(CASES[name])
    return encode(kw.pop("W"), kw.pop("H"), n=n, seed=5, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_decoder_matches_recon_and_np(name):
    from openhevc_tpu.decoder import Decoder as NpDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data, recons = _case(name)
    dec = Decoder(device="cpu")
    got = _decode(dec, data)
    want = _decode(NpDecoder("np"), data)
    assert len(got) == len(want) == len(recons) == 2
    for g, w, r in zip(got, want, recons):
        for c in range(3):
            assert g[c].dtype == np.uint8
            assert np.array_equal(g[c], w[c]) and np.array_equal(g[c], r[c])
    assert dec.stats["native_slices"] == 2
    assert dec.stats["python_slices"] == 0


def test_port_decoder_matches_jax_decoder():
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = _case("ctb4", n=1)
    got = _decode(Decoder(device="cpu"), data)
    want = _decode(JaxDecoder("jax"), data)
    assert len(got) == len(want) == 1
    for c in range(3):
        assert np.array_equal(got[0][c], want[0][c])


def test_outputs_stay_on_device_until_fetched():
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = _case("ctb4", n=1)
    dec = Decoder(device="cpu")
    pic = (dec.decode(data) + dec.flush())[0]
    assert pic.planes._mat is None
    assert isinstance(pic.planes._dev, torch.Tensor)
    assert pic.planes._dev.dtype == torch.uint8
    assert len(pic.planes) == 3 and pic.planes[0].shape == (64, 64)


@pytest.mark.parametrize("case,what", [
    ("inter_pcm", "PCM blocks.*Queue 1 item 9"),
    ("python_parser", "Python parser.*Queue 1 item 13"),
    ("shvc_mesh", "multi-device waves.*Queue 1 item 11"),
])
def test_outside_the_slice_raises(case, what):
    """Nothing this test once saw refused is refused now. An inter
    picture with PCM blocks decodes to the output of the JAX package's
    packed path (`JaxEngine.reconstruct` on the same symbols), a picture
    from the Python parser decodes equal to the encoder's reconstruction
    and `Decoder("np")` (tests/test_torch_fallback.py holds both at
    length), and `ShvcDecoder` takes a `parallel.DeviceMesh` for both
    layers (tests/test_torch_parallel.py decodes with it) while anything
    else given as a mesh raises TypeError. `what` is the refusal each
    case met before, kept as the test id."""
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    if case == "shvc_mesh":
        from openhevc_tpu_torch.parallel import DeviceMesh
        mesh = DeviceMesh(["cpu"] * 2)
        dec = ShvcDecoder(device="cpu", mesh=mesh)
        assert dec.bl.mesh is mesh and dec.el.mesh is mesh
        with pytest.raises(TypeError, match="DeviceMesh"):
            ShvcDecoder(device="cpu", mesh=object())
    elif case == "python_parser":
        from openhevc_tpu.decoder import Decoder as NpDecoder
        data, recons = encode(64, 64, n=1, seed=1, qp=30, ctb_log2=4)
        dec = Decoder(device="cpu", native_parse=False)
        got = _decode(dec, data)
        want = _decode(NpDecoder("np"), data)
        assert dec.stats["python_slices"] == 1
        for c in range(3):
            assert np.array_equal(got[0][c], want[0][c])
            assert np.array_equal(got[0][c], recons[0][c])
    else:
        from test_torch_inter import test_inter_pictures_outside_the_slice_raise
        test_inter_pictures_outside_the_slice_raise()


def test_unported_entry_points_raise():
    from openhevc_tpu_torch.decoder import Decoder
    with pytest.raises(NotImplementedError):
        Decoder(device="cpu", engine="np")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Decoder(device="cpu", mesh=object())
