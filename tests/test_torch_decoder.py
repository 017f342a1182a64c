"""The whole slice: openhevc_tpu_torch `Decoder(device="cpu")` vs the
encoder's reconstruction and the JAX package's decoders on small intra
streams (WPP and PCM included), and NotImplementedError for pictures
outside the slice. Tolerance: none (8-bit samples)."""
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


@pytest.mark.parametrize("kw,what", [
    (dict(deblock=True), "in-loop filters"),
    (dict(sao=True), "in-loop filters"),
])
def test_outside_the_slice_raises(kw, what):
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = encode(64, 64, n=1, seed=1, qp=30, ctb_log2=4, **kw)
    with pytest.raises(NotImplementedError, match=what):
        _decode(Decoder(device="cpu"), data)


def test_unported_entry_points_raise():
    from openhevc_tpu_torch.decoder import Decoder
    with pytest.raises(NotImplementedError):
        Decoder(device="cpu", engine="np")
    with pytest.raises(NotImplementedError):
        Decoder(device="cpu", mesh=object())
