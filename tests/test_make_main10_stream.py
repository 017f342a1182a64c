"""`tools/make_main10_stream.py`, which makes the benchmark's UHD Main 10
stream, on a small picture (128x64, CTB 64, 9 pictures: an IDR and a
hierarchical-B GOP of 8, WPP, deblocking, SAO).

The in-repo encoder quantizes with QpY where the decoder scales with
Qp'Y = QpY + 6 * (BitDepth - 8); the script hands the encoder Qp' while
it codes a picture. Its stream decodes (the JAX package's `Decoder("np")`
with the Python parser) to pictures close to the source, and the
numpy decoder in the encoder's own reference loop is left as it was.
Tolerance: PSNR against the source, which the quantizer bounds."""
import numpy as np
import pytest

from tools import make_main10_stream as tool

W, H, N = 128, 64, 9


def psnr(a, b, bd=10):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                   ** 2)
    return 10 * np.log10(((1 << bd) - 1) ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def made():
    return tool.encode(W, H, N, seed=3, qp=32)


def test_the_stream_decodes_close_to_its_source(made):
    from openhevc_tpu.decoder import Decoder
    from openhevc_tpu.ops import transforms_np as T
    data, pics = made
    assert T.quantize.__module__ == T.dequant.__module__ == T.__name__
    dec = Decoder("np", native_parse=False)
    out = dec.decode(data) + dec.flush()
    assert len(out) == N
    for p, src in zip(out, pics):
        assert p.sps.bit_depth == 10
        for plane, want in zip(p.cropped(), src):
            assert psnr(plane, want) > 30


def test_the_sidecar_is_one_line_a_picture(made):
    lines = tool.sidecar(made[0])
    assert len(lines) == N
    assert all(len(m) == 32 for m in lines)
    assert len(set(lines)) == N
