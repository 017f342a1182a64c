"""The intra byte count that the roofline share divides by: the same for
a picture parsed by either of the program's parsers, and what the
picture's intra transform blocks hold."""
import os

import pytest

from conftest import BENCH
from hevcbench.drive import decoder_class
from hevcbench.streams import access_units
from hevcbench.work import intra_bytes, intra_samples


def parsed(path, native):
    """Every parsed picture of a stream, in decode order, from the
    program's decoder on the CPU with the native or the Python parser."""
    got = []

    class Decoder(decoder_class(False, on_recon=lambda l, fs: got.append(
            fs))):
        pass

    dec = Decoder(device="cpu", native_parse=native)
    for au in access_units(open(path, "rb").read()):
        dec.decode(au)
    dec.flush()
    return got


@pytest.mark.parametrize("name", ["ra_tiles.265"])
def test_intra_bytes_equal_for_both_parsers(name):
    path = os.path.join(BENCH, "tests", "streams", name)
    native = parsed(path, True)
    python = parsed(path, False)
    assert [fs.native_raw is not None for fs in native] == [True] * 9
    assert [fs.native_raw is None for fs in python] == [True] * 9
    counts = [intra_bytes(fs) for fs in native]
    assert counts == [intra_bytes(fs) for fs in python]
    assert counts[0] > 0
    # the IDR is all intra: every luma and chroma sample is predicted
    sps = native[0].sps
    assert intra_samples(native[0]) == sps.width * sps.height * 3 // 2
    assert counts[0] == intra_samples(native[0]) * 3
