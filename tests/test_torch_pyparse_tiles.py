"""The port's Python slice parser on tiled inter pictures: merge and AMVP
candidates in another tile are unavailable (6.4.1), so every picture's
motion fields from `Decoder(device="cpu", native_parse=False)` equal the
native parse's, and its whole decodes equal the native route's and the
JAX package's `Decoder("np")` (which parses natively).

The JAX package's own Python parser and its encoder's returned recon do
not gate these candidates by tile, so `Decoder("jax", native_parse=False)`
is no yardstick for these streams. Streams: `ra_tiles` of
tests/test_torch_inter.py and six tiled variants of it. Tolerance: none
(integer motion fields and samples)."""
import functools

import numpy as np
import pytest

import test_torch_inter as inter
from test_torch_parse import _parsed

TILED = {
    "ra_tiles": dict(),
    "tmvp": dict(tmvp=True),
    "weighted_tmvp": dict(weighted=True, tmvp=True),
    "sao_deblock_ctb32": dict(sao=True, deblock=True, ctb_log2=5),
    "wpp_tmvp": dict(wpp=True, tmvp=True),
    "ten_bit": dict(bit_depth=10),
    "four_cols": dict(tile_cols=4, tile_rows=1, W=256),
}
MOTION = ("pred_flag", "mv", "ref_idx", "refpoc")


@functools.lru_cache(maxsize=None)
def _stream(name):
    return inter.stream("ra_tiles", **TILED[name])


def _parse(data, native):
    """FrameSymbols of every picture from the port's parser, in decode
    order: the native core's, or the Python parser's."""
    from openhevc_tpu_torch.decoder import Decoder
    return _parsed(Decoder, data, device="cpu", native_parse=native)


@pytest.mark.parametrize("name", sorted(TILED))
def test_python_parse_motion_equals_native(name):
    data = _stream(name)
    py, nat = _parse(data, False), _parse(data, True)
    assert len(py) == len(nat) == 9
    assert all(a.native_raw is None for a in py)
    assert any(a.slice_type != 2 for a in py)
    for a, b in zip(py, nat):
        assert a.poc == b.poc
        for k in MOTION:
            assert np.array_equal(getattr(a.motion, k),
                                  getattr(b.motion, k)), (a.poc, k)


@pytest.mark.parametrize("name", sorted(TILED))
def test_python_parsed_decode_equals_native_and_np(name):
    from openhevc_tpu_torch.decoder import Decoder
    data = _stream(name)
    dec_py = Decoder(device="cpu", native_parse=False)
    got, pics = inter.decode(dec_py, data)
    dec_nat = Decoder(device="cpu")
    inter.assert_same(got, inter.decode(dec_nat, data)[0])
    inter.assert_same(got, inter.np_decode(data))
    assert len(got) == 9
    assert dec_py.stats["python_slices"] == len(pics)
    assert dec_py.stats["native_slices"] == 0
    assert dec_nat.stats["python_slices"] == 0


def test_pu_at_tile_column_edge_takes_no_candidate_across_it():
    """ra_tiles (128x64, CTB 16, 2x2 tiles), POC 8, the first P picture:
    the 8x8 PU at (64, 8) opens the right tile column; its left neighbour
    (63, 8) lies in the left column and carries the L0 MV (18, -20)."""
    data = _stream("ra_tiles")
    py, nat = _parse(data, False), _parse(data, True)
    a, b = py[1], nat[1]
    assert a.poc == b.poc == 8
    y4, x4 = 8 >> 2, 64 >> 2
    left = (18, -20)
    for fs in (a, b):
        assert tuple(fs.motion.mv[y4, x4 - 1, 0]) == left
        assert fs.motion.pred_flag[y4, x4 - 1] & 1
    assert b.motion.pred_flag[y4, x4] & 1
    assert tuple(b.motion.mv[y4, x4, 0]) != left
    assert np.array_equal(a.motion.mv[y4, x4], b.motion.mv[y4, x4])
    assert a.motion.pred_flag[y4, x4] == b.motion.pred_flag[y4, x4]
