"""The native core's threaded wavefront (WPP) parse, on the CPU.

A small 10-bit random-access stream with WPP, deblocking, SAO, TMVP and
AMP (256x160 at CTB 16: ten rows of 16 CTBs, a hierarchical-B GOP of 4)
is parsed with 4 substream workers and with 1: every native output
array is equal, and the figures the core reports (`parse_stats`, and
the `parse` span's attributes under a profiler) say how each picture
was parsed. One entry point planted wrong makes the threaded attempt
fail: the serial re-parse gives the result, counted as `fallback` 1.
The port's whole decode equals the JAX package's `Decoder("np")` with
its Python parser, md5 for md5. Tolerance: none (integer outputs)."""
import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openhevc_tpu_torch.bitstream import bits
from openhevc_tpu_torch.config import DecoderConfig
from openhevc_tpu_torch.decoder import Decoder
from openhevc_tpu_torch.utils import trace

W, H, N = 256, 160, 5
ROWS = H // 16


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's own CPU threads beside the parse workers only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    from openhevc_tpu.encoder.inter_enc import encode_ra_stream
    from tools.make_feature_streams import smooth_moving
    pics = smooth_moving(W, H, N, seed=5, bd=10)
    return encode_ra_stream(pics, W, H, qp=32, gop=4, ctb_log2=4,
                            min_cb_log2=3, seed=5, tmvp=True, sao=True,
                            deblock=True, amp=True, bit_depth=10,
                            wpp=True)[0]


class ParseOnly(Decoder):
    """Keeps each parsed picture and reconstructs none."""

    def _reconstruct(self, fs, refs):
        self.parsed.append(fs)


def parse(data, threads):
    dec = ParseOnly(config=DecoderConfig(device="cpu",
                                         parse_threads=threads))
    dec.parsed = []
    dec.decode(data)
    dec.flush()
    assert dec.stats["python_slices"] == 0
    assert len(dec.parsed) == N
    return dec.parsed


def outputs(fs):
    """Every array the native core wrote for the picture."""
    out = {k: getattr(fs, k) for k in (
        "ipm", "pred_mode", "is_pcm", "tqb", "cbf_luma4", "bounds_v",
        "bounds_h", "qp_y4", "sao")}
    m = fs.motion
    out.update(mv_pf=m.pred_flag, mv=m.mv, mv_poc=m.refpoc,
               mv_refidx=m.ref_idx, pb=fs.inter_pbs._pb)
    for k, v in fs.native_raw.items():
        out["raw." + k] = v
    for k, v in fs.native_pack.items():
        out["pack." + k] = v
    return out


def assert_same_parse(got, want):
    for a, b in zip(got, want):
        assert a.poc == b.poc
        oa, ob = outputs(a), outputs(b)
        assert oa.keys() == ob.keys()
        for k in oa:
            assert np.array_equal(np.asarray(oa[k]), np.asarray(ob[k])), \
                (a.poc, k)


def test_threaded_parse_equals_serial(stream):
    threaded, serial = parse(stream, 4), parse(stream, 1)
    assert_same_parse(threaded, serial)
    for fs in threaded:
        assert fs.parse_stats["substreams"] == ROWS
        assert fs.parse_stats["threads"] == 4
        assert fs.parse_stats["fallback"] == 0
        assert fs.parse_stats["wave_wait_us"] >= 0
    for fs in serial:
        assert fs.parse_stats == dict(substreams=ROWS, threads=1,
                                      fallback=0, wave_wait_us=0)


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_parse_span_attributes(stream, threads):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        parse(stream, threads)
    got = [s for s in trace.spans() if s.name == "parse"]
    trace.clear()
    assert len(got) == N
    for s in got:
        assert s.attrs["route"] == "native"
        assert s.attrs["substreams"] == ROWS
        assert s.attrs["threads"] == threads
        assert s.attrs["fallback"] == 0
        assert isinstance(s.attrs["wave_wait_us"], int)
        if threads == 1:
            assert s.attrs["wave_wait_us"] == 0


def test_planted_entry_point_falls_back(stream, monkeypatch):
    """Row 5 handed row 4's entry point: the threaded attempt fails and
    the serial re-parse from the slice data's start gives the result."""
    real = bits.substream_starts_rbsp

    def planted(*a, **kw):
        starts = real(*a, **kw)
        starts[5] = starts[4]
        return starts

    monkeypatch.setattr(bits, "substream_starts_rbsp", planted)
    got = parse(stream, 4)
    monkeypatch.undo()
    assert_same_parse(got, parse(stream, 1))
    for fs in got:
        assert fs.parse_stats["fallback"] == 1
        assert fs.parse_stats["threads"] == 4


def md5s(pics):
    out = []
    for p in pics:
        h = hashlib.md5()
        for c in p.cropped():
            h.update(np.ascontiguousarray(np.asarray(c, np.uint16))
                     .tobytes())
        out.append(h.hexdigest())
    return out


def test_port_matches_np_md5(stream):
    from openhevc_tpu.decoder import Decoder as NpDecoder
    # the Python parser: the JAX package's native core threads WPP as the
    # port's does, and would be its own witness
    np_dec = NpDecoder("np", native_parse=False)
    want = md5s(np_dec.decode(stream) + np_dec.flush())
    dec = Decoder(device="cpu")
    got = md5s(dec.decode(stream) + dec.flush())
    assert dec.stats["python_slices"] == 0
    assert len(want) == N
    assert got == want
