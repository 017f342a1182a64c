"""Metric arithmetic on synthetic inputs: fps over the whole window (the
pictures output in it, a session cut at its end compared after it), the
seeded sample of the comparison, the latency percentile over every picture due (a
missing or wrong one counts as missing it), the device's idle share
from trace intervals, and each per-layer reader."""
import math
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT
from hevcbench import check, manifest
from hevcbench.drive import (Kept, Memory, Sampler, Session, Tamper,
                             Window, closed_loop)
from hevcbench.readings import Readings
from hevcbench.streams import hash_planes
from hevcbench.trace import device_busy, trace_intervals, WINDOW

SPS = SimpleNamespace(height=2, width=2, crop_left=0, crop_right=0,
                      crop_top=0, crop_bottom=0, hshift1=1, vshift1=1,
                      bit_depth=8)


def planes(v):
    import numpy as np
    return [np.full((2, 2), v, np.uint8), np.full((1, 1), v, np.uint8),
            np.full((1, 1), v, np.uint8)]


def md5(v):
    return hash_planes(planes(v), 8)


class FakePlanes:
    """A picture's flat output (Y, Cb, Cr of a 2x2 4:2:0 picture) where
    the program keeps it."""

    def __init__(self, v):
        import torch
        self._dev = torch.full((6,), v, dtype=torch.uint8)


class FakeDecoder:
    """Returns the picture of each access unit (POC and every sample =
    the AU's one byte) after a fixed delay, `LAG` access units late;
    flush() returns those held back."""
    DELAY = 0.01
    LAG = 0

    def __init__(self, device):
        self.held = []

    def decode(self, au):
        time.sleep(self.DELAY)
        self.held.append(SimpleNamespace(planes=FakePlanes(au[0]), sps=SPS,
                                         poc=au[0]))
        out = self.held[:max(0, len(self.held) - self.LAG)]
        self.held = self.held[len(out):]
        return out

    def flush(self):
        out, self.held = self.held, []
        return out


class LateDecoder(FakeDecoder):
    LAG = 2


STREAM = SimpleNamespace(aus=[bytes([i]) for i in range(5)],
                         el=[md5(i) for i in range(5)], bl=None)
POCS = [([0, 1, 2, 3, 4], None)]


def sampler(size=64, seed=3):
    s = Sampler(size, seed)
    s.alloc(SimpleNamespace(planes=FakePlanes(0)), "cpu")
    return s


@pytest.mark.parametrize("dec", [FakeDecoder, LateDecoder])
def test_fps_is_every_picture_over_the_whole_window(dec):
    el = sampler()
    mix = {"session": "repeat", "copies": 100}
    w = closed_loop([STREAM], mix, 3, 0.12, "cpu", dec, Memory("cpu"),
                    Tamper(), el)
    # one session, cut at the first access unit after 0.12 s
    assert len(w.sessions) == 1 and w.sessions[0].fed == len(w.fed)
    assert w.seconds >= 0.12 and w.seconds >= len(w.fed) * dec.DELAY
    # the window's pictures are those output in it; the ones the cut
    # session still held come after it, for the comparison alone
    assert w.pictures == len(w.fed) - dec.LAG
    assert el.n == len(w.fed)
    assert w.pictures / w.seconds <= 1 / dec.DELAY
    counts, attempted = check.closed(w, [STREAM], el, None, POCS)
    assert check.passed(counts) and attempted == len(w.fed)


def test_a_drained_session_flushes_each_copy_in_the_window():
    el = sampler()
    flushes = []

    class Counting(LateDecoder):
        def flush(self):
            flushes.append(len(self.held))
            return super().flush()

    mix = {"session": "repeat", "copies": 100, "drain": True}
    w = closed_loop([STREAM], mix, 3, 0.12, "cpu", Counting, Memory("cpu"),
                    Tamper(), el)
    fed = len(w.fed)
    # a flush after every whole copy in the window, then the cut's
    assert flushes == [2] * (fed // 5) + [fed % 5 and min(2, fed % 5)]
    assert w.pictures == fed - (fed % 5 and min(2, fed % 5))
    assert check.passed(check.closed(w, [STREAM], el, None, POCS)[0])


def test_sessions_that_end_in_the_window_are_flushed_in_it():
    el = sampler()
    w = closed_loop([STREAM], {"session": "repeat", "copies": 1}, 3, 0.12,
                    "cpu", LateDecoder, Memory("cpu"), Tamper(), el)
    assert len(w.sessions) >= 2
    assert all(s.fed == 5 for s in w.sessions[:-1])
    assert check.passed(check.closed(w, [STREAM], el, None, POCS)[0])


def test_the_sample_is_the_seeds_and_every_poc_is_held():
    pics = [SimpleNamespace(planes=FakePlanes(i % 5), sps=SPS, poc=i % 5)
            for i in range(40)]
    a, b, c = sampler(4, 7), sampler(4, 7), sampler(4, 8)
    for s in (a, b, c):
        s(pics)
    assert a.held == b.held and len(a.held) == 4
    assert sorted(a.held) == [0, 1, 2, 3]
    assert a.pocs == [i % 5 for i in range(40)]
    assert a.held != c.held         # another seed draws another sample
    # a sampled picture that is wrong, and a POC out of place, count
    w = Window(0.0, 1.0, sessions=[Session(0, 40, (0, 40))])
    assert check.passed(check.closed(w, [STREAM], a, None, POCS)[0])
    i = min(a.held.values())
    a.buf[[r for r, j in a.held.items() if j == i][0]].fill_(9)
    assert check.closed(w, [STREAM], a, None, POCS)[0]["el_wrong"] == 1
    b.pocs[-1] = 0
    assert check.closed(w, [STREAM], b, None, POCS)[0] == \
        {"el_wrong": 1, "el_missing": 0}


def live_window(arrive):
    """An open loop's window over a 3-AU stream fed 7 AUs, one due every
    0.1 s from t = 10; arrive: [(value, poc, arrival)]."""
    w = Window(10.0, 11.0)
    w.due = [10.0 + 0.1 * k for k in range(7)]
    w.arrived = [(Kept(planes(v), SPS, poc), t) for v, poc, t in arrive]
    return w


def test_latency_over_every_picture_due():
    stream = SimpleNamespace(el=[md5(v) for v in (5, 6, 7)], bl=None)
    pocs = [0, 1, 2]
    ok = [(5 + k % 3, k % 3, 10.0 + 0.1 * k + 0.02 * (k + 1))
          for k in range(7)]
    counts, due, lat = check.open_(live_window(ok), stream, (pocs, None))
    assert check.passed(counts) and due == 7
    assert lat == pytest.approx([0.02 * (k + 1) for k in range(7)])
    # the fifth picture wrong, the last never arrives
    bad = [a if k != 4 else (9, a[1], a[2]) for k, a in enumerate(ok[:6])]
    counts, due, lat = check.open_(live_window(bad), stream, (pocs, None))
    assert counts == {"el_wrong": 1, "el_missing": 1} and due == 7
    assert lat[4] == math.inf and lat[6] == math.inf
    assert lat[:4] == pytest.approx([0.02 * (k + 1) for k in range(4)])


def test_idle_share_from_synthetic_intervals():
    # window 0-100 us; ops 10-30 and 20-40 overlap (union 30), 60-70
    ops = [(10, 30, "k"), (20, 40, "k"), (60, 70, "memcpy"),
           (-5, 2, "k"), (99, 120, "late")]
    host = [(0, 100, "decode"), (40, 65, "host_pack")]
    out = device_busy(ops, host, (0, 100))
    assert out["busy_us"] == pytest.approx(2 + 30 + 10 + 1)
    assert out["idle_gaps"][:3] == [("decode", 29), ("host_pack", 20),
                                    ("decode", 8)]
    assert dict(out["top_ops"])["k"] == pytest.approx(2 + 20 + 20)
    assert device_busy([], host, (0, 100))["busy_us"] is None


def test_trace_intervals_read_the_window_span():
    trace = {"traceEvents": [
        {"ph": "X", "name": WINDOW, "cat": "user_annotation", "ts": 100,
         "dur": 50, "tid": 1},
        {"ph": "X", "name": "intra_fused_banded_kernel", "cat": "kernel",
         "ts": 110, "dur": 5, "tid": 9},
        {"ph": "X", "name": "host_pack", "cat": "user_annotation",
         "ts": 105, "dur": 10, "tid": 1},
        {"ph": "X", "name": "other thread", "cat": "cpu_op", "ts": 105,
         "dur": 10, "tid": 2}]}
    dev, host, window = trace_intervals(trace)
    assert window == (100.0, 150.0)
    assert dev == [(110.0, 115.0, "intra_fused_banded_kernel")]
    assert host == [(105.0, 115.0, "host_pack")]
    assert trace_intervals({"traceEvents": []})[2] == (0.0, 0.0)


def readers():
    man = manifest.load(ROOT)
    return {m["name"]: manifest.reader(ROOT, m["name"])
            for m in man["per_layer"]}


def test_each_reader_on_synthetic_readings():
    read = readers()
    r = Readings(window_s=2.0, busy_s=0.5, pictures=20,
                 device_ops=[(0, 1000, "intra_fused_banded_kernel(x)"),
                             (0, 3000, "at::elementwise")],
                 intra_bytes=3.35e6, hbm_bytes_per_s=3.35e12,
                 stage_ms={"host_pack": 1.0, "upload": 2.0, "residual": 3.0,
                           "meta_schedule": 4.0, "mc_stage1": 5.0,
                           "combine": 1.5, "deblock": 2.5, "sao": 0.5,
                           "crop_pack": 0.25},
                 fetch_ms=1.75, parse_ms=12.5)
    assert read["device_idle.batch"](r) == pytest.approx(75.0)
    # 1e-6 s least time over 1 ms of intra kernels
    assert read["intra_roofline.batch"](r) == pytest.approx(0.1)
    assert read["host_prep_ms.batch"](r) == pytest.approx(10.0)
    assert read["host_prep_ms.live"](r) == pytest.approx(10.0)
    assert read["mc_ms.batch"](r) == pytest.approx(6.5)
    assert read["filters_ms.batch"](r) == pytest.approx(3.0)
    assert read["fetch_ms.live"](r) == pytest.approx(2.0)
    assert read["parse_ms.batch"](r) == 12.5


def test_a_reader_with_nothing_to_read_returns_nothing():
    read = readers()
    r = Readings(window_s=2.0)
    for name, fn in read.items():
        assert fn(r) is None, name
    # no card in the table of peaks: no roofline
    r = Readings(window_s=1.0, busy_s=0.1, intra_bytes=10,
                 device_ops=[(0, 10, "intra_fused_kernel")])
    assert read["intra_roofline.batch"](r) is None
