"""The readers of the program's own spans (`hevcbench/spans.py` and the
metrics that use it) on synthetic spans and device intervals: a picture
is a display-layer `reconstruct` span with both layers' time added, self
time leaves out the children on the span's own thread, the idle share
counts only gaps in the device's work under a `parse_wait`, the hold
leaves out pictures that flush() returned, the window's spans are taken
once a run, and every reader returns None where the program records no
such span, as a program without the tracer does."""
import itertools
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT
from hevcbench import manifest, spans
from hevcbench.readings import Readings

NEW = ("parse_worker_ms.batch", "parse_wait_ms.batch",
       "decoder_self_ms.batch", "engine_host_ms.batch",
       "upsample_ms.batch", "stage1_hit_rate.batch",
       "idle_on_parse_wait.batch", "hold_aus.live", "delivery_ms.live")
MS = 1_000_000                  # ns
BASE = 7 * MS                   # the trace's base, ns
_ids = itertools.count(1)


def sp(name, start_ms, end_ms, pic=None, parent=None, tid=1, **attrs):
    return SimpleNamespace(name=name, id=next(_ids), parent=parent, pic=pic,
                           attrs=attrs, tid=tid, start_ns=start_ms * MS,
                           end_ns=end_ms * MS)


def window():
    """Two AUs of two layers: a decode call each, the parse of each
    picture on the worker (tid 2), the BL pictures reconstructed in the
    first call, the EL's in the second, one output, one flush."""
    d1 = sp("decode", 0, 40)
    d2 = sp("decode", 40, 100)
    fl = sp("flush", 100, 110)
    out = [d1, d2, fl]
    for i, (layer, d) in enumerate(((0, d1), (1, d1), (0, d2), (1, d2))):
        out.append(sp("parse", 1 + 20 * i, 11 + 20 * i, pic=(layer, i // 2),
                      parent=d.id, tid=2, route="native"))
    out += [
        sp("parse_wait", 2, 6, pic=(0, 0), parent=d1.id),
        sp("reconstruct", 10, 20, pic=(0, 0), parent=d1.id),
        sp("reconstruct", 20, 30, pic=(1, 0), parent=d1.id),
        sp("upsample", 30, 33, pic=(1, 0), parent=d1.id),
        sp("il_motion", 33, 34, pic=(1, 0), parent=d1.id),
        sp("parse_wait", 45, 55, pic=(0, 1), parent=d2.id),
        sp("gc", 50, 52, tid=3, generation=0),     # on another thread
        sp("reconstruct", 60, 80, pic=(0, 1), parent=d2.id),
        sp("reconstruct", 80, 90, pic=(1, 1), parent=d2.id),
        sp("mc_stage1", 61, 62, pic=(0, 1), hits=3, misses=1),
        sp("mc_stage1", 81, 82, pic=(1, 1), hits=0, misses=4),
        sp("crop_pack", 88, 89, pic=(1, 1)),
        sp("output", 95, 95, pic=(1, 0), parent=d2.id, call=2, fed=1,
           flush=False),
        sp("output", 105, 105, pic=(1, 1), parent=fl.id, call=2, fed=2,
           flush=True),
        sp("fetch", 111, 113, pic=(1, 0)),
    ]
    return out


@pytest.fixture
def program(monkeypatch):
    """The program's span buffer, `held["spans"]`, emptied when the
    window takes it; the trace's base fixed at BASE."""
    from openhevc_tpu_torch.utils import trace
    held = {"spans": []}
    monkeypatch.setattr(trace, "spans", lambda: list(held["spans"]))
    monkeypatch.setattr(trace, "clear", lambda: held.update(spans=[]))
    monkeypatch.setattr(spans, "base_ns", lambda: BASE)
    return held


def readers():
    return {n: manifest.reader(ROOT, n) for n in NEW}


def test_every_new_metric_has_its_reader_and_entry():
    man = manifest.load(ROOT)
    got = {m["name"]: m for m in man["per_layer"]}
    assert set(NEW) <= set(got)
    assert got["idle_on_parse_wait.batch"]["source"] == "device_trace"
    assert got["stage1_hit_rate.batch"]["source"] == "program_counter"
    assert got["upsample_ms.batch"]["workloads"] == ["shvc_x2_batch"]
    assert got["hold_aus.live"]["moves"] == "picture_latency_p95_ms"


def test_per_picture_counts_the_display_layer(program):
    program["spans"] = window()
    w = spans.window(Readings(window_s=1.0))
    assert w.pictures == 2
    # parse: 4 x 10 ms over 2 EL pictures
    assert w.ms(("parse",)) == pytest.approx(20.0)
    assert w.ms(("reconstruct",)) == pytest.approx(25.0)
    assert w.ms(("upsample", "il_motion")) == pytest.approx(2.0)
    # one layer: its own pictures
    one = [s for s in window() if s.pic is None or s.pic[0] == 0]
    assert spans.Spans(one).pictures == 2
    # a wave counts its pictures
    wave = [sp("reconstruct", 0, 10, pic=(0, 0), pictures=3)]
    assert spans.Spans(wave).pictures == 3


def test_self_time_leaves_out_same_thread_children(program):
    program["spans"] = window()
    w = spans.window(Readings(window_s=1.0))
    # decode 1: 40 - (4 + 10 + 10 + 3 + 1), the worker's parses not
    # taken out; decode 2: 60 - (10 + 20 + 10 + 0); flush: 10
    # (the gc ran on another thread)
    assert w.self_ms(("decode", "flush")) == pytest.approx(
        (12 + 20 + 10) / 2)
    d1 = w.spans[0]
    assert w.self_parts(d1) == [(0, 2 * MS), (6 * MS, 10 * MS),
                                (34 * MS, 40 * MS)]


def test_each_reader_on_the_window(program):
    read = readers()
    program["spans"] = window()
    dev = [((d0 * MS - BASE) / 1e3, (d1 * MS - BASE) / 1e3, "k")
           for d0, d1 in ((0, 3), (4, 5), (50, 70))]
    r = Readings(window_s=0.2, busy_s=0.024, device_ops=dev)
    assert read["parse_worker_ms.batch"](r) == pytest.approx(20.0)
    assert read["parse_wait_ms.batch"](r) == pytest.approx(7.0)
    assert read["decoder_self_ms.batch"](r) == pytest.approx(21.0)
    assert read["engine_host_ms.batch"](r) == pytest.approx(25.0)
    assert read["upsample_ms.batch"](r) == pytest.approx(2.0)
    assert read["stage1_hit_rate.batch"](r) == pytest.approx(37.5)
    # parse_wait 2-6 ms: 3-4 idle, 5-6 idle (2 ms); 45-55: 45-50 idle
    # (5 ms); 7 ms of a 200 ms window
    assert read["idle_on_parse_wait.batch"](r) == pytest.approx(3.5)
    # the flushed picture is left out
    assert read["hold_aus.live"](r) == pytest.approx(1.0)
    # crop_pack 1 ms + fetch 2 ms over 2 pictures
    assert read["delivery_ms.live"](r) == pytest.approx(1.5)


def test_the_idle_share_takes_the_wait_self_time():
    """A child on the waiting thread (a collection) is not the wait; a
    span on another thread does not cut it."""
    w = sp("parse_wait", 0, 10)
    kid = sp("gc", 2, 4, parent=w.id)
    other = sp("gc", 5, 6, parent=w.id, tid=9)
    got = spans.Spans([w, kid, other]).idle_share(
        "parse_wait", [(8e3, 20e3, "k")], 100e3, 0)
    assert got == pytest.approx(6.0)
    assert spans.Spans([w]).idle_share("parse_wait", [], 100e3, 0) == \
        pytest.approx(10.0)


def test_the_hold_is_none_with_only_flushed_outputs():
    outs = [sp("output", 1, 1, pic=(0, i), call=5, fed=i, flush=True)
            for i in range(3)]
    assert spans.Spans(outs).hold() is None
    outs.append(sp("output", 1, 1, pic=(0, 4), call=7, fed=4, flush=False))
    assert spans.Spans(outs).hold() == 3.0


def test_the_window_is_taken_once_a_run(program):
    program["spans"] = window()
    r = Readings(window_s=1.0)
    a = spans.window(r)
    assert program["spans"] == []       # the program's buffer emptied
    assert spans.window(r) is a and a.pictures == 2
    assert spans.window(Readings(window_s=1.0)) is None


def test_no_span_no_reading(program):
    read = readers()
    r = Readings(window_s=1.0, busy_s=0.5, device_ops=[(0, 10, "k")])
    for name, fn in read.items():
        assert fn(r) is None, name
    # a single layer, no inter picture, no device op, no output
    d = sp("decode", 0, 10)
    program["spans"] = [d, sp("reconstruct", 1, 5, pic=(0, 0), parent=d.id)]
    r = Readings(window_s=1.0)
    got = {n: fn(r) for n, fn in read.items()}
    assert got.pop("decoder_self_ms.batch") == pytest.approx(6.0)
    assert got.pop("engine_host_ms.batch") == pytest.approx(4.0)
    assert all(v is None for v in got.values()), got


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """As on a parent without it: the module cannot be imported."""
    import openhevc_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "openhevc_tpu_torch.utils.trace", None)
    read = readers()
    r = Readings(window_s=1.0, busy_s=0.5, device_ops=[(0, 10, "k")])
    for name, fn in read.items():
        assert fn(r) is None, name
