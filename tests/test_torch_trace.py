"""The port's tracer (openhevc_tpu_torch/utils/trace.py) on the CPU.

With no profiler a decode records no span, opens no `record_function`
range and reads no clock. Under a CPU `torch.profiler` the spans nest as
the decoder's layers do (the parse on the parse-ahead worker, its
parent the `decode` that submitted it; `parse_wait`, `reconstruct` and
`output` under `decode` / `flush`; the engine's stages under
`reconstruct`), carry picture ids, give one `upsample` and one
`il_motion` per enhancement-layer picture, match the profiler's own
ranges by name, count and start, and carry the stage-1 cache's counters;
the hold of a low-delay picture is the parse-ahead depth + 1;
`sync_timers` keeps its stage keys; the buffer's cap drops and counts.
A `gpu` test holds the shared clock on the card to 0.1 ms."""
import gc
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openhevc_tpu_torch.bitstream.au_parser import AuParser
from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
from openhevc_tpu_torch.models import pipeline
from openhevc_tpu_torch.utils import trace
from test_torch_intra import cuda  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LD = os.path.join(ROOT, "feature_streams", "ld_p.265")
TWO_REFS = os.path.join(ROOT, "feature_streams", "ld_two_refs.265")
TWO_SLICES = os.path.join(ROOT, "feature_streams", "ld_two_slices.265")
SHVC = os.path.join(ROOT, "feature_streams", "shvc", "col_il_mv.265")
FILTERED = os.path.join(ROOT, "feature_streams", "f_ctb64.265")
STAGES = {"host_pack", "upload", "edge_params", "residual", "meta_schedule",
          "mc_stage1", "mc_stage2", "combine", "kernel", "deblock", "sao",
          "host_filters", "crop_pack"}


def aus(path, copies=1):
    p = AuParser()
    with open(path, "rb") as f:
        out = p.feed(f.read()) + p.flush()
    return out * copies


def decode(dec, units, fetch=True):
    """Every picture of `units` fed one a call, then flushed; fetched."""
    pics = []
    for au in units:
        pics += dec.decode(au)
    pics += dec.flush()
    if fetch:
        for p in pics:
            p.planes.get()
    return pics


def profiled(fn, all_threads=False, cuda_too=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if cuda_too else [])
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    with profile(activities=acts, **kw) as prof:
        out = fn()
    return out, prof


@pytest.fixture(autouse=True)
def _empty_buffer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def test_no_profiler_records_nothing(monkeypatch):
    """No span, no range, no clock read, no span object."""
    entered = []

    def no_range(*a, **k):
        entered.append(a)
        raise AssertionError("record_function entered")

    def no_clock():
        raise AssertionError("clock read")

    monkeypatch.setattr(trace._profiler, "record_function", no_range)
    monkeypatch.setattr(trace, "time", SimpleNamespace(
        perf_counter_ns=no_clock, time_ns=no_clock))
    monkeypatch.setattr(trace, "Span", no_range)
    pics = decode(Decoder(device="cpu"), aus(LD))
    pics += decode(ShvcDecoder(device="cpu"), aus(SHVC))
    gc.collect()
    assert len(pics) == 9
    assert trace.spans() == [] and entered == [] and trace.dropped() == 0
    assert trace.current() is None


def test_spans_nest_as_the_decoder_layers():
    dec = Decoder(device="cpu")
    pics, _ = profiled(lambda: decode(dec, aus(LD)))
    sp = trace.spans()
    by_id = {s.id: s for s in sp}
    main = threading.get_native_id()
    names = {s.name for s in sp}
    assert {"decode", "flush", "parse", "parse_wait", "reconstruct",
            "output", "fetch", "mc_stage1"} <= names
    n = len(pics)
    for s in sp:
        parent = by_id.get(s.parent)
        assert s.end_ns >= s.start_ns > 0
        if s.name in ("decode", "flush"):
            assert parent is None and s.tid == main
        elif s.name == "parse":
            # the worker's job: its parent the decode that submitted it
            assert s.tid != main and parent.name == "decode"
            assert s.attrs["route"] == "native"
        elif s.name in ("parse_wait", "reconstruct", "output"):
            assert s.tid == main and parent.name in ("decode", "flush")
        elif s.name in STAGES:
            assert parent.name == "reconstruct" and s.pic == parent.pic
        elif s.name == "fetch":
            assert parent is None and s.tid == main
        else:
            assert s.name == "gc", s
        if s.name not in ("decode", "flush", "gc"):
            assert s.pic is not None and s.pic[0] == 0, s
    want = {(0, i) for i in range(n)}
    for name in ("parse", "parse_wait", "reconstruct", "output", "fetch"):
        got = [s.pic for s in sp if s.name == name]
        assert sorted(got) == sorted(want), name
    assert sorted(p.pid for p in pics) == sorted(want)


def test_parse_wait_sits_under_decode():
    """With the default parse-ahead depth the waits fall in the decode
    calls that overfill the queue, the rest in the flush."""
    dec = Decoder(device="cpu")
    units = aus(LD)
    profiled(lambda: decode(dec, units))
    sp = trace.spans()
    by_id = {s.id: s for s in sp}
    waits = [s for s in sp if s.name == "parse_wait"]
    under = [by_id[s.parent].name for s in waits]
    assert len(waits) == len(units)
    assert under.count("decode") == len(units) - dec._parse_depth
    assert under.count("flush") == dec._parse_depth
    for s in waits:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_two_layers_one_upsample_and_il_motion_per_el_picture():
    dec = ShvcDecoder(device="cpu")
    pics, _ = profiled(lambda: decode(dec, aus(SHVC)))
    sp = trace.spans()
    by_id = {s.id: s for s in sp}
    el = sorted(s.pic for s in sp if s.name == "reconstruct" and
                s.pic[0] == 1)
    bl = [s.pic for s in sp if s.name == "reconstruct" and s.pic[0] == 0]
    assert len(el) == len(pics) == len(bl) > 1
    assert sorted(p.pid for p in pics) == el
    # every EL picture predicts from the BL picture of its AU, bar the
    # first (an IDR that this stream codes without it)
    for name in ("upsample", "il_motion"):
        got = [s for s in sp if s.name == name]
        assert sorted(s.pic for s in got) == el[1:], name
        assert all(by_id[s.parent].name == "decode" for s in got)
    # the outer decode and flush span both layers; each layer's flush
    # sits in ShvcDecoder's
    flushes = [s for s in sp if s.name == "flush"]
    assert len(flushes) == 3
    assert sum(s.parent is None for s in flushes) == 1
    # only the EL's pictures are returned (each BL picture is
    # reconstructed for the EL of its AU within the same call)
    assert sorted(s.pic for s in sp if s.name == "output") == el


def _annotations(prof, tmp_path, since_ns):
    """The trace's base and the starts (us on its clock) of its
    `user_annotation` ranges from `since_ns` (Unix ns) on, by name."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        tr = json.load(f)
    base = int(tr["baseTimeNanoseconds"])
    got = {}
    for e in tr["traceEvents"]:
        if e.get("cat") == "user_annotation" and \
                float(e["ts"]) >= (since_ns - base) / 1e3:
            # the exporter writes a range named "kernel" as "Kernel"
            name = "kernel" if e["name"] == "Kernel" else e["name"]
            got.setdefault(name, []).append(float(e["ts"]))
    return base, got


def _worst_start_gap(tmp_path, device, cuda_too, monkeypatch):
    """One traced two-layer decode, after a first pass of the same
    decoder in the same profiler session (a thread's first ranges in a
    session open late while the profiler sets the thread up): every span
    of the second pass against its range in the exported trace (every
    thread) by name and count. A range starts while its span opens it:
    between the span's clock read and the return of the
    `record_function` that opens the range (the clock read after it
    here), a window that a busy host
    can stretch by descheduling the thread. Returns the largest distance,
    in us, from a range's start (the base taken off) to that window."""
    opened = {}

    class timed(torch.autograd.profiler.record_function):
        def __enter__(self):
            out = super().__enter__()
            opened.setdefault(self.name, []).append(time.perf_counter_ns() +
                                                    trace._ANCHOR)
            return out

    monkeypatch.setattr(trace._profiler, "record_function", timed)
    dec = ShvcDecoder(device=device)
    units = aus(SHVC)
    mark = []

    def twice():
        decode(dec, units[:2])
        mark.append(time.perf_counter_ns() + trace._ANCHOR)
        decode(dec, units)

    _, prof = profiled(twice, all_threads=True, cuda_too=cuda_too)
    base, got = _annotations(prof, tmp_path, mark[0])
    sp = [s for s in trace.spans() if s.start_ns >= mark[0]]
    trace.clear()
    names = {s.name for s in sp}
    assert {"decode", "parse", "reconstruct", "upsample"} <= names
    assert set(got) == names
    worst = 0.0
    for name in names:
        starts = sorted(s.start_ns for s in sp if s.name == name)
        ends = sorted(t for t in opened[name] if t >= starts[0])
        theirs = sorted(got[name])
        assert len(starts) == len(ends) == len(theirs), name
        for t0, t1, ts in zip(starts, ends, theirs):
            t0, t1 = (t0 - base) / 1e3, (t1 - base) / 1e3
            worst = max(worst, t0 - ts, ts - t1)
    return worst


def test_spans_match_the_profiler_trace(tmp_path, monkeypatch):
    """Name, count and start (within 0.5 ms of the span's opening, the
    base taken off) of every span against its range in the exported
    trace."""
    gap = _worst_start_gap(tmp_path, "cpu", False, monkeypatch)
    assert gap <= 500.0, gap


def test_stage1_counters_add_up():
    dec = Decoder(device="cpu")
    profiled(lambda: decode(dec, aus(TWO_REFS)))
    sp = [s for s in trace.spans() if s.name == "mc_stage1"]
    caches = dec._engine()._stage1.values()
    hits = sum(c.hits for c in caches)
    misses = sum(c.misses for c in caches)
    assert sum(s.attrs["hits"] for s in sp) == hits > 0
    assert sum(s.attrs["misses"] for s in sp) == misses > 0


def test_hold_on_a_low_delay_stream_is_the_parse_ahead_depth_plus_one():
    dec = Decoder(device="cpu")
    units = aus(LD, copies=2)
    pics, _ = profiled(lambda: decode(dec, units, fetch=False))
    outs = [s for s in trace.spans() if s.name == "output"]
    assert len(outs) == len(pics) == len(units)
    held = [s.attrs["call"] - s.attrs["fed"] for s in outs
            if not s.attrs["flush"]]
    assert len(held) == len(units) - dec._parse_depth - 1
    assert set(held) == {dec._parse_depth + 1}
    assert [s.attrs["fed"] for s in outs] == list(range(1, len(units) + 1))


@pytest.mark.parametrize("on_mesh", [False, True])
def test_edge_params_spans_name_who_made_the_parameters(on_mesh):
    """One `edge_params` span a deblocked picture, inside its
    `reconstruct`, with kernel 1: the engine and the tile axis of a mesh
    both make the per-edge parameters on the device
    (`ops/filters.py::edge_params`)."""
    from openhevc_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh([["cpu"] * 2] * 2, ("frame", "tile")) if on_mesh \
        else None
    pics, _ = profiled(lambda: decode(Decoder(device="cpu", mesh=mesh),
                                      aus(FILTERED)))
    sp = trace.spans()
    by_id = {s.id: s for s in sp}
    got = [s for s in sp if s.name == "edge_params"]
    assert len(got) == len(pics) == 2
    for s in got:
        assert s.attrs == {"kernel": 1}
        assert by_id[s.parent].name == "reconstruct"


def test_sync_timers_keep_their_stages_with_the_tracer_on(monkeypatch):
    class Timed(pipeline.TorchEngine):
        def __init__(self, device):
            super().__init__(device, sync_timers=True)

    monkeypatch.setattr(pipeline, "TorchEngine", Timed)
    off = Decoder(device="cpu")
    decode(off, aus(LD))
    on = Decoder(device="cpu")
    profiled(lambda: decode(on, aus(LD)))
    keys = set(off._engine().stage_ms)
    assert keys == set(on._engine().stage_ms)
    assert keys == {s.name for s in trace.spans()} & STAGES
    assert all(v > 0 for v in on._engine().stage_ms.values())


def test_synchronous_parses_carry_their_route():
    """A two-slice picture parses in one native call on the decoding
    thread; native_parse=False sends every slice to the Python parser."""
    main = threading.get_native_id()
    for kw, path, route in (({}, TWO_SLICES, "native"),
                            ({"native_parse": False}, LD, "python")):
        trace.clear()
        dec = Decoder(device="cpu", **kw)
        pics, _ = profiled(lambda: decode(dec, aus(path), fetch=False))
        parses = [s for s in trace.spans() if s.name == "parse"]
        assert len(parses) == len(pics) > 0
        assert all(s.tid == main and s.attrs["route"] == route
                   for s in parses)
        assert not any(s.name == "parse_wait" for s in trace.spans())


def test_a_wave_is_one_reconstruct_span_with_its_pictures():
    from openhevc_tpu_torch.parallel import DeviceMesh
    dec = Decoder(device="cpu", mesh=DeviceMesh(["cpu"] * 2, ("frame",)))
    pics, _ = profiled(lambda: decode(dec, aus(LD), fetch=False))
    rec = [s for s in trace.spans() if s.name == "reconstruct"]
    assert sum(s.attrs.get("pictures", 1) for s in rec) == len(pics)


def test_gc_is_a_span_only_while_recording():
    gc.collect()
    assert trace.spans() == []
    profiled(lambda: gc.collect())
    got = [s for s in trace.spans() if s.name == "gc"]
    assert got and got[-1].attrs["generation"] == 2


def test_the_cap_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)

    def twelve():
        for i in range(12):
            with trace.span("decode"):
                pass

    gc.disable()
    try:
        profiled(twelve)
    finally:
        gc.enable()
    assert len(trace.spans()) == 5 and trace.dropped() == 7
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_threads_share_the_buffer_without_losing_a_span(monkeypatch):
    """Eight threads open spans at once, with a short switch interval:
    every span is kept or counted as dropped, ids unique."""
    n, each = 8, 200
    monkeypatch.setattr(trace, "CAP", n * each // 2)

    def work():
        for _ in range(each):
            with trace.span("decode"):
                pass

    def run():
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    gc.disable()
    try:
        profiled(run)
    finally:
        gc.enable()
        sys.setswitchinterval(old)
    sp = trace.spans()
    assert len(sp) == trace.CAP and trace.dropped() == n * each - trace.CAP
    assert len({s.id for s in sp}) == len(sp)
    assert all(s.parent is None and s.end_ns >= s.start_ns for s in sp)


def test_spans_can_be_read_while_collections_record_spans():
    """spans() under a profiler while every allocation may start a
    collection, and so a `gc` span: the read does not wait on itself."""
    done = []

    def read():
        def many():
            for _ in range(300):
                with trace.span("decode"):
                    trace.spans()
        profiled(many)
        done.append(True)

    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(timeout=30)
    finally:
        gc.set_threshold(*old)
    if t.is_alive():
        trace._lock.release()       # held by the stuck reader: let go
    assert done and not t.is_alive()
    sp = trace.spans()
    assert sum(s.name == "decode" for s in sp) == 300
    assert any(s.name == "gc" for s in sp)


@pytest.mark.gpu
def test_the_shared_clock_holds_on_the_card(cuda, tmp_path,  # noqa: F811
                                            monkeypatch):
    """On the card, a traced two-layer decode: every span's start within
    0.1 ms of its range in the exported trace."""
    decode(ShvcDecoder(), aus(SHVC)[:2])        # kernels built and loaded
    gap = _worst_start_gap(tmp_path, "cuda", True, monkeypatch)
    assert gap <= 100.0, gap
