"""The device's busy time from a torch.profiler trace, with the device
operations that took most of it and the longest idle gaps labelled by
what the host was doing (copied from the program's bench script, so
that the yardstick stays where the program cannot move it)."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

WINDOW = "benchmark.window"         # the traced window's host span
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120                    # device op names (templates) are long


def device_busy(device_ops, host_ops, window, top=10, gaps=10):
    """Busy time of the device over `window` (start, end), from its
    (start, end, name) intervals `device_ops` (kernels, memcpys,
    memsets; overlapping and nested intervals count once: their union),
    with the `top` device operations by total time (clipped to the
    window) and the `gaps` longest idle gaps, each labelled with the
    host operation of `host_ops` (start, end, name) that overlaps it
    most (the innermost on a tie), or "no host op". Times in us. With no
    device interval in the window `busy_us` is None: not measured."""
    t0, t1 = window
    ops = [(max(s, t0), min(e, t1), n) for s, e, n in device_ops
           if e > t0 and s < t1]
    out = {"window_us": t1 - t0, "busy_us": None, "ops": ops,
           "top_ops": [], "idle_gaps": []}
    if not ops or t1 <= t0:
        return out
    idle, last = [], t0
    for s, e, _ in sorted(ops):
        if s > last:
            idle.append((last, s))
        last = max(last, e)
    if last < t1:
        idle.append((last, t1))
    totals = {}
    for s, e, n in ops:
        totals[n] = totals.get(n, 0.0) + e - s
    idle.sort(key=lambda g: g[0] - g[1])        # longest first, stable

    host = sorted(host_ops, key=lambda h: (h[0], -h[1]))

    def during(s, e):
        best, name = 0.0, "no host op"
        for hs, he, n in host:
            over = min(e, he) - max(s, hs)
            if over > 0 and over >= best:
                best, name = over, n
        return name

    out["busy_us"] = (t1 - t0) - sum(e - s for s, e in idle)
    out["top_ops"] = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    out["idle_gaps"] = [(during(s, e), e - s) for s, e in idle[:gaps]]
    return out


def trace_intervals(trace: dict):
    """(device_ops, host_ops, window) of a chrome trace exported by
    torch.profiler: device kernels, memcpys and memsets; the host
    operations on the thread of the WINDOW span; that span's (start,
    end), or nothing and an empty window where the trace lacks the span.
    Times in us."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    span = next((e for e in evs if e.get("name") == WINDOW and
                 e.get("cat") == "user_annotation"), None)
    if span is None:
        return [], [], (0.0, 0.0)
    window = (float(span["ts"]), float(span["ts"]) + float(span["dur"]))

    def iv(e):
        s = float(e["ts"])
        return s, s + float(e.get("dur", 0.0)), e["name"][:NAME_CHARS]

    dev = [iv(e) for e in evs if e.get("cat") in DEVICE_CATS]
    host = [iv(e) for e in evs if e.get("cat") in HOST_CATS and
            e.get("tid") == span.get("tid") and e is not span]
    return dev, host, window


def labelled_engine():
    """A `TorchEngine` subclass whose stages are also named spans of a
    torch.profiler trace, so that idle gaps are labelled by them."""
    from torch.profiler import record_function
    from openhevc_tpu_torch.models.pipeline import TorchEngine

    class LabelledEngine(TorchEngine):
        @contextlib.contextmanager
        def _stage(self, name):
            with record_function(name), super()._stage(name):
                yield

    return LabelledEngine


def profiled(fn, device):
    """Run fn() under torch.profiler (CPU and, on a card, CUDA
    activity) inside the WINDOW span; returns (fn's result, the
    `device_busy` of its trace). The trace goes through a temporary
    file under TMPDIR, deleted before this returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    del prof
    return result, device_busy(*trace_intervals(trace))
