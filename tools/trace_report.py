#!/usr/bin/env python3
"""Where the card idles and where a live stream stalls, read from the
port's own spans (openhevc_tpu_torch/utils/trace.py).

    python3 tools/trace_report.py --workload ra1080_batch --seed 7
    python3 tools/trace_report.py --cost --workload ra1080_batch

--workload NAME [--seed N]: one traced run of the benchmark's cell
(benchmark/run.py --trace 1, on the card, for BENCHMARK.json's
`run_seconds`), then the
device's idle time in the window split by the decoding thread's
innermost program span (its self time; "no span" where none is open:
the benchmark's own loop and, in a live cell, the wait for arrivals),
each span's host time a picture, and the ten longest decode() calls with
their time split the same way.

--cost: ns a span site takes with no profiler and under one (a loop of
`with trace.span(...)`, against the same loop over a shared no-op
context), the spans a picture records in a traced decode of the cell's
first `AUS` access units, and the profiler's `baseTimeNanoseconds` in two
profiles of nothing.

The last stdout line is one JSON object with every number; the card's
name and power limit ride in it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

AUS = 16                        # access units of the traced decode of --cost


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def idle_by_span(w, r, base) -> dict:
    """ms of device idle time under each innermost span of the decoding
    thread (the thread of the `decode` spans), with "no span" the rest of
    the window's idle time."""
    from hevcbench.spans import merged, uncovered
    busy = merged(r.device_ops)
    ends = [e for _s, e in busy]
    main = {s.tid for s in w.named(("decode", "flush"))}
    out = {}
    for s in w.spans:
        if s.tid not in main:
            continue
        idle = sum(uncovered((a - base) / 1e3, (b - base) / 1e3, busy, ends)
                   for a, b in w.self_parts(s))
        out[s.name] = out.get(s.name, 0.0) + idle / 1e3
    total = (r.window_s - (r.busy_s or 0.0)) * 1e3
    out["no span"] = total - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def longest_calls(w, n=10) -> list:
    """The n longest decode() calls: ms, and ms under each child span on
    the decoding thread (nested spans counted in their outermost child)
    with "self" the call's own."""
    calls = sorted(w.named(("decode",)), key=lambda s: s.start_ns - s.end_ns)
    gcs = w.named(("gc",))
    out = []
    for c in calls[:n]:
        parts = {"self": sum(b - a for a, b in w.self_parts(c)) / 1e6}
        for k in w.children.get(c.id, ()):
            if k.tid == c.tid:
                parts[k.name] = parts.get(k.name, 0.0) + \
                    (k.end_ns - k.start_ns) / 1e6
        out.append({"ms": (c.end_ns - c.start_ns) / 1e6,
                    "parts": dict(sorted(parts.items(),
                                         key=lambda kv: -kv[1])),
                    "gc_in_it_ms": sum(
                        (g.end_ns - g.start_ns) / 1e6 for g in gcs
                        if g.tid == c.tid and c.start_ns <= g.start_ns and
                        g.end_ns <= c.end_ns)})
    return out


def report(args) -> dict:
    from hevcbench import cell, manifest, spans
    seconds = manifest.load(ROOT)["run_seconds"]
    res = cell.run(ROOT, args.workload, args.seed, seconds, True,
                   device="cuda")
    if spans._last is None or spans._last[1] is None:
        raise SystemExit("the window recorded no program span")
    r, w = spans._last
    base = spans.base_ns()
    out = {"correct": res["correct"], "metrics": {
        k: v["value"] for k, v in res["metrics"].items()},
        "window_s": r.window_s, "busy_s": r.busy_s,
        "pictures": w.pictures, "spans": len(w.spans)}
    per = {}
    for s in w.spans:
        per[s.name] = per.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    out["span_ms_a_picture"] = {k: v / max(w.pictures, 1) for k, v in
                                sorted(per.items(), key=lambda kv: -kv[1])}
    if r.busy_s is not None:
        out["idle_ms_by_span"] = idle_by_span(w, r, base)
    out["longest_decode_calls"] = longest_calls(w)
    gcs = sorted(((s.end_ns - s.start_ns) / 1e6, s.attrs["generation"],
                  s.tid in {d.tid for d in w.named(("decode",))})
                 for s in w.named(("gc",)))
    calls = w.named(("decode", "flush"))
    out["gc"] = {"count": len(gcs), "ms": sum(g[0] for g in gcs),
                 "longest (ms, generation, decoding thread)": gcs[-5:],
                 "ms outside decode() and flush()": sum(
                     (g.end_ns - g.start_ns) / 1e6 for g in w.named(("gc",))
                     if not any(c.tid == g.tid and c.start_ns <= g.start_ns
                                <= c.end_ns for c in calls))}
    return out


def site_ns(n: int) -> tuple[float, float]:
    """(ns an iteration of `with trace.span("decode"): pass`, ns an
    iteration of the same loop over a shared no-op context)."""
    from openhevc_tpu_torch.utils import trace
    null = contextlib.nullcontext()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with trace.span("decode"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        with null:
            pass
    t2 = time.perf_counter_ns()
    return (t1 - t0) / n, (t2 - t1) / n


def cost(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hevcbench import manifest, spans
    from hevcbench.drive import decoder_class
    from hevcbench.streams import Stream
    from openhevc_tpu_torch.utils import trace
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"base_ns": [spans.base_ns()]}
    site_ns(10_000)
    off, null = min(site_ns(1_000_000) for _ in range(3))
    with profile(activities=acts):
        site_ns(1_000)
        on, _ = min(site_ns(20_000) for _ in range(3))
    trace.clear()
    out.update(off_ns_a_site=off, on_ns_a_site=on, null_with_ns=null)
    man = manifest.load(ROOT)
    c = manifest.cell(man, args.workload)
    cfg = manifest.config(ROOT, man, c["config"])
    st = Stream(ROOT, cfg["streams"][0])
    two = cfg["entry"] == "shvc"
    cls = decoder_class(two)
    warm = cls(device="cuda")
    for au in st.aus[:4]:
        warm.decode(au)
    warm.flush()
    torch.cuda.synchronize()
    dec = cls(device="cuda")
    with profile(activities=acts):
        for au in st.aus[:AUS]:
            dec.decode(au)
        dec.flush()
        torch.cuda.synchronize()
    w = spans.Spans(trace.spans())
    trace.clear()
    out["pictures"] = w.pictures
    out["spans_a_picture"] = len(w.spans) / max(w.pictures, 1)
    names = {}
    for s in w.spans:
        names[s.name] = names.get(s.name, 0) + 1
    out["spans_by_name"] = names
    out["on_us_a_picture"] = out["spans_a_picture"] * (on - null) / 1e3
    out["base_ns"].append(spans.base_ns())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_report: needs a CUDA device", file=sys.stderr)
        return 2
    out = cost(args) if args.cost else report(args)
    out["workload"] = args.workload
    out["device"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
