"""The program's own spans in the traced window, for the per-layer
readers that read them (`benchmark/metrics/<name>.py`).

The program records its spans (openhevc_tpu_torch/utils/trace.py) while
a torch.profiler session records, and only the window is profiled, so
the spans it holds when the first reader asks are the window's. They
are taken then, once a run, and the program's buffer emptied. A program
without the tracer gives none: every reader then returns None.

A span's times are Unix-epoch ns; the profiler's trace counts µs from
its `baseTimeNanoseconds`, which one profile of nothing after the
window gives (`base_ns`). "A picture" is a `reconstruct` span of the
display layer (the highest layer that reconstructs in the window; a wave
counts its `pictures`), with every layer's time added.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

_last = None            # (the Readings asked about, its Spans or None)


def window(r):
    """The `Spans` of the traced window that `r` (a Readings) reads, or
    None where the program recorded none."""
    global _last
    if _last is not None and _last[0] is r:
        return _last[1]
    try:
        from openhevc_tpu_torch.utils import trace
    except ImportError:
        got = None
    else:
        got = trace.spans()
        trace.clear()
        got = Spans(got) if got else None
    _last = (r, got)
    return got


def base_ns() -> int | None:
    """`baseTimeNanoseconds` of a profile of nothing (CPU, and the card's
    activity where there is a card), exported through a temporary file;
    None where the trace has no such key."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        pass
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            base = json.load(f).get("baseTimeNanoseconds")
    try:
        from openhevc_tpu_torch.utils import trace
        trace.clear()       # what the empty profile recorded (a collection)
    except ImportError:
        pass
    return None if base is None else int(base)


def merged(intervals):
    """The union of (start, end, ...) intervals as sorted, disjoint
    (start, end) pairs."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def uncovered(s, e, union, ends) -> float:
    """Length of (s, e) outside the disjoint sorted intervals `union`
    (`ends`: their ends, in order)."""
    covered = 0.0
    for i in range(bisect.bisect_right(ends, s), len(union)):
        us, ue = union[i]
        if us >= e:
            break
        covered += min(e, ue) - max(s, us)
    return (e - s) - covered


class Spans:
    """The window's spans (objects with name, id, parent, pic, attrs,
    tid, start_ns, end_ns), with the sums the readers take."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.children = {}
        for s in self.spans:
            if s.parent is not None:
                self.children.setdefault(s.parent, []).append(s)
        rec = [s for s in self.spans
               if s.name == "reconstruct" and s.pic is not None]
        top = max((s.pic[0] for s in rec), default=None)
        self.pictures = sum(s.attrs.get("pictures", 1) for s in rec
                            if s.pic[0] == top)

    def named(self, names):
        return [s for s in self.spans if s.name in names]

    def per_picture(self, ms) -> float | None:
        return ms / self.pictures if self.pictures else None

    def ms(self, names) -> float | None:
        """ms of the spans named `names`, a picture; None without one."""
        got = self.named(names)
        if not got:
            return None
        return self.per_picture(sum(s.end_ns - s.start_ns
                                    for s in got) / 1e6)

    def self_parts(self, s):
        """(start, end) ns of span s with its children on its own thread
        taken out."""
        kids = merged((c.start_ns, c.end_ns)
                      for c in self.children.get(s.id, ())
                      if c.tid == s.tid)
        parts, at = [], s.start_ns
        for ks, ke in kids:
            if ks > at:
                parts.append((at, min(ks, s.end_ns)))
            at = max(at, ke)
        if at < s.end_ns:
            parts.append((at, s.end_ns))
        return parts

    def self_ms(self, names) -> float | None:
        """Self time of the spans named `names` (their length less their
        children's on the same thread), ms a picture."""
        got = self.named(names)
        if not got:
            return None
        return self.per_picture(sum(e - s for sp in got
                                    for s, e in self.self_parts(sp)) / 1e6)

    def counter(self, name, key) -> int:
        return sum(s.attrs.get(key, 0) for s in self.named((name,)))

    def hold(self) -> float | None:
        """Mean decode() calls from the call that fed a display-layer
        picture to the call whose `output` returned it; pictures that
        flush() returned are left out."""
        outs = [s for s in self.named(("output",)) if s.pic is not None and
                not s.attrs.get("flush") and s.attrs.get("fed", -1) >= 0]
        top = max((s.pic[0] for s in outs), default=None)
        holds = [s.attrs["call"] - s.attrs["fed"] for s in outs
                 if s.pic[0] == top]
        return sum(holds) / len(holds) if holds else None

    def idle_share(self, name, device_ops, window_us, base) -> float | None:
        """Share of the window, in %, in which no device op runs
        (`device_ops`: (start, end, name) µs on the trace's clock) while
        a span named `name` is its thread's innermost (its self time), the
        spans moved onto the trace's clock by `base` ns. None without
        such a span or a window."""
        got = self.named((name,))
        if not got or not window_us:
            return None
        busy = merged(device_ops)
        ends = [ue for _us, ue in busy]
        idle = sum(uncovered((s - base) / 1e3, (e - base) / 1e3, busy, ends)
                   for sp in got for s, e in self.self_parts(sp))
        return 100.0 * idle / window_us
