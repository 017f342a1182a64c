"""Spans of the decoder's host work, recorded while a torch.profiler
session records in the process, and at no other time.

    with span("parse", pic=(layer, index), route="native"):
        ...

A span records its name, its start and end in Unix-epoch ns (a
monotonic clock plus one anchor taken at import: the clock a profiler
trace counts before it subtracts its `baseTimeNanoseconds`), its thread
(the OS thread id, as the trace gives it), its parent (the span that
encloses it on the same thread, or the one given, as for work handed to
another thread), a picture id (layer, decode-order index; taken from the
parent where none is given) and attributes. While recording, each span
is also a `record_function` range, entered right after the span's clock
read, so it appears in the profiler's own trace on the device's clock
(threads other than the one that started the profiler appear there only
under its `profile_all_threads`).

With no profiler a span site costs one flag check: no `record_function`,
no clock read, no span made. Recorded spans go into one buffer of at
most CAP spans; `spans()` returns them, `dropped()` counts those the cap
turned away, `clear()` empties both. There is no exporter: the
profiler's trace holds the ranges.

Span names and where they open: `decode`, `flush` (Decoder,
ShvcDecoder); `parse` (the parse-ahead worker's job and the synchronous
parses; attr `route`, and on a native parse `substreams`, `threads`,
`fallback`, `wave_wait_us`: the entry points handed over, the workers,
whether the serial re-parse gave the result, the workers' summed wait
on the WPP row above), `parse_wait` (the wait on the parse-ahead queue),
`reconstruct` (one picture, or one wave with attr `pictures`); the
engine's stages (`TorchEngine._stage`); `upsample`, `il_motion` (the
inter-layer reference); `fetch` (`TorchPlanes.get`, first call);
`output` (an instant per picture returned; attrs `call`, `fed`, `flush`);
`gc` (a collection; attr `generation`).
"""
from __future__ import annotations

import gc
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

CAP = 1 << 18                   # spans kept before new ones are dropped

# Unix-epoch ns = monotonic ns + _ANCHOR
_ANCHOR = time.time_ns() - time.perf_counter_ns()
_ids = itertools.count(1)
_lock = threading.Lock()
_tls = threading.local()
_spans: list = []
_dropped = 0


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _keep(sp) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAP:
            _spans.append(sp)
        else:
            _dropped += 1


class Span:
    """One recorded span (made only while recording)."""

    __slots__ = ("name", "id", "parent", "pic", "attrs", "tid",
                 "start_ns", "end_ns", "_rf")

    def __init__(self, name, pic, parent, attrs):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.pic = pic
        self.attrs = attrs
        self.tid = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self._rf = None

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            if self.parent is None:
                self.parent = top.id
            if self.pic is None:
                self.pic = top.pic
        self.start_ns = time.perf_counter_ns() + _ANCHOR
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + _ANCHOR
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rf, self._rf = self._rf, None
        rf.__exit__(None, None, None)
        _keep(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, pic={self.pic}, id={self.id}, "
                f"parent={self.parent}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.attrs})")


class _Off:
    """The span of a site while nothing records: enters as None."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, pic=None, parent=None, **attrs):
    """A context manager: a recorded `Span` while a profiler records,
    else a shared no-op. pic: (layer, decode-order index); parent: the
    id of the enclosing span where it is not the innermost open span of
    this thread (work handed to another thread)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, pic, parent, attrs)


def current():
    """The id of this thread's innermost open span, or None."""
    if not _profiler._is_profiler_enabled:
        return None
    stack = _stack()
    return stack[-1].id if stack else None


def annotate(pic=None, **attrs) -> None:
    """Set the picture id and attributes of this thread's innermost open
    span (a counter read at its end; the picture of a stage whose
    caller knows it)."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        top = stack[-1]
        if pic is not None:
            top.pic = pic
        top.attrs.update(attrs)


def outputs(pics, call: int, flush: bool) -> None:
    """An `output` instant (a span of no length) for each picture a
    decode() (flush False) or flush() call returns: its picture id, the
    call's index and the index of the call that fed its access unit
    (`fed`)."""
    if not _profiler._is_profiler_enabled:
        return
    for p in pics:
        with Span("output", p.pid, None,
                  {"call": call, "fed": p.fed, "flush": flush}):
            pass


def spans() -> list:
    """The recorded spans, in the order they ended. The copy is made
    outside the lock: a collection it starts may keep a `gc` span, which
    takes the lock."""
    return _spans[:]


def dropped() -> int:
    """Spans turned away since the last clear() because the buffer held
    CAP."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


_gc_open: list = []             # the collection in progress (one at a time)


def _on_gc(phase, info):
    if phase == "start":
        if not _profiler._is_profiler_enabled:
            return
        sp = Span("gc", None, None, {"generation": info["generation"]})
        sp.__enter__()
        _gc_open.append(sp)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)
