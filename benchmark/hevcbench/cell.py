"""One run of one cell: set-up, the measured window, the comparison, and
with `trace` the per-layer readings; returns the result line."""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

from . import check, manifest
from .drive import (Memory, Sampler, Tamper, closed_loop, decoder_class,
                    open_loop, sync)
from .peaks import hbm_bytes_per_s
from .readings import Readings, parse_alone, timed_stages
from .streams import Stream, check_frozen
from .trace import labelled_engine, profiled
from .traffic import check_mix, nearest_rank, session_aus
from .work import intra_bytes

MIB = 2 ** 20
SAMPLE = 256        # pictures of each layer whose md5 a window compares


def log(*a):
    print("[benchmark]", *a, file=sys.stderr, flush=True)


def build(device) -> None:
    """Build (first run in a checkout) or find the program's kernels and
    parse core, in its own build directory inside the checkout."""
    from openhevc_tpu_torch.bitstream.native import ensure_built
    ensure_built()
    if device == "cuda":
        from openhevc_tpu_torch import kernels
        for name in kernels.SOURCES:
            kernels.load(name)


def device_info(device, chips, peak) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, streams and
    metrics, found by name under `root`."""

    def __init__(self, root: str, workload: str):
        man = manifest.load(root)
        self.spec = manifest.cell(man, workload)
        self.config = manifest.config(root, man, self.spec["config"])
        self.mix = manifest.traffic(root, self.spec["traffic"])
        check_mix(self.mix)
        self.end_to_end = {m["name"]: m["unit"] for m in man["end_to_end"]
                           if manifest.reports(m, workload)}
        self.per_layer = {m["name"]: (manifest.reader(root, m["name"]),
                                      m["unit"])
                          for m in man["per_layer"]
                          if manifest.reports(m, workload)}
        entries = self.config["streams"]
        check_frozen(root, [e[k] for e in entries
                            for k in ("file", "md5", "bl_md5") if e.get(k)])
        self.streams = [Stream(root, e) for e in entries]
        self.two_layers = self.config["entry"] == "shvc"


def warm_up(c: Cell, device, engine=None):
    """One session of the cell's own traffic on each stream of the pool
    (one copy of a repeated stream), fed access unit by access unit, so
    that every kernel, plan and cache the window uses is built. Returns
    for each stream the (shown layer's, base layer's or None) POCs of a
    copy's pictures in decode order, which the comparison needs, and the
    last picture of each layer, which sizes the samplers."""
    mix, pocs, last = c.mix, [], {}
    for st in c.streams:
        seen = {0: [], 1: []}

        def on_bump(layer, pic):
            seen[layer].append(pic.poc)
            last[layer] = pic

        warm = decoder_class(c.two_layers, on_bump=on_bump,
                             engine=engine)(device=device)
        for au in session_aus(st.aus, mix["session"]) + [None]:
            for p in warm.flush() if au is None else warm.decode(au):
                if mix["fetch"]:
                    p.planes.get()
        del warm
        pocs.append((seen[1], seen[0]) if c.two_layers else (seen[0], None))
    sync(device)
    gc.collect()
    return pocs, last


def readings(c: Cell, w, busy, intra, kind, device) -> Readings:
    """What the per-layer readers read: the traced window's device time
    and intra work (`intra`: (time, bytes) of each reconstruction
    dispatched, the window's up to its end), then one synchronised
    decode of a session and the parse alone (after the window, outside
    it)."""
    r = Readings(window_s=busy["window_us"] / 1e6, pictures=w.pictures,
                 hbm_bytes_per_s=hbm_bytes_per_s(kind))
    if busy["busy_us"] is not None:
        r.busy_s = busy["busy_us"] / 1e6
        r.device_ops = busy["ops"]
    r.intra_bytes = sum(b for t, b in intra if t <= w.t1) or None
    r.stage_ms, r.fetch_ms = timed_stages(c.streams, c.mix, c.two_layers,
                                          device)
    if not c.two_layers:
        r.parse_ms = parse_alone(c.streams, c.mix, device)
    return r


def run(root, workload, seed, seconds, trace, device="cuda", fault=None,
        t_start=None) -> dict:
    """Steps of one run; returns the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = Cell(root, workload)
    mix, two = c.mix, c.two_layers
    build(device)
    mem = Memory(device)
    open_ = mix["loop"] == "open"
    engine = labelled_engine() if trace else None
    if trace:
        from torch.profiler import record_function

    pocs, last = warm_up(c, device, engine)
    # the samplers' buffers are made, and copied into once, in set-up
    el = Sampler(SAMPLE, seed)
    bl = Sampler(SAMPLE, seed + 1) if two else None
    for layer, s in ((1 if two else 0, None if open_ else el), (0, bl)):
        if s is not None:
            s.alloc(last[layer], device)
    del last
    # a traced run counts the intra work of each picture it reconstructs
    intra = []
    cls = decoder_class(two, engine=engine, on_bump=(
        lambda layer, pic: bl.add(pic) if layer == 0 else None)
        if two else None, on_recon=(lambda layer, fs: intra.append(
            (time.perf_counter(), intra_bytes(fs)))) if trace else None)
    setup_s = time.perf_counter() - t_start

    tamper = Tamper(fault)
    span = record_function if trace else contextlib.nullcontext
    if open_:
        def window():
            return open_loop(c.streams[0], mix, seed, seconds, device, cls,
                             mem, tamper, span)
    else:
        def window():
            return closed_loop(c.streams, mix, seed, seconds, device, cls,
                               mem, tamper, el, bl, span)
    busy = None
    if trace:
        w, busy = profiled(window, device)
    else:
        w = window()
    peak = mem.peak()

    pictures = w.pictures
    if open_:
        counts, attempted, lat = check.open_(w, c.streams[0], pocs[0], bl)
    else:
        counts, attempted = check.closed(w, c.streams, el, bl, pocs)
    el = bl = None
    failed = sum(counts.values())
    gc.collect()
    ok = check.passed(counts)
    values = {"setup_s": setup_s, "peak_mem_mib": mem.session_peak / MIB}
    if open_:
        ms = sorted(x * 1e3 for x in lat)
        p95 = nearest_rank(ms, 0.95)
        # a p95 that falls on a picture that never came (or came wrong)
        # is no number: the run is not correct then
        values["picture_latency_p95_ms"] = p95 if math.isfinite(p95) \
            else None
        log(f"latency over {len(ms)} pictures due: median "
            f"{nearest_rank(ms, 0.5)} ms, p95 {values['picture_latency_p95_ms']}"
            f" ms, max {ms[-1]} ms; feed lag first {w.lag[0] * 1e3} ms, "
            f"last {w.lag[-1] * 1e3} ms, max {max(w.lag) * 1e3} ms")
    else:
        values["fps"] = pictures / w.seconds
        log(f"{len(w.sessions)} sessions, {pictures} pictures in "
            f"{w.seconds} s; pictures a second in each fifth of the "
            f"window: {w.rates(5)}")

    dev = device_info(device, c.spec["chips"], peak)
    out = {"correct": ok, "attempted": attempted, "failed": failed}
    if not trace:
        missing = [m for m in c.end_to_end if m not in values]
        if missing:
            raise RuntimeError(f"no reading for {missing}")
        out["metrics"] = {m: {"value": values[m], "unit": unit}
                          for m, unit in c.end_to_end.items()}
    else:
        r = readings(c, w, busy, intra, dev["kind"], device)
        out["metrics"] = {}
        for name, (read, unit) in c.per_layer.items():
            v = read(r)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": unit}
        dev["busy_s"] = r.busy_s
        dev["window_s"] = r.window_s
        out["breakdown"] = {
            "device_ops": [[n, t / 1e6] for n, t in busy["top_ops"]],
            "idle_gaps": [[n, t / 1e6] for n, t in busy["idle_gaps"]]}
    out["device"] = dev
    out["limits"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in counts.items()}
    return out
