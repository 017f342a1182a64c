#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (openhevc_tpu_torch) on one GPU:
the port's counterpart of bench.py.

    python3 bench_torch.py               # every stream, one process each
    python3 bench_torch.py --only NAME   # one stream, in this process

The seven bench streams of bench.py (`bench_streams/r4a_<name>.265`,
each with the reference decoder's per-frame md5 sidecar `.md5`), decoded
whole through the port's public entry points: `Decoder(device="cuda")`,
and `ShvcDecoder(device="cuda")` for shvc_2layer, where a frame is an
enhancement-layer picture. For one stream, in one process:

1. warm-up: the first 2 pictures (4 access units of shvc) decoded once;
2. REPS timed passes of each of two modes, in turns (decode-only,
   delivery, decode-only, ...):
   - decode-only: outputs left on the card; the clock runs around
     decode + flush + `torch.cuda.synchronize()`;
   - delivery: every picture fetched to the host (`planes.get()`)
     inside the clock.
   Every pass builds a fresh decoder, so the stage-1 MC cache and the
   DPB start cold in every pass, as they do for a user who opens a
   stream. Each pass's pictures are hashed after its clock stops
   (cropped Y, U, V as uint8, or uint16 above 8 bits, in output order,
   as bench.py hashes) and compared with the sidecar. `fps` and
   `fps_decode_only` are the best pass (bench.py's rule), beside the
   median and every pass's seconds;
3. diagnostics, from three decodes of their own after the timed
   passes, each md5-checked, none timed for fps: the stage breakdown (the
   engine's `sync_timers`, every stage synchronised, plus the host parse
   timed alone; null for two layers, where the enhancement layer's
   parse needs the base layer's pictures), the launches of the three
   kernel entries (counters at 0 just before), the bytes a frame
   copied host to device (counted by `TorchEngine`) and device to host
   (the fetched planes) and the peak device memory
   (`torch.cuda.max_memory_allocated()`), all four from one decode; and,
   from a `torch.profiler` trace of a decode-only pass, the device's
   busy share (the union of its kernel, memcpy and memset intervals over
   the window from the decode's start to the end of its final
   synchronize), the five device operations with the most time and the
   three longest idle gaps, each labelled with the host operations
   running when it began. The profiler slows the host, so beside that
   share `busy_share_timed` divides the same device time by the median
   timed decode-only pass.

Without --only the kernels and the native parse core are built once in
this process, then each stream runs in a subprocess (`--only NAME`)
under OPENHEVC_BENCH_CONFIG_TIMEOUT seconds (1500 by default); a
timeout or a crash is recorded as {"error": ...} and the other streams
go on.

Per-stream lines go to stderr, prefixed [bench_torch]. The last line on
stdout is one JSON object: the headline `metric` (i_main's delivery fps,
`_MISMATCH` appended when any pass of i_main differs from its sidecar),
`value`, `unit`, `value_decode_only`, `configs` (per stream), `device`,
`load_avg`, `cpu_count`, and `ref_fps` / `vs_baseline` null (the C
reference decoder is not part of the repository). Exit 0 when every
stream is md5-exact in every pass, 1 otherwise, 2 without a CUDA device:
the benchmark never runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM_DIR = os.path.join(ROOT, "bench_streams")
VER = "r4a"
# bench.py's CONFIGS (name, kind) with each stream's frame count as its
# md5 sidecar gives it (a frame of shvc is an enhancement-layer picture)
CONFIGS = [
    ("i_main_832x480", "single", 32),
    ("ra_main_1080p", "single", 17),
    ("main10_4k", "single", 3),
    ("rext_444_832x480", "single", 6),
    ("shvc_2layer_832x480", "shvc", 12),
    ("ra_tiles_1080p", "single", 9),
    ("ra_main10_4k", "single", 9),
]
HEADLINE = "i_main_832x480"
REPS = 3
TIMEOUT_S = 1500
KERNEL_ENTRIES = ("intra_fused", "intra_fused_banded", "intra_fused_serial")
WINDOW = "bench_torch.decode"       # the profiled pass's host span
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120                    # device op names in the JSON (templates)
NO_REF = ("not measured: the C reference decoder (`tools/refdec.py`) is "
          "built from openHEVC sources that are not in the repository")


def log(*a):
    print("[bench_torch]", *a, file=sys.stderr, flush=True)


# ---- streams, decoders, hashes (shared with chip_smoke.py) ------------------

def stream_path(name, streams_dir=STREAM_DIR):
    return os.path.join(streams_dir, f"{VER}_{name}.265")


def load_stream(name, streams_dir=STREAM_DIR):
    """(bytes, per-frame md5 list) of bench stream `name`; a missing
    stream or sidecar raises FileNotFoundError naming the file."""
    path = stream_path(name, streams_dir)
    for p in (path, path + ".md5"):
        if not os.path.exists(p):
            raise FileNotFoundError(f"missing bench stream file {p}")
    with open(path, "rb") as f:
        data = f.read()
    with open(path + ".md5") as f:
        return data, f.read().split()


def first_frames(data: bytes, k: int) -> bytes:
    """The stream cut after its k-th VCL NAL (one slice per picture)."""
    from openhevc_tpu_torch.decoder import split_nals
    out, vcl = [], 0
    for nal in split_nals(data):
        if ((nal[0] >> 1) & 0x3F) <= 31:
            if vcl == k:
                break
            vcl += 1
        out.append(b"\x00\x00\x00\x01" + nal)
    return b"".join(out)


def hash_pics(pics):
    """Per-frame md5 of the cropped Y, U, V planes, as bench.py hashes:
    uint8 samples, or uint16 when the bit depth is above 8."""
    import numpy as np
    hs = []
    for p in pics:
        dt = np.uint16 if p.sps.bit_depth > 8 else np.uint8
        h = hashlib.md5()
        for plane in p.cropped():
            h.update(np.ascontiguousarray(np.asarray(plane, dt)).tobytes())
        hs.append(h.hexdigest())
    return hs


def n_jobs(fs) -> int:
    """Intra jobs of a parsed picture, from either parser."""
    if fs.native_raw is not None:
        return len(fs.native_raw["ij_meta"])
    return len(fs.intra_jobs)


def sync(device="cuda"):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def parse_only(data: bytes, native_parse=True, device="cuda"):
    """Parsed FrameSymbols of every picture (no reconstruction)."""
    from openhevc_tpu_torch.decoder import Decoder

    class _Parse(Decoder):
        def _reconstruct(self, fs, refs):
            self.parsed.append(fs)

    d = _Parse(device=device, native_parse=native_parse)
    d.parsed = []
    d.decode(data)
    d.flush()
    return d.parsed


def build_all():
    """Build every kernel library and the parse core concurrently;
    returns {name: nvcc report}."""
    from openhevc_tpu_torch import kernels
    from openhevc_tpu_torch.bitstream.native import ensure_built
    with ThreadPoolExecutor(len(kernels.SOURCES) + 1) as ex:
        futs = {n: ex.submit(kernels.build, n) for n in kernels.SOURCES}
        parser = ex.submit(ensure_built)
        reports = {n: f.result() for n, f in futs.items()}
        parser.result()
    return reports


def labelled_engine():
    """A `TorchEngine` subclass whose stages are also named spans of a
    torch.profiler trace (the profiled pass labels idle gaps by them)."""
    from torch.profiler import record_function
    from openhevc_tpu_torch.models.pipeline import TorchEngine

    class LabelledEngine(TorchEngine):
        @contextlib.contextmanager
        def _stage(self, name):
            with record_function(name), super()._stage(name):
                yield

    return LabelledEngine


def smoke_decoder(sync_timers=False, keep=None, two_layers=False,
                  native_parse=True, device="cuda", labelled=False):
    """A `Decoder(device=device, native_parse=native_parse)`, or with
    two_layers a `ShvcDecoder(device=device)` of two such decoders, that
    notes every picture's number of intra jobs (`jobs`) and whether it
    has inter blocks (`inter`), keeps the pictures for which keep(fs)
    holds with their references (`kept`: (fs, refs) pairs in decode
    order), and, with sync_timers, builds its engine with the per-stage
    timers on. labelled: the engine's stages and each picture's
    reconstruction are named spans of a torch.profiler trace."""
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    engine = labelled_engine() if labelled else TorchEngine

    class SmokeDecoder(Decoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.jobs, self.inter, self.kept = [], [], []

        def _engine(self):
            if self._torch_engine is None:
                self._torch_engine = engine(self.device,
                                            sync_timers=sync_timers)
            return self._torch_engine

        def _reconstruct(self, fs, refs):
            self.jobs.append(n_jobs(fs))
            self.inter.append(bool(fs.inter_pbs))
            if keep is not None and keep(fs):
                self.kept.append((fs, dict(refs)))
            if not labelled:
                return super()._reconstruct(fs, refs)
            from torch.profiler import record_function
            with record_function("reconstruct"):
                return super()._reconstruct(fs, refs)

    if not two_layers:
        return SmokeDecoder(device=device, native_parse=native_parse)

    class SmokeShvc(ShvcDecoder):
        layer_class = SmokeDecoder

    return SmokeShvc(device=device)


def layers(dec):
    """The single-layer decoders of a decoder."""
    return [dec.bl, dec.el] if hasattr(dec, "bl") else [dec]


def timed_decode(dec, data, fetch, device="cuda"):
    """Decode the stream with `dec`; returns (pictures, seconds): decode
    + flush + synchronize, and with fetch every picture pulled to the
    host, inside the clock."""
    sync(device)
    t0 = time.perf_counter()
    pics = dec.decode(data) + dec.flush()
    if fetch:
        for p in pics:
            p.planes.get()
    sync(device)
    return pics, time.perf_counter() - t0


def decode_all(data, fetch, sync_timers=False, two_layers=False,
               native_parse=True, device="cuda"):
    """Decode the stream with a fresh `smoke_decoder`; returns
    (pictures, seconds, decoder) (`timed_decode`)."""
    dec = smoke_decoder(sync_timers, two_layers=two_layers,
                        native_parse=native_parse, device=device)
    return (*timed_decode(dec, data, fetch, device), dec)


def breakdown(data, two_layers=False, device="cuda"):
    """Mean ms per frame of each stage: the host parse run alone (native
    core, parse-ahead threads; None for two layers, where the
    enhancement layer's parse needs the base layer's pictures); then one
    decode with the engine's per-stage timers on (each stage
    synchronised, so nothing overlaps): host packing (band sort, filter
    control data, motion deltas), the one upload, residual, MC stage 1 /
    stage 2 / combine, meta + level schedule, the intra kernel, deblock,
    SAO, crop + pack, the inter-layer upsample; and the device-to-host
    fetch of every output. With two layers a frame is an output
    (enhancement-layer) picture and the stages of both layers add up.
    Returns (rows, decoder, pictures)."""
    out = {"parse": None}
    if not two_layers:
        t0 = time.perf_counter()
        nf = len(parse_only(data, device=device))
        out["parse"] = (time.perf_counter() - t0) * 1e3 / nf
    pics, _, dec = decode_all(data, fetch=False, sync_timers=True,
                              two_layers=two_layers, device=device)
    nf = len(pics)
    for d in layers(dec):
        for key, ms in d._engine().stage_ms.items():
            out[key] = out.get(key, 0.0) + ms / nf
    out["prep (host_pack + upload + residual + meta_schedule)"] = sum(
        out.get(key, 0.0) for key in ("host_pack", "upload", "residual",
                                      "meta_schedule"))
    t0 = time.perf_counter()
    for p in pics:
        p.planes.get()
    out["fetch"] = (time.perf_counter() - t0) * 1e3 / nf
    return out, dec, pics


# ---- the device's busy share from a profiler trace --------------------------

def device_busy(device_ops, host_ops, window, top=5, gaps=3):
    """Busy share of the device over `window` (start, end), from its
    (start, end, name) intervals `device_ops` (kernels, memcpys,
    memsets; overlapping and nested intervals count once: their union),
    with the `top` device operations by total time (clipped to the
    window) and the `gaps` longest idle gaps, each labelled with the
    host operations of `host_ops` (start, end, name) running when it
    began, outermost first (`host_stack`; `host_op`: the innermost, None
    when none ran), and with the three host operations (by name) that
    overlap it most (`host_during`). Any time unit; durations come out
    in the unit / 1000 (us in, ms out). With no device interval in the
    window the share is None: not measured."""
    t0, t1 = window
    ops = [(max(s, t0), min(e, t1), n) for s, e, n in device_ops
           if e > t0 and s < t1]
    if not ops or t1 <= t0:
        return {"busy_share": None, "device_ms": None,
                "window_ms": (t1 - t0) / 1e3, "top_device_ops": [],
                "longest_idle_gaps": [],
                "busy_share_note": "not measured: the trace holds no device "
                                   "events"}
    idle, last = [], t0
    for s, e, _ in sorted(ops):
        if s > last:
            idle.append((last, s))
        last = max(last, e)
    if last < t1:
        idle.append((last, t1))
    busy = (t1 - t0) - sum(e - s for s, e in idle)
    totals = {}
    for s, e, n in ops:
        tot, cnt = totals.get(n, (0.0, 0))
        totals[n] = (tot + e - s, cnt + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    idle.sort(key=lambda g: g[0] - g[1])        # longest first, stable

    def running(t):
        inside = sorted((h for h in host_ops if h[0] <= t < h[1]),
                        key=lambda h: (h[0], -h[1]))
        return [h[2] for h in inside]

    def during(s, e):
        over = {}
        for hs, he, n in host_ops:
            if min(e, he) > max(s, hs):
                over[n] = over.get(n, 0.0) + min(e, he) - max(s, hs)
        ranked = sorted(over.items(), key=lambda kv: -kv[1])[:3]
        return [{"name": n, "ms": t / 1e3} for n, t in ranked]

    out_gaps = []
    for s, e in idle[:gaps]:
        stack = running(s)
        out_gaps.append({"start_ms": (s - t0) / 1e3, "ms": (e - s) / 1e3,
                         "host_op": stack[-1] if stack else None,
                         "host_stack": stack, "host_during": during(s, e)})
    return {"busy_share": busy / (t1 - t0), "device_ms": busy / 1e3,
            "window_ms": (t1 - t0) / 1e3,
            "top_device_ops": [{"name": n, "ms": tot / 1e3, "count": cnt}
                               for n, (tot, cnt) in ranked],
            "longest_idle_gaps": out_gaps}


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


def profiled_pass(data, two_layers, device):
    """One decode-only pass under torch.profiler (CPU and, on a card,
    CUDA activity) with the engine's stages as named spans; returns
    (`device_busy` of its trace, pictures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    dec = smoke_decoder(two_layers=two_layers, device=device, labelled=True)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            pics = dec.decode(data) + dec.flush()
            sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return device_busy(*trace_intervals(trace)), pics


# ---- one stream -------------------------------------------------------------

def _counters():
    from openhevc_tpu_torch.ops import intra_fused as ifm
    return {n: getattr(ifm, n) for n in KERNEL_ENTRIES}


def _fresh(device):
    """Free what earlier passes left (pictures, decoders, caches) before
    a pass whose memory is read."""
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def diagnostics(name, data, want, two, device):
    """Step 3 of the module docstring for one stream, from three decodes
    of their own, each md5-checked (`diagnostics_exact`): the stage
    breakdown; one decode with every picture fetched for the launches,
    the bytes and the peak memory (none of them disturbs the others);
    and the profiled pass, which follows that decode without emptying
    the allocator's cache, so that no cudaMalloc of a cold cache falls
    inside its window."""
    import torch
    same = {}
    stages, _dec, pics = breakdown(data, two, device)
    same["stages"] = hash_pics(pics) == want
    del pics, _dec
    _fresh(device)

    counters = _counters()
    for f in counters.values():
        f.launches = 0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pics, _, dec = decode_all(data, fetch=True, two_layers=two,
                              device=device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    launches = {n: f.launches for n, f in counters.items()}
    nf = max(len(pics), 1)
    h2d = sum(d._engine().h2d_bytes for d in layers(dec))
    d2h = sum(pl.nbytes for p in pics for pl in p.planes.get())
    same["counts"] = hash_pics(pics) == want
    del pics, dec
    gc.collect()

    busy, pics = profiled_pass(data, two, device)
    same["profile"] = hash_pics(pics) == want
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        log(f"{name}: diagnostic passes {bad} differ from the md5 sidecar")
    return {"diagnostics_exact": not bad, "launches": launches,
            "h2d_bytes_per_frame": h2d / nf, "d2h_bytes_per_frame": d2h / nf,
            "peak_mem_bytes": peak, **busy, "stages_ms": stages}


def measure(name, kind, device="cuda", streams_dir=STREAM_DIR, reps=REPS):
    """Steps 1-3 of the module docstring on one stream; returns its
    `configs` entry."""
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    data, want = load_stream(name, streams_dir)
    two = kind == "shvc"
    decode_all(first_frames(data, 4 if two else 2), fetch=True,
               two_layers=two, device=device)                    # warm-up
    secs = {"decode_only": [], "delivery": []}
    fps = {"decode_only": [], "delivery": []}
    same = {"decode_only": True, "delivery": True}
    for i in range(reps):
        for mode in ("decode_only", "delivery"):
            dec = ShvcDecoder(device=device) if two else \
                Decoder(device=device)
            pics, dt = timed_decode(dec, data, mode == "delivery", device)
            ok = hash_pics(pics) == want
            same[mode] &= ok
            secs[mode].append(dt)
            fps[mode].append(len(pics) / dt)
            log(f"{name} {mode}[{i}]: {len(pics)} frames in {dt} s, "
                f"{len(pics) / dt} fps, md5 {'ok' if ok else 'MISMATCH'}")
            del dec, pics
    out = {"frames": len(want), "fps": max(fps["delivery"]),
           "fps_median": statistics.median(fps["delivery"]),
           "fps_decode_only": max(fps["decode_only"]),
           "fps_decode_only_median": statistics.median(fps["decode_only"]),
           "rep_times_s": secs, "bit_exact": same["delivery"],
           "decode_only_exact": same["decode_only"]}
    out.update(diagnostics(name, data, want, two, device))
    # the profiler slows the host, so its window is longer than a timed
    # pass: the device's time over the median timed decode-only pass is
    # the share that the timed passes see
    out["busy_share_timed"] = None if out["device_ms"] is None else \
        out["device_ms"] / (1e3 * statistics.median(secs["decode_only"]))
    log(f"{name}: fps {out['fps']} delivery / {out['fps_decode_only']} "
        f"decode-only (best of {reps}; medians {out['fps_median']} / "
        f"{out['fps_decode_only_median']}); exact "
        f"{out['bit_exact']}/{out['decode_only_exact']}/"
        f"{out['diagnostics_exact']}; launches {out['launches']}; busy "
        f"share {out['busy_share']} profiled, {out['busy_share_timed']} of "
        f"the timed pass; peak memory {out['peak_mem_bytes']} B")
    return out


# ---- the JSON line ----------------------------------------------------------

def exact(r) -> bool:
    """A stream measured md5-exact in every pass (an error is not)."""
    return "error" not in r and all(
        r.get(k) is True
        for k in ("bit_exact", "decode_only_exact", "diagnostics_exact"))


def device_info(device="cuda"):
    """The card the run measured (name, count, nvidia-smi's name and
    power limit) and the torch / CUDA versions; on the CPU (tests) the
    device's name and count 0."""
    import torch
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": str(dev), "count": 0, "nvidia_smi": None, **info}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return {"name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.splitlines()[0] if smi else None, **info}


def result_line(configs: dict, device="cuda") -> dict:
    head = configs.get(HEADLINE)
    ok = head is None or exact(head)
    head = head or {}
    return {"metric": "i_main_832x480_intra_fps" + ("" if ok else
                                                    "_MISMATCH"),
            "value": head.get("fps"), "unit": "frames/s",
            "value_decode_only": head.get("fps_decode_only"),
            "ref_fps": None, "vs_baseline": None, "ref_note": NO_REF,
            "configs": configs, "device": device_info(device),
            "load_avg": list(os.getloadavg()), "cpu_count": os.cpu_count()}


def exit_code(configs: dict) -> int:
    return 0 if configs and all(exact(r) for r in configs.values()) else 1


def run_only(name, device="cuda", streams_dir=STREAM_DIR, reps=REPS) -> int:
    """One stream in this process: print its JSON line; returns the exit
    code (1 when it is not md5-exact in every pass or a file is
    missing)."""
    kind = {n: k for n, k, _ in CONFIGS}[name]
    try:
        configs = {name: measure(name, kind, device, streams_dir, reps)}
    except FileNotFoundError as e:
        log(f"{name}: {e}")
        return 1
    print(json.dumps(result_line(configs, device)), flush=True)
    return exit_code(configs)


def run_stream(name, frames, timeout_s) -> dict:
    """`--only name` in a subprocess under timeout_s; returns its configs
    entry, or {"error": ...} for a timeout, a crash, or a frame count
    other than the configured one."""
    try:
        cp = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--only", name], cwd=ROOT, capture_output=True,
                            text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        log(f"{name}: TIMEOUT after {timeout_s} s")
        return {"error": f"timeout after {timeout_s} s"}
    for line in cp.stderr.splitlines():
        if line.startswith("[bench_torch]"):
            print(line, file=sys.stderr, flush=True)
    try:
        r = json.loads(cp.stdout.strip().splitlines()[-1])["configs"][name]
    except (IndexError, KeyError, ValueError):
        tail = cp.stderr.strip().splitlines()[-1:]
        log(f"{name}: FAILED (exit {cp.returncode}): {tail}")
        return {"error": f"exit {cp.returncode}: {tail}"}
    if r["frames"] != frames:
        r["error"] = f"{r['frames']} frames in the sidecar, not {frames}"
        log(f"{name}: {r['error']}")
    return r


def orchestrate() -> int:
    """Every stream, each in a process of its own, after one build."""
    timeout_s = int(os.environ.get("OPENHEVC_BENCH_CONFIG_TIMEOUT",
                                   TIMEOUT_S))
    t0 = time.perf_counter()
    build_all()
    log(f"kernels and parse core built in {time.perf_counter() - t0} s")
    configs = {name: run_stream(name, frames, timeout_s)
               for name, _kind, frames in CONFIGS}
    print(json.dumps(result_line(configs)), flush=True)
    return exit_code(configs)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device is available; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=[n for n, _, _ in CONFIGS],
                    help="measure this stream in this process")
    args = ap.parse_args(argv)
    return run_only(args.only) if args.only else orchestrate()


if __name__ == "__main__":
    sys.exit(main())
