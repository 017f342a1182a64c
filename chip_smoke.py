#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openhevc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Two bench streams: i_main (bench_streams/r4a_i_main_832x480.265, 832x480
all-intra Main, 32 frames, WPP; whole-frame intra kernel) and main10_4k
(bench_streams/r4a_main10_4k.265, 3840x2160 all-intra Main10, 3 frames,
WPP; banded intra kernel). Phases (each one fails the run with a
non-zero exit):
  1. build the CUDA kernels (one nvcc per source, all at once) and the
     native parse core from the checkout's sources; print nvcc's
     register / shared-memory report for each kernel;
  2. print the card's name and power limit;
  3. parse frame 0 of each stream and hold each level-parallel kernel
     against its plain PyTorch version on the card on the same inputs,
     requiring identical planes: the whole-frame kernel on i_main frame
     0; the banded kernel on bands 0-1 of 4K frame 0 (the plain version
     takes ~0.5 ms a job), and against the whole-frame kernel on all of
     4K frame 0 (same band-sorted meta and band-layout planes). Then, on
     the whole of both frames: level-parallel kernel == the serial-order
     entry (one warp, jobs in meta order), and REPEATS launches in a row
     give identical planes (a hand-over that is almost right fails here).
     Print each frame's level-width histogram; time the kernels;
  4. decode every frame of each stream through `Decoder(device="cuda")`
     with every launch counter set to 0 just before, require each
     stream's kernel to have launched once per frame and the other
     kernel and the serial-order entry not at all, and require the
     per-frame md5 (cropped Y, U, V as uint8, or uint16 above 8 bits, as
     bench.py hashes) to equal the reference decoder's sidecar for every
     frame;
  5. print decode rates (every timed pass is md5-checked too), stage
     breakdowns, kernel times, launch counts, and one JSON line with
     every kernel's record; the last line is the device summary.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAMS = {"i_main": "r4a_i_main_832x480.265",
           "main10_4k": "r4a_main10_4k.265"}
KERNEL_OF = {"i_main": "intra_fused", "main10_4k": "intra_fused_banded"}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 5
REPEATS = 20        # launches in a row that must give identical planes
PLAIN_BANDS = 2     # bands of 4K frame 0 held to the plain version


def load_stream(name):
    path = os.path.join(ROOT, "bench_streams", STREAMS[name])
    return open(path, "rb").read(), open(path + ".md5").read().split()


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


def parse_only(data: bytes):
    """Parsed FrameSymbols of every picture (no reconstruction)."""
    from openhevc_tpu_torch.decoder import Decoder

    class _Parse(Decoder):
        def _reconstruct(self, fs, refs):
            self.parsed.append(fs)

    d = _Parse(device="cuda")
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


def _sync():
    import torch
    torch.cuda.synchronize()


def _elapsed_ms(fn):
    """Device time of fn() in ms, from CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _max_err(xs, ys):
    return max(int((a - b).abs().max()) for a, b in zip(xs, ys))


def _run_kernel(k, banded, head=None, planes=None):
    """One launch of the whole-frame or the banded level-parallel kernel
    on prepare()'s inputs k: all jobs with k's schedule, or the jobs and
    schedule of `head` (_head), on `planes` or on fresh clones of the
    starting planes; returns [luma, chroma]."""
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded)
    out = planes or [k["luma"].clone(), k["chroma"].clone()]
    n, bounds, order, level_bounds = head or (
        k["n"], k["bounds"], k["order"], k["level_bounds"])
    tail = (*out, k["res_l"], k["res_c"], k["bd"], order, level_bounds)
    if banded:
        intra_fused_banded(k["meta"], bounds, n, *tail)
    else:
        intra_fused(k["meta"], n, *tail)
    return out


def _head(k, nbands):
    """(n, bounds, order, level_bounds) of the first nbands bands of a
    banded plan k: the jobs below bounds[nbands], in k's level order.
    Valid on its own: a job depends only on jobs of its own and earlier
    bands."""
    import torch
    bounds = k["bounds"][:nbands + 1]
    n = int(bounds[-1])
    keep = k["order"] < n
    seen = torch.cat([keep.new_zeros(1, dtype=torch.int32),
                      keep.cumsum(0, dtype=torch.int32)])
    return (n, bounds, k["order"][keep].contiguous(),
            seen[k["level_bounds"].long()].contiguous())


def _run_serial(k):
    """The serial-order entry on fresh clones of k's starting planes."""
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_serial
    out = [k["luma"].clone(), k["chroma"].clone()]
    intra_fused_serial(k["meta"], k["n"], *out, k["res_l"], k["res_c"],
                       k["bd"])
    return out


def _kernel_ms(k, banded, reps):
    """Mean CUDA-event time of one whole-frame launch, each on fresh
    clones of the starting planes."""
    times = []
    for _ in range(reps):
        bufs = [k["luma"].clone(), k["chroma"].clone()]
        _sync()
        times.append(_elapsed_ms(lambda: _run_kernel(k, banded,
                                                     planes=bufs)))
    return sum(times) / len(times)


def _bound_ms(fs, k):
    """Least time for the work on this card, from bytes: the jobs' meta
    and order (64 + 4 B a job), the level bounds, the frame's residual
    read once, the reconstruction written once (8 B a sample), and the
    PCM samples prefilled into the starting planes (the kernel reads no
    other sample of those planes that it has not written itself)."""
    H, W, Hc, Wc = k["dims"]
    pcm = sum(p.size * p.size + 2 * (p.size >> fs.sps.vshift1)
              * (p.size >> fs.sps.hshift1) for p in fs.pcm_blocks)
    nbytes = (16 + 1) * 4 * k["n"] + 4 * k["level_bounds"].numel() + \
        2 * 4 * (H * W + 2 * Hc * Wc) + 4 * pcm
    return nbytes / HBM_BYTES_PER_S * 1e3


def level_widths(fs, grid):
    """Histogram of the jobs per wavefront level of one parsed picture,
    beside the kernel's grid (blocks) and its teams of warps (a team
    runs one job at a time)."""
    import numpy as np
    from openhevc_tpu_torch.ops.intra_fused import TEAMS_PER_BLOCK
    w = np.bincount(fs.native_raw["ij_meta"][:, 6])[1:]
    return {"levels": int(len(w)), "min": int(w.min()),
            "median": float(np.median(w)), "mean": float(w.mean()),
            "p90": float(np.percentile(w, 90)), "max": int(w.max()),
            "share_no_wider_than_blocks": float((w <= grid).mean()),
            "share_no_wider_than_teams":
                float((w <= TEAMS_PER_BLOCK * grid).mean())}


def check_whole_frame(name, fs, k, banded):
    """Phase 3 on the whole of one frame: level-parallel kernel == the
    serial-order entry, and REPEATS launches give identical planes.
    Returns (serial ms, the kernel's grid)."""
    import torch
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded)
    want = _run_serial(k)
    serial_ms = _elapsed_ms(lambda: _run_serial(k))
    for i in range(REPEATS):
        got = _run_kernel(k, banded)
        _sync()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(
                f"{name}: launch {i} of the level-parallel kernel differs "
                f"from the serial-order entry by up to "
                f"{_max_err(got, want)}")
    grid = (intra_fused_banded if banded else intra_fused).last_grid
    hist = level_widths(fs, grid)
    print(f"phase3 {name} frame 0: level-parallel == serial-order entry on "
          f"{k['n']} jobs, {REPEATS} launches identical (grid {grid} "
          f"blocks); level widths {json.dumps(hist)}", flush=True)
    return serial_ms, grid


def _record(name, source, replaces, fs, k, err, ms, plain_ms, serial_ms,
            grid):
    n_levels = fs.native_raw["n_levels"]
    return {
        "name": name, "route": "cuda",
        "source": f"openhevc_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": _bound_ms(fs, k),
        "bound_by": "bytes", "library_ms": None,
        # not contract keys: the wavefront chain that bounds it in
        # practice, and the serial-order entry's time on the same frame
        "jobs": k["n"], "n_levels": n_levels, "serial_ms": serial_ms,
        "us_per_level": ms * 1e3 / n_levels, "us_per_job": ms * 1e3 / k["n"],
        "grid": grid,
    }


def check_intra_fused(fs, reps=REPS):
    """Phase 3 for the whole-frame kernel on one parsed picture: kernel
    and plain version on the same inputs must agree exactly, and so must
    kernel and serial-order entry, over and over. Returns the kernel's
    JSON record (launches filled in later)."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_ref
    k = TorchEngine("cuda").prepare(fs)
    if k["bounds"] is not None:
        raise AssertionError("i_main frame 0 planned banded")
    out_k = _run_kernel(k, banded=False)
    out_p = [k["luma"].clone(), k["chroma"].clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_ref(
        k["meta"], k["n"], *out_p, k["res_l"], k["res_c"], k["bd"]))
    err = _max_err(out_k, out_p)
    if err != 0:
        raise AssertionError(f"intra_fused differs from its plain version "
                             f"by up to {err}")
    serial_ms, grid = check_whole_frame("i_main", fs, k, False)
    return _record("intra_fused", "intra_fused.cu",
                   "openhevc_tpu/ops/intra_fused.py:490", fs, k, err,
                   _kernel_ms(k, False, reps), plain_ms, serial_ms, grid)


def check_intra_fused_banded(fs, reps=REPS):
    """Phase 3 for the banded kernel on one parsed 4K picture: kernel ==
    plain version on the first PLAIN_BANDS bands; kernel == the
    whole-frame kernel and == the serial-order entry on the whole frame
    (same band-sorted meta, same band-layout planes), over and over.
    Returns (record, whole-frame kernel ms on this frame)."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_banded_ref
    k = TorchEngine("cuda").prepare(fs)
    if k["bounds"] is None:
        raise AssertionError("4K frame 0 planned whole-frame")
    head = _head(k, PLAIN_BANDS)
    out_k = _run_kernel(k, True, head=head)
    out_p = [k["luma"].clone(), k["chroma"].clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_banded_ref(
        k["meta"], head[1], head[0], *out_p, k["res_l"], k["res_c"],
        k["bd"]))
    err = _max_err(out_k, out_p)
    if err != 0:
        raise AssertionError(f"intra_fused_banded differs from its plain "
                             f"version by up to {err} on bands "
                             f"0-{PLAIN_BANDS - 1}")
    out_b = _run_kernel(k, True)
    out_w = _run_kernel(k, False)
    werr = _max_err(out_b, out_w)
    if werr != 0:
        raise AssertionError(f"intra_fused_banded differs from intra_fused "
                             f"on the whole frame by up to {werr}")
    serial_ms, grid = check_whole_frame("main10_4k", fs, k, True)
    ms_b, ms_w = [], []
    for _ in range(reps):          # alternate the two kernels
        ms_b.append(_kernel_ms(k, True, 1))
        ms_w.append(_kernel_ms(k, False, 1))
    rec = _record("intra_fused_banded", "intra_fused_banded.cu",
                  "openhevc_tpu/ops/intra_fused.py:627", fs, k, err,
                  sum(ms_b) / reps, plain_ms, serial_ms, grid)
    rec.update(plain_jobs=head[0], bands=len(k["bounds"]) - 1,
               whole_frame_max_abs_err=werr)
    return rec, sum(ms_w) / reps


def decode_all(data, fetch):
    """Decode the stream; returns (pictures, seconds, decoder).
    fetch=True pulls every picture to the host inside the timed region."""
    from openhevc_tpu_torch.decoder import Decoder
    dec = Decoder(device="cuda")
    _sync()
    t0 = time.perf_counter()
    pics = dec.decode(data) + dec.flush()
    if fetch:
        for p in pics:
            p.planes.get()
    _sync()
    return pics, time.perf_counter() - t0, dec


def breakdown(data):
    """Mean ms per frame of each stage run alone and synchronised: host
    parse (native core, parse-ahead threads), prep (one H2D copy,
    residual, PCM prefill, meta, band sort, level schedule), the intra
    kernel of the frame's plan, crop + pack, and the device-to-host
    fetch of the output."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine, crop_pack
    t0 = time.perf_counter()
    fss = parse_only(data)
    out = {"parse": (time.perf_counter() - t0) * 1e3}
    eng = TorchEngine("cuda")
    for key in ("prep", "kernel", "crop_pack", "fetch"):
        out[key] = 0.0
    slowest_prep = 0.0
    for fs in fss:
        _sync()
        t0 = time.perf_counter()
        k = eng.prepare(fs)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        out["prep"] += ms
        slowest_prep = max(slowest_prep, ms)
        out["kernel"] += _elapsed_ms(lambda: _run_kernel(
            k, k["bounds"] is not None, planes=[k["luma"], k["chroma"]]))
        t0 = time.perf_counter()
        flat = crop_pack(k["luma"], k["chroma"], *k["dims"], k["bd"])
        _sync()
        out["crop_pack"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        flat.cpu()
        out["fetch"] += (time.perf_counter() - t0) * 1e3
    out = {k: v / len(fss) for k, v in out.items()}
    out["prep (slowest frame)"] = slowest_prep
    return out


def main_path(name, counters):
    """Phase 4 on one stream: decode it with every launch counter set to
    0 just before; require its kernel exactly once per frame, the other
    kernel and the serial-order entry never, and every frame's md5 equal
    to the sidecar. Returns (number of frames, launch counts, decoder)."""
    data, want = load_stream(name)
    decode_all(first_frames(data, 2), fetch=True)         # warm-up
    for f in counters.values():
        f.launches = 0
    pics, _, dec = decode_all(data, fetch=False)
    launches = {n: f.launches for n, f in counters.items()}
    got = hash_pics(pics)
    n_ok = sum(g == w for g, w in zip(got, want))
    print(f"phase4 {name} md5 {n_ok}/{len(want)} frames equal the sidecar "
          f"({len(pics)} decoded; launches {launches})", flush=True)
    if len(pics) != len(want) or n_ok != len(want):
        raise AssertionError(f"{name}: decoded frames differ from the "
                             f"reference md5 sidecar")
    for n, c in launches.items():
        if n == KERNEL_OF[name] and c != len(pics):
            raise AssertionError(f"{name}: kernel {n} launched {c} times "
                                 f"for {len(pics)} frames")
        if n != KERNEL_OF[name] and c != 0:
            raise AssertionError(f"{name}: {n} launched {c} times; this "
                                 f"stream's frames are {KERNEL_OF[name]}'s")
    return len(pics), launches, dec


def report(name, nf, dec):
    """Phase 5 on one stream: decode rates (outputs on the device and
    fetched to the host, alternating; every pass's frames are hashed
    after its clock stops and must equal the sidecar) and the stage
    breakdown."""
    data, want = load_stream(name)
    for i in range(2):
        for label, fetch in (("device_resident", False),
                             ("fetched_to_host", True)):
            pics, dt, _ = decode_all(data, fetch=fetch)
            if hash_pics(pics) != want:
                raise AssertionError(f"{name}: timed pass {label}[{i}] "
                                     f"differs from the md5 sidecar")
            print(f"{name} decode_fps_{label}[{i}] {nf / dt}")
    for k, v in breakdown(data).items():
        print(f"{name} stage_ms_per_frame {k} {v}")
    print(f"{name} native_slices {dec.stats['native_slices']}", flush=True)


def run():
    """Phases 3-5 on the card; returns the kernel records."""
    from openhevc_tpu_torch.ops import intra_fused as ifm
    counters = {"intra_fused": ifm.intra_fused,
                "intra_fused_banded": ifm.intra_fused_banded,
                "intra_fused_serial": ifm.intra_fused_serial}

    # ---- phase 3: each kernel vs its plain version -----------------------
    fs = parse_only(first_frames(load_stream("i_main")[0], 1))[0]
    recs = {"i_main": check_intra_fused(fs)}
    r = recs["i_main"]
    print(f"phase3 intra_fused == plain on i_main frame 0 ({r['jobs']} "
          f"jobs, {r['n_levels']} wavefront levels): max_abs_err "
          f"{r['max_abs_err']}", flush=True)
    fs = parse_only(first_frames(load_stream("main10_4k")[0], 1))[0]
    recs["main10_4k"], whole_4k_ms = check_intra_fused_banded(fs)
    r = recs["main10_4k"]
    print(f"phase3 intra_fused_banded == plain on bands "
          f"0-{PLAIN_BANDS - 1} of main10_4k frame 0 ({r['plain_jobs']} "
          f"jobs): max_abs_err {r['max_abs_err']}; == intra_fused on the "
          f"whole frame ({r['jobs']} jobs, {r['bands']} bands, "
          f"{r['n_levels']} wavefront levels): max_abs_err "
          f"{r['whole_frame_max_abs_err']}", flush=True)

    # ---- phase 4: the main path of each stream ---------------------------
    runs = {name: main_path(name, counters) for name in STREAMS}
    for name, (_, launches, _) in runs.items():
        recs[name]["launches"] = launches[KERNEL_OF[name]]

    # ---- phase 5: report ---------------------------------------------------
    for name, (nf, _, dec) in runs.items():
        report(name, nf, dec)
    for name, r in recs.items():
        print(f"{r['name']}_kernel_ms_per_frame {r['ms']} ({name} frame 0; "
              f"{r['us_per_level']} us a level, {r['us_per_job']} us a job, "
              f"grid {r['grid']})")
        print(f"{r['name']}_serial_order_entry_ms {r['serial_ms']} "
              f"({name} frame 0)")
        print(f"{r['name']}_plain_ms {r['plain_ms']} "
              f"({r.get('plain_jobs', r['jobs'])} jobs)")
        print(f"{r['name']}_launches {r['launches']} ({name})")
    print(f"intra_fused_kernel_ms_main10_4k_frame0 {whole_4k_ms} (same "
          f"band-sorted meta and planes)", flush=True)
    return list(recs.values())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import openhevc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 3
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    for name, report in build_all().items():
        print(f"phase1 built {name} (nvcc -Xptxas -v):")
        print("\n".join("  " + ln for ln in report.strip().splitlines()))
    print(f"phase1 build seconds {time.perf_counter() - t0}", flush=True)

    # ---- phase 2: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    kernels = run()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
