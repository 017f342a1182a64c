#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openhevc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):
  1. build the CUDA kernels (one nvcc per source, all at once) and the
     native parse core from the checkout's sources; print nvcc's
     register / shared-memory report;
  2. print the card's name and power limit;
  3. parse frame 0 of bench_streams/r4a_i_main_832x480.265 (832x480
     all-intra Main, WPP), run each kernel and its plain PyTorch version
     on the card on the same inputs, require identical output, and time
     both;
  4. decode all 32 frames through `Decoder(device="cuda")` with every
     launch counter set to 0 just before, require every kernel of the
     path to have launched, and require the per-frame md5 (cropped Y, U,
     V as uint8, as bench.py hashes) to equal the reference decoder's
     sidecar for 32/32 frames;
  5. print decode rates, kernel times, launch counts, and one JSON line
     per kernel set; the last line is the device summary.

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
STREAM = os.path.join(ROOT, "bench_streams", "r4a_i_main_832x480.265")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 5


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
    import numpy as np
    hs = []
    for p in pics:
        h = hashlib.md5()
        for plane in p.cropped():
            h.update(np.ascontiguousarray(np.asarray(plane, np.uint8))
                     .tobytes())
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


def check_intra_fused(fs, reps=REPS):
    """Phase 3 for the fused intra kernel on one parsed picture: kernel
    and plain version on the same inputs must agree exactly. Returns the
    kernel's JSON record (launches filled in later)."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_ref)
    k = TorchEngine("cuda").prepare(fs)
    args = (k["meta"], k["n"])
    tail = (k["res_l"], k["res_c"], k["bd"])
    l0, c0 = k["luma"].clone(), k["chroma"].clone()

    out_k = [l0.clone(), c0.clone()]
    intra_fused(*args, *out_k, *tail)
    out_p = [l0.clone(), c0.clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_ref(*args, *out_p, *tail))
    err = max(int((a - b).abs().max()) for a, b in zip(out_k, out_p))
    if err != 0:
        raise AssertionError(f"intra_fused differs from its plain version "
                             f"by up to {err}")
    times = []
    for _ in range(reps):
        bufs = [l0.clone(), c0.clone()]
        _sync()
        times.append(_elapsed_ms(lambda: intra_fused(*args, *bufs, *tail)))
    H, W, Hc, Wc = k["dims"]
    # bytes the work must move: the jobs' meta and the frame's residual
    # read once, the reconstruction written once, and the PCM samples
    # prefilled into the starting planes (the kernel reads no other sample
    # of those planes that it has not written itself)
    pcm = sum(p.size * p.size + 2 * (p.size >> fs.sps.vshift1)
              * (p.size >> fs.sps.hshift1) for p in fs.pcm_blocks)
    nbytes = 16 * 4 * k["n"] + 2 * 4 * (H * W + 2 * Hc * Wc) + 4 * pcm
    return {
        "name": "intra_fused", "route": "cuda",
        "source": "openhevc_tpu_torch/csrc/intra_fused.cu",
        "replaces": "openhevc_tpu/ops/intra_fused.py:490",
        "launches": 0, "max_abs_err": err,
        "ms": sum(times) / len(times), "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        # not contract keys: the serial chain that bounds it in practice
        "jobs": k["n"], "n_levels": fs.native_raw["n_levels"],
    }


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
    residual, PCM prefill, meta), the intra kernel, crop + pack, and the
    device-to-host fetch of the output."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine, crop_pack
    from openhevc_tpu_torch.ops.intra_fused import intra_fused
    t0 = time.perf_counter()
    fss = parse_only(data)
    out = {"parse": (time.perf_counter() - t0) * 1e3}
    eng = TorchEngine("cuda")
    for key in ("prep", "kernel", "crop_pack", "fetch"):
        out[key] = 0.0
    for fs in fss:
        _sync()
        t0 = time.perf_counter()
        k = eng.prepare(fs)
        _sync()
        out["prep"] += (time.perf_counter() - t0) * 1e3
        out["kernel"] += _elapsed_ms(lambda: intra_fused(
            k["meta"], k["n"], k["luma"], k["chroma"], k["res_l"],
            k["res_c"], k["bd"]))
        t0 = time.perf_counter()
        flat = crop_pack(k["luma"], k["chroma"], *k["dims"])
        _sync()
        out["crop_pack"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        flat.cpu()
        out["fetch"] += (time.perf_counter() - t0) * 1e3
    return {k: v / len(fss) for k, v in out.items()}


def run():
    """Phases 3-5 on the card; returns the kernel records."""
    from openhevc_tpu_torch.ops import intra_fused as ifm
    data = open(STREAM, "rb").read()
    want = open(STREAM + ".md5").read().split()

    # ---- phase 3: kernel vs plain on frame 0 -----------------------------
    fs0 = parse_only(first_frames(data, 1))[0]
    rec = check_intra_fused(fs0)
    print(f"phase3 intra_fused == plain on frame 0 ({rec['jobs']} jobs, "
          f"{rec['n_levels']} wavefront levels): max_abs_err "
          f"{rec['max_abs_err']}", flush=True)

    # ---- phase 4: the main path -------------------------------------------
    decode_all(data, fetch=True)                        # warm-up
    counters = {"intra_fused": ifm.intra_fused}
    for f in counters.values():
        f.launches = 0
    pics, dt_dev, dec = decode_all(data, fetch=False)
    launches = {n: f.launches for n, f in counters.items()}
    got = hash_pics(pics)
    n_ok = sum(g == w for g, w in zip(got, want))
    print(f"phase4 md5 {n_ok}/{len(want)} frames equal the sidecar "
          f"({len(pics)} decoded)", flush=True)
    if len(pics) != len(want) or n_ok != len(want):
        raise AssertionError("decoded frames differ from the reference "
                             "md5 sidecar")
    for n, c in launches.items():
        if c < len(pics):
            raise AssertionError(f"kernel {n} launched {c} times for "
                                 f"{len(pics)} frames")
    rec["launches"] = launches["intra_fused"]

    # ---- phase 5: report --------------------------------------------------
    nf = len(pics)
    for i in range(2):         # alternate the two modes on one card
        _, dt_dev, _ = decode_all(data, fetch=False)
        _, dt_host, _ = decode_all(data, fetch=True)
        print(f"decode_fps_device_resident[{i}] {nf / dt_dev}")
        print(f"decode_fps_fetched_to_host[{i}] {nf / dt_host}")
    for k, v in breakdown(data).items():
        print(f"stage_ms_per_frame {k} {v}")
    print(f"intra_fused_kernel_ms_per_frame {rec['ms']}")
    print(f"intra_fused_plain_ms_frame0 {rec['plain_ms']}")
    print(f"intra_fused_launches {rec['launches']}")
    print(f"native_slices {dec.stats['native_slices']}", flush=True)
    return [rec]


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
