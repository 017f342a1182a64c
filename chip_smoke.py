#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openhevc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Seven bench streams (bench_streams/r4a_*.265, each decoded whole):
i_main (832x480 all-intra Main, 32 frames, WPP; whole-frame intra
kernel), main10_4k (3840x2160 all-intra Main10, 3 frames, WPP; banded
intra kernel), three hierarchical-B streams whose every picture takes
the banded kernel on top of the inter prediction: ra_main_1080p (17
frames, no in-loop filters), ra_tiles_1080p (9 frames, 4x2 tiles,
deblocking + SAO) and ra_main10_4k (9 frames, Main10 4K, tiles,
deblocking + SAO), rext_444 (832x480 all-intra 4:4:4, 6 frames, WPP;
banded kernel with chroma bands as tall as luma bands) and shvc_2layer
(416x240 base layer, 832x480 enhancement layer predicted from the
upsampled base layer, 12 access units, through `ShvcDecoder`; the
whole-frame kernel in both layers; only enhancement-layer pictures come
out). Phases (each one fails the run with a non-zero exit):
  1. build the CUDA kernels (one nvcc per source, all at once) and the
     native parse core from the checkout's sources; print nvcc's
     register / shared-memory report for each kernel;
  2. print the card's name and power limit;
  3. hold each level-parallel kernel against its plain PyTorch version on
     the card on the same inputs, requiring identical planes: the
     whole-frame kernel on i_main frame 0; the banded kernel on bands 0-1
     of 4K frame 0 (the plain version takes ~0.5 ms a job), and against
     the whole-frame kernel on all of 4K frame 0 (same band-sorted meta
     and band-layout planes). On the whole of both frames:
     level-parallel kernel == the serial-order entry (one warp, jobs in
     meta order), and REPEATS launches in a row give identical planes (a
     hand-over that is almost right fails here). On the first picture of
     ra_main_1080p (decode order) with both inter blocks and intra jobs:
     the banded kernel on the real inter prefill == its plain version ==
     the serial-order entry, and with no jobs (n == 0, an all-inter
     picture's call) it launches nothing and leaves the prefill as it is.
     On that picture and on one of ra_main10_4k: the MC's pair mode ==
     its tap mode exactly, both timed in turns. On frame 0 of rext_444
     (4:4:4, chroma TUs up to 32x32 with the smoothing filter): the
     banded kernel == its plain version == the serial-order entry on the
     whole frame. On the first base-layer picture of shvc_2layer: the
     inter-layer upsample (torch ops, no kernel) == a per-sample
     evaluation of the tap plan, timed with its byte bound. On the first
     inter picture of the benchmark's 1080p stream
     (benchmark/streams/hevc_ra_1080p_qp32.265): the deblocking
     edge-parameter kernel (csrc/edge_params.cu) == its plain version on
     the card == its plain version on a CPU copy of the same grids (which
     the CPU tests hold against the JAX package's `prep_filters`), timed
     beside the plain version and its byte bound.
     From here on every `TorchEngine.prepare` of a picture deblocked on
     the card, and every such member a mesh's tile axis filters, must
     launch it once, and every other prepare never (`edge_watch`); its
     launches are counted with the intra kernels' in phases 4-9. On
     every picture of that stream and the first of the benchmark's 4K
     10-bit stream (decoded on the card, the 1080p one md5-exact): the
     in-loop filters' kernels (csrc/loop_filters.cu) == their plain
     version `apply_filters_ref` on the card, call for call, timed
     beside it and their byte bounds on one picture of each. From here
     on every picture filtered on the card makes two launches for
     deblocking and one for SAO, and every band of a mesh's tile axis as
     many, and every other picture none (`filter_watch`); phase 10
     prints them by route;
     Print each frame's level-width histogram; time the kernels;
  4. decode every frame of each stream through `Decoder(device="cuda")`
     (`ShvcDecoder(device="cuda")` for shvc_2layer) with every launch
     counter set to 0 just before, require each stream's kernel to have
     launched once per picture that has an intra job (of both layers) and
     the other kernel and the serial-order entry not at all, and
     require the per-frame md5 (cropped Y, U, V as uint8, or uint16 above
     8 bits, in output order, as bench.py hashes) to equal the reference
     decoder's sidecar for every frame;
  5. (new in this slice) the routes off the main path, each driven with
     every launch counter set to 0 just before and read just after, each
     md5-exact against the sidecar (by POC):
     (i) no band plan: `band_plan` made unavailable, all 3 frames of
         main10_4k and the first RA_4K_PICTURES pictures of ra_main10_4k
         (inter + filters at 4K) take the whole-frame kernel (one launch
         a picture with jobs, 0 banded), which is timed on 4K frame 0 in
         this layout beside the banded kernel;
     (ii) the Python parser: the first frames of i_main with
         `native_parse=False` (one whole-frame launch a frame; one
         frame's parse timed first sets how many fit PY_PARSE_SECONDS),
         then the first pictures of ra_tiles_1080p in decode order, POC
         0 and POC 8 (its first inter picture, whose merge and AMVP
         candidates must stay inside their tile) and as many more as
         fit the same budget (one banded launch a picture);
     (iii) host-scheduled filters: the first HOST_FILTER_PICTURES of
         ra_tiles_1080p with `prep_filters` giving up on every picture, so
         that every filter plan takes the host route (banded launches as
         on the main path; the host_filters stage timed);
     (iv) the CLI: `python3 -m openhevc_tpu_torch -i ... -o ... -n` as a
         subprocess on i_main as Annex-B and as an MP4 written by the
         port's `container.mux_mp4`, every frame of the .yuv md5-exact;
  6. (new in slice 7) picture waves over a `parallel.DeviceMesh` built
     from the cards present, each repeated to the size asked for (four
     entries of cuda:0 on a machine with one card; the repeat is
     printed): on a frame axis of WAVE_FRAMES entries, i_main (waves of
     4), ra_main_1080p (its histogram of wave sizes must show inter
     waves of 3 or more pictures), ra_main10_4k and shvc_2layer through
     `ShvcDecoder(mesh=...)`; on a 2-D mesh of WAVE_GRID (frame x tile),
     ra_tiles_1080p (4x2 tiles in 2 tile groups; deblocking + SAO
     band-sharded) and i_main (untiled: tile group 0 does all the
     intra work). Each decode with every launch counter set to 0 just
     before, md5-exact against the sidecar, with the launches predicted
     from the parse (frame axis: one a member with intra jobs; tile
     axis: one a tile shard with jobs, from the tile maps), and its
     decode fps with the mesh and on one device timed in turns (mesh,
     one device, mesh; each pass md5-checked) beside phase 4's for the
     stream; then the banded kernel
     on tile shard 0 of ra_tiles_1080p frame 0 (its jobs cut to the
     group, levels renumbered densely) == its plain version on the
     shard's first PLAIN_BANDS bands == the serial-order entry on the
     whole shard, timed beside the kernel on the whole frame;
  7. (new in slice 8) the bench script: `python3 bench_torch.py --only
     i_main_832x480` as a subprocess must exit 0 with a JSON last line
     in which i_main is md5-exact in every timed pass, its launches equal
     phase 4's and its device is this card (the decoder helpers of this
     script are bench_torch.py's);
  8. (new in slice 10) the feature matrix: every stream of
     feature_streams/MANIFEST.json (written by
     tools/make_feature_streams.py: tier B, small streams of 4:2:2,
     4:4:4 intra / inter / filtered, 10 and 12 bits, PCM with and without
     pcm_loop_filter_disabled, lossless, transform skip, implicit RDPCM,
     rotation, persistent Rice, scaling lists, CCP, weighted prediction,
     constrained intra, intra smoothing disabled, CTB 16 / 32 / 64 with
     the CTB-16 chroma halo, long-term references, two slices, tiles,
     WPP, a concealed missing reference and all-inter pictures; tier A,
     4:2:2 10-bit and 4:4:4 8-bit low-delay streams at 1920x1080),
     decoded whole through `Decoder()` on the card with every launch
     counter at 0 just before: every picture's md5 equal to the
     sidecar (the JAX package's `Decoder("np")`), every picture on the
     route the manifest predicts (parse, filters, whole / banded / no
     band plan, jobs, inter and PCM blocks), the Python parser's slices
     as predicted and each kernel launched once a picture of its plan
     with jobs; each tier B stream decoded a second time the same way
     with every picture forced onto the banded plan, one CTB row a band
     (`forced_banded`), held to the same sidecar, every picture planned
     banded and the banded kernel launched once a picture with jobs;
     then, on the first picture with intra jobs of each
     stream (and the first inter picture with jobs of the
     constrained-intra stream), the whole-frame kernel on the
     whole-frame layout and the banded kernel on a banded plan (forced
     to one CTB row a band on tier B) == their plain versions (tier B)
     or the serial-order entry (tier A), FEATURE_REPEATS (A) launches
     in a row identical; the phase's seconds, streams, pictures and
     launches are printed and its launches join the kernels' JSON
     records under the routes `feature_matrix` and
     `feature_matrix_banded`;
  9. (new in slice 11) the two-layer (SHVC) feature matrix: every
     stream of feature_streams/shvc/MANIFEST.json (written by
     tools/make_feature_streams.py --shvc: tier B, the CPU tests' small
     two-layer cases: spatial 2x and 1.5x, SNR, a rectangular CTB-32
     stream, base-layer motion, temporal + inter-layer references in one
     list, fractional MVs into the inter-layer picture, TMVP with the
     collocated picture temporal or inter-layer, at each ratio; tier A,
     a 1920x1080 (1920x1088 at 2x) enhancement layer (EL) over 2x, 1.5x
     and SNR base layers (BL), every inter-layer tool on, the EL on the
     banded kernel), each with every launch counter at 0 just before
     its decode: through `ShvcDecoder()` on the card every EL picture
     md5-exact against the JAX package's `ShvcDecoder("np")` and
     through `Decoder()` on layer 0 alone every BL picture md5-exact
     against its `Decoder("np")`; every picture of both layers on the
     route the manifest predicts (phase 8's fields, the MC mode, the
     inter-layer reference, the collocated picture) with each layer's
     launches as predicted; tier B decoded again both ways with every
     picture forced onto the banded plan, one CTB row a band at its
     layer's width, held to the same sidecars; both kernels == their
     plain versions (tier B, the first picture with jobs of each layer
     and the EL's first inter picture) or the serial-order entry (tier
     A, the same EL pictures),
     SHVC_REPEATS launches in a row identical; on tier A the upsample of
     the BL's first picture at 2x, 1.5x and ratio 1 == a per-sample
     evaluation of its tap plans (timed, with its byte bound), and the
     EL pictures a second on the device with the stages of both layers;
     on the second EL AU of SHVC_MC_STREAM (a temporal and an
     inter-layer reference in L0) the MC's pair mode == its tap mode;
     the CLI with -l 1 and -l 0 on SHVC_CLI, every frame of each .yuv
     md5-exact. Its launches join the kernels' JSON records under the
     routes `shvc_matrix`, `shvc_matrix_base_layer` and
     `shvc_matrix_banded`;
 10. print decode rates (every timed pass is md5-checked too), stage
     breakdowns (parse, prep's parts, MC stage 1 with its cache's hit
     rate, MC stage 2, combine, kernel, deblock, SAO, crop, the
     inter-layer upsample, fetch; for shvc_2layer a frame is an
     enhancement-layer picture and both layers' stages add up) with
     the torch-op stages' byte bounds, kernel times, launch counts (on
     the main path and per route), and one JSON line with every kernel's
     record; the last line is the device summary.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# the helpers this script shares with the port's bench script
from bench_torch import (CONFIGS, breakdown, build_all, decode_all,
                         first_frames, hash_pics, layers, load_stream, n_jobs,
                         parse_only, smoke_decoder, sync)

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_OF = {name: "intra_fused" if name in ("i_main_832x480",
                                            "shvc_2layer_832x480") else
             "intra_fused_banded" for name, _kind, _frames in CONFIGS}
TWO_LAYERS = tuple(name for name, kind, _frames in CONFIGS if kind == "shvc")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 5
REPEATS = 20        # launches in a row that must give identical planes
PLAIN_BANDS = 2     # bands of 4K frame 0 held to the plain version
RA_4K_PICTURES = 5  # pictures of ra_main10_4k on the no-band-plan route
HOST_FILTER_PICTURES = 3    # pictures of ra_tiles_1080p, host filters
PY_PARSE_SECONDS = 40       # budget of each Python-parser decode (phase 5 ii)
WAVE_FRAMES = 4             # entries of the frame-axis mesh (phase 6)
WAVE_GRID = (2, 2)          # frame x tile entries of the 2-D mesh (phase 6)
FEATURE_DIR = os.path.join(ROOT, "feature_streams")    # phase 8
FEATURE_REPEATS = 3         # launches in a row a kept picture (tier B)
FEATURE_REPEATS_A = 5       # the same on the 1080p streams (tier A)
SHVC_DIR = os.path.join(FEATURE_DIR, "shvc")            # phase 9
SHVC_REPEATS = 3            # launches in a row a kept picture (phase 9)
SHVC_MC_STREAM = "shvc_x1_5_1080p_ld"   # its second EL AU: pair == tap
SHVC_CLI = ("col_il_mv", "shvc_x1_5_1080p_ld")  # through -l 1 and -l 0
EDGE_STREAM = os.path.join(ROOT, "benchmark", "streams",
                           "hevc_ra_1080p_qp32.265")    # phase 3
FILTER_STREAMS = (EDGE_STREAM,         # phase 3: every filtered picture
                  os.path.join(ROOT, "benchmark", "streams",
                               "hevc_main10_ra_2160p",
                               "hevc_ra_2160p10_qp32.265"))  # the first
POC_ORDER = {}      # stream -> POCs of its output order (phase 4)
NEED = {"edge_params": 0,   # due launches since `zero`: one a picture
        "loop_filters": 0}  # deblocked on the card; `filter_launches` a
#                             picture (or band) filtered there (phases 4-9)
FRAME_BYTES = {}    # stream -> bytes of one cropped output frame (phase 4)
PHASE4_FPS = {}     # stream -> decode fps of its phase-4 decode


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name = value inside the block (a route forced for a phase)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def zero(counters):
    """Every launch counter of `counters` and NEED to 0, before a decode
    whose launches a phase counts."""
    for f in counters.values():
        f.launches = 0
    for n in NEED:
        NEED[n] = 0


def due(counters):
    """The due launches (NEED) of the watched kernels that `counters`
    holds: the edge-parameter kernel's (`edge_watch`) and the in-loop
    filters' (`filter_watch`)."""
    return {n: NEED[n] for n in NEED if n in counters}


def read(counters):
    """At one moment: the launches of each counter of `counters` since
    `zero`, and the due launches of the watched kernels it holds
    (`due`)."""
    return {n: f.launches for n, f in counters.items()}, due(counters)


@contextlib.contextmanager
def edge_watch():
    """Inside the block, every `TorchEngine.prepare` of a whole picture
    (not a tile shard) that is deblocked and filtered on the device (not
    the host-filter route), and every such member that a mesh's tile
    axis combines and filters, makes ONE `edge_params` launch, and every
    other prepare none; each such picture adds 1 to NEED. A picture
    that breaks the rule raises."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.filters import edge_params
    from openhevc_tpu_torch.parallel.mesh import MeshFrameDecoder
    prepare = TorchEngine.prepare
    combine = MeshFrameDecoder._combine_and_filter

    def check(fs, before, need, where):
        got = edge_params.launches - before
        if got != need:
            raise AssertionError(f"{where} of POC {fs.poc} (deblocking "
                                 f"{'off' if fs.deblock_disabled else 'on'})"
                                 f": {got} edge_params launches, not {need}")
        NEED["edge_params"] += need

    def watched_prepare(self, fs, ref_planes=None, shard=None):
        before = edge_params.launches
        k = prepare(self, fs, ref_planes, shard)
        check(fs, before, int(shard is None and not fs.deblock_disabled and
                              on_device(k)), "prepare")
        return k

    def watched_combine(self, fs, gmap, ks, devices):
        before = edge_params.launches
        out = combine(self, fs, gmap, ks, devices)
        check(fs, before, int(not fs.deblock_disabled and
                              out.device_filtered), "the tile axis' filters")
        return out

    with patched(TorchEngine, "prepare", watched_prepare), \
            patched(MeshFrameDecoder, "_combine_and_filter",
                    watched_combine):
        yield


def on_device(k):
    """Whether `TorchEngine.prepare`'s picture k is filtered on the device
    (its filter plan's device route)."""
    return k["filters"] is not None and k["filters"].route == "device"


def filter_launches(fs):
    """The launches of csrc/loop_filters.cu that one filtering of the
    picture makes: two for deblocking (vertical, horizontal edges), one
    for SAO."""
    sps = fs.sps
    return 2 * int(not fs.deblock_disabled) + \
        int(bool(sps.sao_enabled and (fs.sao_luma or fs.sao_chroma)))


@contextlib.contextmanager
def filter_watch():
    """Inside the block, every `TorchEngine.finish` that filters its
    picture on the device makes exactly `filter_launches` launches of the
    in-loop filters' kernels (at most 3), every other finish none, and
    every member a mesh's tile axis filters makes that many for each band
    (`parallel/mesh.py` `band_filters`); each such picture adds its
    launches to NEED. A picture that breaks the rule raises."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.filters import apply_filters_device as f
    from openhevc_tpu_torch.parallel.mesh import MeshFrameDecoder
    finish = TorchEngine.finish
    combine = MeshFrameDecoder._combine_and_filter

    def check(fs, before, calls, where):
        need = calls * filter_launches(fs)
        got = f.launches - before
        if got != need:
            raise AssertionError(f"{where} of POC {fs.poc}: {got} launches "
                                 f"of the in-loop filters, not {need}")
        NEED["loop_filters"] += need

    def watched_finish(self, fs, k):
        before = f.launches
        out = finish(self, fs, k)
        check(fs, before, int(on_device(k)), "finish")
        return out

    def watched_combine(self, fs, gmap, ks, devices):
        before = f.launches
        out = combine(self, fs, gmap, ks, devices)
        rb = -(-fs.sps.ctbs_h // len(devices))
        bands = sum(g * rb < fs.sps.ctbs_h for g in range(len(devices)))
        check(fs, before, bands * out.device_filtered,
              "the tile axis' filters")
        return out

    with patched(TorchEngine, "finish", watched_finish), \
            patched(MeshFrameDecoder, "_combine_and_filter",
                    watched_combine):
        yield


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
        sync()
        times.append(_elapsed_ms(lambda: _run_kernel(k, banded,
                                                     planes=bufs)))
    return sum(times) / len(times)


def _bound_ms(fs, k):
    """Least time for the work on this card, from bytes: the jobs' meta
    and order (64 + 4 B a job), the level bounds, the residual of the
    jobs' samples read once and their reconstruction written once (8 B a
    sample: all of an all-intra frame, the intra TUs of an inter
    picture; the jobs are the n of k's meta: a tile shard's are its
    group's), and the PCM samples prefilled into the starting planes
    (the kernel reads no other sample of those planes that it has not
    written itself, bar the neighbours of intra TUs beside inter blocks,
    which are not counted)."""
    pcm = sum(p.size * p.size + 2 * (p.size >> fs.sps.vshift1)
              * (p.size >> fs.sps.hshift1) for p in fs.pcm_blocks)
    size = 4 << k["meta"][2, :k["n"]].long()
    nbytes = (16 + 1) * 4 * k["n"] + 4 * k["level_bounds"].numel() + \
        2 * 4 * int((size * size).sum()) + 4 * pcm
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
        sync()
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
    serial_ms, grid = check_whole_frame("i_main_832x480", fs, k, False)
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


def check_banded_444(fs, reps=REPS):
    """Phase 3 on frame 0 of rext_444 (4:4:4: chroma bands as tall as
    luma bands, chroma TUs up to 32x32 with the smoothing filter): the
    banded kernel == its plain version on the whole frame, and == the
    serial-order entry over and over. Returns a dict of what was
    measured."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_banded_ref
    k = TorchEngine("cuda").prepare(fs)
    if k["bounds"] is None or k["vs"] != 0 or k["hs"] != 0:
        raise AssertionError("rext_444 frame 0: not a banded 4:4:4 plan")
    m = k["meta"][:, :k["n"]]
    big_chroma = int(((m[4] > 0) & (m[2] == 3)).sum())
    filtered_chroma = int(((m[4] > 0) & (m[5] != 0)).sum())
    if not filtered_chroma:
        raise AssertionError("rext_444 frame 0: no chroma TU takes the "
                             "smoothing filter")
    out_k = _run_kernel(k, True)
    out_p = [k["luma"].clone(), k["chroma"].clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_banded_ref(
        k["meta"], k["bounds"], k["n"], *out_p, k["res_l"], k["res_c"],
        k["bd"]))
    err = _max_err(out_k, out_p)
    if err != 0:
        raise AssertionError(f"intra_fused_banded on 4:4:4 meta differs "
                             f"from its plain version by up to {err}")
    serial_ms, grid = check_whole_frame("rext_444_832x480", fs, k, True)
    n_levels = fs.native_raw["n_levels"]
    ms = _kernel_ms(k, True, reps)
    return {"jobs": k["n"], "n_levels": n_levels,
            "bands": len(k["bounds"]) - 1, "chroma_32x32_jobs": big_chroma,
            "filtered_chroma_jobs": filtered_chroma, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "serial_ms": serial_ms,
            "bound_ms": _bound_ms(fs, k), "us_per_level": ms * 1e3 / n_levels,
            "grid": grid}


def check_upsample(pic, W, H, bd, reps=REPS):
    """The inter-layer upsample (torch ops) of a decoded base-layer
    picture `pic` (4:2:0, on its device) to W x H == a straightforward
    evaluation of the tap plans (every output sample's taps gathered and
    summed in int64). Returns a dict with its time on a card (CUDA
    events, mean of reps; None on the CPU) and byte bound (the
    base-layer picture read once, the upsampled one written once, at the
    picture's sample size)."""
    from openhevc_tpu_torch.models.pipeline import _slice_plane
    from openhevc_tpu_torch.ops import upsample as up
    planes = [_slice_plane(pic.planes._dev, c, *pic.planes._dims)
              for c in range(3)]
    got = up.upsample_il_frame_dev(planes, W, H, bit_depth=bd)
    err = 0
    for c, (src, g) in enumerate(zip(planes, got)):
        bh, bw = src.shape
        eh, ew = (H, W) if c == 0 else (H >> 1, W >> 1)
        hidx, hcoef, vidx, vcoef = up._plans(bw, bh, ew, eh, c == 0,
                                             src.device)
        # acc[j, i] = sum_a sum_b vcoef[a, j] hcoef[b, i] src[vidx[a, j],
        # hidx[b, i]]
        taps = src.long()[vidx.T[:, None, :, None], hidx.T[None, :, None, :]]
        acc = (taps * vcoef[:, :, 0].T.long()[:, None, :, None]
               * hcoef.T.long()[None, :, None, :]).sum((2, 3))
        want = ((acc + (1 << 11)) >> 12).clamp(0, (1 << bd) - 1)
        del taps, acc
        if g.shape != (eh, ew):
            raise AssertionError(f"upsample plane {c}: shape {g.shape}")
        err = max(err, int((g.long() - want).abs().max()))
    if err != 0:
        raise AssertionError(f"upsample differs from the per-sample "
                             f"evaluation of its tap plan by up to {err}")
    ms = None
    if planes[0].device.type == "cuda":
        sync()
        ms = sum(_elapsed_ms(lambda: up.upsample_il_frame_dev(
            planes, W, H, bit_depth=bd)) for _ in range(reps)) / reps
    sample = 1 if bd <= 8 else 2
    px_bl = sum(p.numel() for p in planes)
    px_el = sum(g.numel() for g in got)
    return {"bl": list(planes[0].shape[::-1]), "el": [W, H],
            "max_abs_err": err, "ms": ms,
            "bound_ms": (px_bl + px_el) * sample / HBM_BYTES_PER_S * 1e3}


def check_shvc_2layer_upsample(reps=REPS):
    """Phase 3 for the inter-layer upsample: the first base-layer picture
    of shvc_2layer, decoded on the card, upsampled to the enhancement
    layer's size (`check_upsample`)."""
    from openhevc_tpu_torch.decoder import Decoder
    data = first_frames(load_stream("shvc_2layer_832x480")[0], 2)
    bl = Decoder(device="cuda")
    pic = (bl.decode(data) + bl.flush())[0]
    el_sps = next(s for s in bl.sps.values()
                  if (s.width, s.height) != (pic.sps.width, pic.sps.height))
    return check_upsample(pic, el_sps.width, el_sps.height,
                          el_sps.bit_depth, reps)


def inter_picture(name):
    """(fs, refs) of the stream's first picture in decode order with both
    inter blocks and intra jobs; refs hold the decoded references on the
    card."""
    dec = smoke_decoder(keep=lambda fs: bool(fs.inter_pbs) and
                        len(fs.native_raw["ij_meta"]) > 0)
    dec.decode(load_stream(name)[0])
    dec.flush()
    if not dec.kept:
        raise AssertionError(f"{name}: no picture with inter blocks and "
                             f"intra jobs")
    return dec.kept[0]


def check_banded_on_prefill(fs, refs, reps=REPS):
    """Phase 3 on an inter picture: the banded kernel on the real inter
    prefill (a sparse job list) == its plain version == the serial-order
    entry; with n == 0 (what an all-inter picture passes) the wrapper
    launches nothing and leaves the prefill alone. Returns a dict of
    what was measured."""
    import torch
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused_banded,
                                                    intra_fused_banded_ref)
    k = TorchEngine("cuda").prepare(fs, refs)
    if k["bounds"] is None or not bool(k["luma"].any()):
        raise AssertionError("1080p inter picture: whole-frame plan or an "
                             "empty prefill")
    out_k = _run_kernel(k, True)
    out_p = [k["luma"].clone(), k["chroma"].clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_banded_ref(
        k["meta"], k["bounds"], k["n"], *out_p, k["res_l"], k["res_c"],
        k["bd"]))
    err = max(_max_err(out_k, out_p), _max_err(out_k, _run_serial(k)))
    if err != 0:
        raise AssertionError(f"intra_fused_banded on an inter prefill "
                             f"differs from its plain version or the "
                             f"serial-order entry by up to {err}")
    # n == 0: no launch, planes untouched
    before = intra_fused_banded.launches
    empty = (torch.zeros(0, dtype=torch.int32, device="cuda"),
             torch.zeros(1, dtype=torch.int32, device="cuda"))
    for fn in (intra_fused_banded, intra_fused_banded_ref):
        out = [k["luma"].clone(), k["chroma"].clone()]
        fn(k["meta"], torch.zeros_like(k["bounds"]), 0, *out, k["res_l"],
           k["res_c"], k["bd"], *empty)
        sync()
        if intra_fused_banded.launches != before or \
                _max_err(out, [k["luma"], k["chroma"]]) != 0:
            raise AssertionError("n == 0 launched the banded kernel or "
                                 "changed the prefill")
    size = fs.native_raw["ij_meta"][:, 3].astype("int64")
    H, W, Hc, Wc = k["dims"]
    return {"poc": fs.poc, "jobs": k["n"],
            "n_levels": fs.native_raw["n_levels"], "max_abs_err": err,
            "intra_share": float((size * size).sum()) /
            (H * W + 2 * Hc * Wc),
            "ms": _kernel_ms(k, True, reps), "plain_ms": plain_ms,
            "bound_ms": _bound_ms(fs, k)}


def check_mc_modes(name, fs, refs, device="cuda", phase="phase3"):
    """Phase 3: the inter prefill of one picture in the MC's pair mode
    and in its tap mode must be identical. Both are timed in turns
    (pair, tap, tap, pair; a first untimed pair run warms up): stage 1
    with an empty cache (ms a reference, all three planes) and stage 2 +
    combine with every reference cached (ms a picture)."""
    import torch
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    times = {True: [], False: []}
    want = None
    for i, pairs in enumerate((True, True, False, False, True)):
        eng = TorchEngine(device, sync_timers=True)
        eng.MC_PAIRS_MAX_PIXELS = 1 << 62 if pairs else 0
        k = eng.prepare(fs, refs)
        cache = eng._stage1[pairs]
        first = dict(eng.stage_ms)
        eng.stage_ms.clear()
        eng.prepare(fs, refs)
        if cache.hits != cache.misses or not cache.misses:
            raise AssertionError(f"{name}: stage-1 cache {cache.hits} hits, "
                                 f"{cache.misses} misses")
        got = (k["luma"], k["chroma"])
        if want is None:
            want = got
        elif not (torch.equal(got[0], want[0]) and
                  torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: tap mode differs from pair mode "
                                 f"by up to {_max_err(got, want)}")
        if i:
            times[pairs].append(
                (first["mc_stage1"] / cache.misses,
                 eng.stage_ms["mc_stage2"], eng.stage_ms["combine"],
                 cache.nbytes() / cache.misses, cache.misses))
        del eng, k, cache
    out = {}
    for pairs, rows in times.items():
        label = "pair" if pairs else "tap"
        out[label] = {
            "stage1_ms_per_reference": sum(r[0] for r in rows) / len(rows),
            "stage2_ms_per_picture": sum(r[1] for r in rows) / len(rows),
            "combine_ms_per_picture": sum(r[2] for r in rows) / len(rows),
            "stage1_bytes_per_reference": rows[0][3],
            "references": rows[0][4]}
    print(f"{phase} {name} POC {fs.poc}: MC pair mode == tap mode (prefill "
          f"max_abs_err 0); {json.dumps(out)}", flush=True)
    return out


def check_edge_params(reps=REPS):
    """Phase 3 for the edge-parameter kernel (csrc/edge_params.cu): on
    the first inter picture of the benchmark's 1080p stream (EDGE_STREAM),
    the kernel == its plain version on the card == its plain version on a
    CPU copy of the grids; the kernel timed with CUDA events around one
    launch (mean of reps; the wrapper's host time between the events
    included) and by the profiler's device time, the plain version with
    CUDA events, beside the byte bound (the grids read once, the eight
    arrays written once)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openhevc_tpu_torch.ops.filters import (edge_inputs, edge_params,
                                                edge_params_ref)
    with open(EDGE_STREAM, "rb") as f:
        fs = parse_only(first_frames(f.read(), 2))[1]
    if not fs.inter_pbs or fs.deblock_disabled:
        raise AssertionError("the second picture of the 1080p stream is "
                             "not a deblocked inter picture")
    grids, kw = edge_inputs(fs)
    grids = list(grids.values())
    args = [torch.from_numpy(np.array(a)).cuda() for a in grids]
    got = edge_params(*args, **kw)
    plain = edge_params_ref(*args, **kw)
    cpu = edge_params_ref(*(a.cpu() for a in args), **kw)
    err = max(max(int((a.int() - b.int()).abs().max()),
                  int((a.cpu().int() - c.int()).abs().max()))
              for a, b, c in zip(got, plain, cpu))
    if err != 0:
        raise AssertionError(f"edge_params differs from the plain version "
                             f"on the card or on the CPU by up to {err}")
    sync()
    ms = sum(_elapsed_ms(lambda: edge_params(*args, **kw))
             for _ in range(reps)) / reps
    plain_ms = sum(_elapsed_ms(lambda: edge_params_ref(*args, **kw))
                   for _ in range(reps)) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            edge_params(*args, **kw)
        sync()
    dev_us = [getattr(e, "device_time_total", None) or e.cuda_time_total
              for e in prof.key_averages() if "edge_params_kernel" in e.key]
    H, W = kw["H"], kw["W"]
    per_block = sum(a.nbytes // grids[0].size
                    for a in grids[:5] + grids[6:])
    read = (H >> 2) * (W >> 2) * per_block + grids[5].nbytes
    written = sum(a.numel() * a.element_size() for a in got)
    return {"name": "edge_params", "route": "cuda",
            "source": "openhevc_tpu_torch/csrc/edge_params.cu",
            "replaces": "none: numpy on the host (openhevc_tpu/ops/"
                        "filters_jax.py prep_filters)",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "device_us": dev_us[0] / reps if dev_us else None,
            "bytes": read + written, "poc": fs.poc,
            "segments": sum(a.numel() for a in got) // 2}


def check_loop_filters(reps=REPS):
    """Phase 3 for the in-loop filters' kernels (csrc/loop_filters.cu):
    every picture of the benchmark's 1080p stream and the first of its
    4K 10-bit stream decoded on the card, each `apply_filters_device`
    call held to `apply_filters_ref` on the card on the same arguments
    and to `filter_launches`, the 1080p decode md5-exact; then, on the
    first inter picture of the 1080p stream and the 4K picture, the
    kernels timed with CUDA events around one call (mean of reps; the
    wrapper's host time between the events included; the launch counter
    read over those calls) and by the profiler's device time, the plain
    version with CUDA events, beside the byte bound: the function's least
    (the planes read once and written once, the control arrays read
    once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import filters
    from openhevc_tpu_torch.ops.filters import (apply_filters_device,
                                                apply_filters_ref)
    kept, err, calls = {}, 0, []
    path = keep = None
    real = filters.apply_filters_device

    def spy(*args, **kw):
        nonlocal err
        before = apply_filters_device.launches
        got = real(*args, **kw)
        n = apply_filters_device.launches - before
        if n != 2 * kw["do_deblock"] + kw["do_sao"]:
            raise AssertionError(f"{n} launches of the in-loop filters")
        plain = apply_filters_ref(*args, **dict(kw, stage=contextlib
                                                .nullcontext))
        err = max(err, _max_err(got, plain))
        calls.append(n)
        if len(calls) == keep:
            kept[path] = ([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args],
                          dict(kw, stage=contextlib.nullcontext))
        return got

    pictures = {}
    for path, cut, keep in ((FILTER_STREAMS[0], None, 2),
                            (FILTER_STREAMS[1], 1, 1)):
        with open(path, "rb") as f:
            data = f.read()
        if cut:
            data = first_frames(data, cut)
        calls.clear()
        with patched(filters, "apply_filters_device", spy):
            dec = Decoder(device="cuda")
            pics = dec.decode(data) + dec.flush()
        if not cut:
            with open(path + ".md5") as f:
                if hash_pics(pics) != f.read().split():
                    raise AssertionError(f"{path}: not md5-exact with the "
                                         f"in-loop filters' kernels")
        if len(calls) != len(pics) or path not in kept:
            raise AssertionError(f"{path}: {len(calls)} filtered of "
                                 f"{len(pics)} pictures")
        pictures[os.path.basename(path)] = list(calls)
    if err != 0:
        raise AssertionError(f"the in-loop filters' kernels differ from "
                             f"the plain version by up to {err}")
    sync()
    rows = {}
    for path, (args, kw) in kept.items():
        y, cb, cr = args[:3]
        before = apply_filters_device.launches
        ms = sum(_elapsed_ms(lambda: apply_filters_device(*args, **kw))
                 for _ in range(reps)) / reps
        launches = (apply_filters_device.launches - before) / reps
        plain_ms = sum(_elapsed_ms(lambda: apply_filters_ref(*args, **kw))
                       for _ in range(reps)) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                apply_filters_device(*args, **kw)
            sync()
        dev_us = {k: sum(getattr(e, "device_time_total", None) or
                         e.cuda_time_total for e in prof.key_averages()
                         if f"{k}_kernel" in e.key) / reps
                  for k in ("deblock", "sao")}
        plane = 4 * (y.numel() + cb.numel() + cr.numel())
        control = sum(a.numel() * a.element_size() for a in args[3:25])
        rows[os.path.basename(path)] = {
            "ms": ms, "plain_ms": plain_ms, "device_us": dev_us,
            "launches": launches, "size": f"{y.shape[1]}x{y.shape[0]}",
            "bound_ms": (2 * plane + control) / HBM_BYTES_PER_S * 1e3}
    return {"name": "loop_filters", "route": "cuda",
            "source": "openhevc_tpu_torch/csrc/loop_filters.cu",
            "replaces": "none: jnp ops (openhevc_tpu/ops/filters_jax.py "
                        "apply_filters_device)",
            "max_abs_err": err, "pictures": pictures, "timed": rows,
            "bound_by": "bytes (launch latency binds)", "library_ms": None}


def stage_bounds(sps, pairs):
    """Byte bounds (ms at HBM_BYTES_PER_S) of the torch-op stages of one
    picture: each stage's inputs read once and outputs written once.
    Stage 1 is per reference; the others per picture."""
    from openhevc_tpu_torch.ops.mc import stage1_shape
    H, W = sps.height, sps.width
    Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
    px = H * W + 2 * Hc * Wc
    sample = 1 if sps.bit_depth <= 8 else 2
    s1 = 0
    for h, w, lum in ((H, W, True), (Hc, Wc, False), (Hc, Wc, False)):
        n = 1
        for d in stage1_shape(h, w, lum, pairs):
            n *= d
        s1 += 2 * n
    taps = 1 if pairs else (8 * H * W + 4 * 2 * Hc * Wc) / px
    b = {"mc_stage1 (a reference)": px * sample + s1,
         # both lists: the gathered int16 samples in, two int32 puts out
         "mc_stage2": 2 * px * (2 * taps + 4),
         # two puts, the residual and the pred_flag grid in; prefill out
         "combine": px * 4 * 4,
         "deblock": px * 4 * 2, "sao": px * 4 * 2}
    return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in b.items()}


def main_path(name, counters):
    """Phase 4 on one stream: decode it with every launch counter set to
    0 just before; require its kernel exactly once per picture with an
    intra job, the other kernel and the serial-order entry never, the
    edge-parameter kernel once per picture deblocked on the card, the
    in-loop filters' kernels two launches for deblocking and one for SAO
    per picture filtered on the card (`filter_launches`), and every
    frame's md5 equal to the sidecar. Returns (number of frames, launch
    counts, decoder)."""
    data, want = load_stream(name)
    two = name in TWO_LAYERS
    decode_all(first_frames(data, 4 if two else 2), fetch=True,
               two_layers=two)                            # warm-up
    zero(counters)
    pics, dt, dec = decode_all(data, fetch=False, two_layers=two)
    launches, need = read(counters)
    got = hash_pics(pics)
    PHASE4_FPS[name] = len(pics) / dt
    POC_ORDER[name] = [p.poc for p in pics]
    FRAME_BYTES[name] = sum(c.nbytes for c in pics[0].cropped())
    n_ok = sum(g == w for g, w in zip(got, want))
    with_jobs = sum(n > 0 for d in layers(dec) for n in d.jobs)
    print(f"phase4 {name} md5 {n_ok}/{len(want)} frames equal the sidecar "
          f"({len(pics)} decoded, {with_jobs} pictures with intra jobs"
          f"{' in both layers' if two else ''}, "
          f"{need.get('edge_params')} deblocked on the card, "
          f"{need.get('loop_filters')} launches of the in-loop filters "
          f"due; launches {launches})", flush=True)
    if len(pics) != len(want) or n_ok != len(want):
        raise AssertionError(f"{name}: decoded frames differ from the "
                             f"reference md5 sidecar")
    for n, c in launches.items():
        if n in NEED:
            if c != need[n]:
                raise AssertionError(f"{name}: {n} launched {c} times, "
                                     f"{need[n]} due for the pictures "
                                     f"filtered on the card")
        elif n == KERNEL_OF[name] and (c != with_jobs or c == 0):
            raise AssertionError(f"{name}: kernel {n} launched {c} times "
                                 f"for {with_jobs} pictures with jobs")
        elif n != KERNEL_OF[name] and c != 0:
            raise AssertionError(f"{name}: {n} launched {c} times; this "
                                 f"stream's frames are {KERNEL_OF[name]}'s")
    return len(pics), launches, dec


def report(name, nf, dec):
    """Phase 5 on one stream: decode rates (outputs on the device and
    fetched to the host, alternating; every pass's frames are hashed
    after its clock stops and must equal the sidecar) and the stage
    breakdown (its decode md5-checked too), with the stage-1 cache's hit
    rate and the torch-op stages' byte bounds on inter streams."""
    data, want = load_stream(name)
    two = name in TWO_LAYERS
    for i in range(2):
        for label, fetch in (("device_resident", False),
                             ("fetched_to_host", True)):
            pics, dt, _ = decode_all(data, fetch=fetch, two_layers=two)
            if hash_pics(pics) != want:
                raise AssertionError(f"{name}: timed pass {label}[{i}] "
                                     f"differs from the md5 sidecar")
            print(f"{name} decode_fps_{label}[{i}] {nf / dt}")
    rows, timed, pics = breakdown(data, two)
    if hash_pics(pics) != want:
        raise AssertionError(f"{name}: the stage-timed decode differs from "
                             f"the md5 sidecar")
    for k, v in rows.items():
        print(f"{name} stage_ms_per_frame {k} {v}")
    for d in layers(timed):
        for pairs, cache in d._engine()._stage1.items():
            if not cache.misses:
                continue
            refs = (cache.hits + cache.misses) / sum(d.inter)
            print(f"{name} mc_stage1_cache {'pair' if pairs else 'tap'} "
                  f"mode: {cache.hits} hits, {cache.misses} misses (hit "
                  f"rate {cache.hits / (cache.hits + cache.misses)}), "
                  f"{refs} references a picture, "
                  f"{cache.bufs[0].shape[0]} slots, {cache.nbytes()} B")
            for k, v in stage_bounds(pics[0].sps, pairs).items():
                print(f"{name} stage_bound_ms {k} {v}")
    if two:
        # the base-layer picture read once, the upsampled one written once
        bl_sps = next(iter(timed.bl.ref_pics.values())).sps
        nbytes = sum(3 * s.width * s.height // 2 *
                     (1 if s.bit_depth <= 8 else 2)
                     for s in (bl_sps, pics[0].sps))
        print(f"{name} stage_bound_ms upsample "
              f"{nbytes / HBM_BYTES_PER_S * 1e3}")
    print(f"{name} native_slices "
          f"{sum(d.stats['native_slices'] for d in layers(dec))}",
          flush=True)


# ---- phase 5: the routes off the main path ----------------------------------

def route_decode(name, data, counters, kernel, label, **kw):
    """Decode `data` (stream `name`, or its first pictures) on one route
    with every launch counter set to 0 just before; require every
    picture's md5 to equal the sidecar's (matched by POC where the
    stream's POCs are unique, else, with an IDR a frame, in output
    order: a cut of such a stream is a prefix of its output), and
    `kernel` to have launched once per picture with an intra job, the
    edge-parameter kernel once per picture deblocked on the card, the
    in-loop filters' kernels as `filter_launches` says, and no other
    kernel at all. kw goes to decode_all. Returns (pictures,
    seconds, decoder, launches)."""
    order, want = POC_ORDER[name], load_stream(name)[1]
    zero(counters)
    pics, dt, dec = decode_all(data, fetch=False, **kw)
    launches, edges = read(counters)
    got = hash_pics(pics)
    if len(set(order)) == len(order):
        by_poc = dict(zip(order, want))
        want = [by_poc.get(p.poc) for p in pics]
    n_ok = sum(g == w for g, w in zip(got, want))
    with_jobs = sum(n > 0 for n in dec.jobs)
    print(f"phase5 {label}: {name} md5 {n_ok}/{len(pics)} pictures equal "
          f"the sidecar (POCs {[p.poc for p in pics]}, {with_jobs} with "
          f"intra jobs; launches {launches})", flush=True)
    if not pics or n_ok != len(pics):
        raise AssertionError(f"{label}: {name} differs from the md5 sidecar")
    need = {n: with_jobs if n == kernel else 0
            for n in counters if n not in NEED} | edges
    if launches != need or with_jobs == 0:
        raise AssertionError(f"{label}: {name} launched {launches}, not "
                             f"{need}")
    return pics, dt, dec, launches


def check_no_band_plan(counters, banded_4k_ms, reps=REPS):
    """Phase 5 (i): with `band_plan` unavailable (the route of 4:2:2 UHD
    at CTB 64, 4:4:4 from 2440 wide and 8K 4:2:0), all of main10_4k and
    the first RA_4K_PICTURES of ra_main10_4k (inter + filters at 4K)
    take the whole-frame kernel on global-memory planes, md5-exact; the
    kernel is timed on 4K frame 0 in this layout (meta in decode order)
    beside the banded kernel on the same frame."""
    from openhevc_tpu_torch.models import pipeline
    out = {"launches": {}, "edge_launches": {}, "filter_launches": {}}
    with patched(pipeline, "band_plan", lambda *a: None):
        for name, k in (("main10_4k", None),
                        ("ra_main10_4k", RA_4K_PICTURES)):
            data = load_stream(name)[0]
            if k is not None:
                data = first_frames(data, k)
            pics, dt, _d, launches = route_decode(
                name, data, counters, "intra_fused", "no band plan")
            if k is None and len(pics) != len(POC_ORDER[name]):
                raise AssertionError(f"no band plan: {name} decoded "
                                     f"{len(pics)} frames")
            out["launches"][name] = launches["intra_fused"]
            out["edge_launches"][name] = launches["edge_params"]
            out["filter_launches"][name] = launches["loop_filters"]
            out[f"{name}_decode_fps"] = len(pics) / dt
        fs = parse_only(first_frames(load_stream("main10_4k")[0], 1))[0]
        k = pipeline.TorchEngine("cuda").prepare(fs)
    if k["bounds"] is not None:
        raise AssertionError("no band plan: 4K frame 0 planned banded")
    ms = _kernel_ms(k, False, reps)
    out.update(ms=ms, bound_ms=_bound_ms(fs, k), banded_ms=banded_4k_ms,
               jobs=k["n"], planes=[list(k["luma"].shape),
                                    list(k["chroma"].shape)])
    print(f"phase5 no band plan: intra_fused {ms} ms on main10_4k frame 0 "
          f"in the whole-frame layout ({k['n']} jobs, planes "
          f"{out['planes']}); intra_fused_banded {banded_4k_ms} ms on the "
          f"same frame (phase 3)", flush=True)
    return out


def python_parse_ms(data):
    """ms the Python parser takes on each picture of `data`, in decode
    order, with no reconstruction: the clock between one picture's
    hand-over and the next's. Returns [(POC, ms), ...]."""
    from openhevc_tpu_torch.decoder import Decoder

    class _Timed(Decoder):
        def _reconstruct(self, fs, refs):
            self.stamps.append((fs.poc, time.perf_counter()))

    d = _Timed(device="cuda", native_parse=False)
    d.stamps = []
    t0 = time.perf_counter()
    d.decode(data)
    d.flush()
    starts = [t0] + [t for _poc, t in d.stamps]
    return [(poc, (t - t_start) * 1e3)
            for (poc, t), t_start in zip(d.stamps, starts)]


def check_python_parser(counters):
    """Phase 5 (ii): the first pictures of i_main and of ra_tiles_1080p
    through `Decoder(native_parse=False)`: every slice parsed in Python,
    the levels computed from its objects, one launch a picture with
    intra jobs (whole-frame on i_main, banded on ra_tiles_1080p), and
    md5-exact. The first pictures' parse is timed first and sets how
    many fit PY_PARSE_SECONDS; on ra_tiles_1080p those are POC 0 and
    POC 8, its first inter picture, whose merge and AMVP candidates
    must not come from another tile."""
    out = {}
    for name, kernel, label, timed in (
            ("i_main_832x480", "intra_fused", "python parser", 1),
            ("ra_tiles_1080p", "intra_fused_banded",
             "python parser, tiled inter", 2)):
        data, want = load_stream(name)
        parse_ms = python_parse_ms(first_frames(data, timed))
        mean_ms = sum(ms for _poc, ms in parse_ms) / timed
        n = max(2, min(len(want), int(PY_PARSE_SECONDS * 1e3 / mean_ms)))
        pics, dt, dec, launches = route_decode(
            name, first_frames(data, n), counters, kernel, label,
            native_parse=False)
        if dec.stats["python_slices"] != n or dec.stats["native_slices"]:
            raise AssertionError(f"{label}: {name} {dec.stats}")
        if len(pics) != n or {poc for poc, _ms in parse_ms} - \
                {p.poc for p in pics}:
            raise AssertionError(f"{label}: {name} decoded POCs "
                                 f"{[p.poc for p in pics]}")
        out[name] = {"pictures": n, "parse_ms": parse_ms,
                     "decode_ms_per_picture": dt * 1e3 / n,
                     "launches": launches[kernel],
                     "edge_launches": launches["edge_params"],
                     "filter_launches": launches["loop_filters"]}
    return out


def check_host_filters(counters):
    """Phase 5 (iii): the first HOST_FILTER_PICTURES of ra_tiles_1080p
    with `prep_filters` giving up on every picture: each is fetched
    unfiltered, filtered on the host on the reference's CTB schedule and
    read back as a reference from there, md5-exact; the stages are
    timed."""
    from openhevc_tpu_torch.ops import filters
    data = first_frames(load_stream("ra_tiles_1080p")[0],
                        HOST_FILTER_PICTURES)
    with patched(filters, "prep_filters", lambda fs: None):
        pics, _dt, dec, launches = route_decode(
            "ra_tiles_1080p", data, counters, "intra_fused_banded",
            "host filters", sync_timers=True)
    st = dec._engine().stage_ms
    if "host_filters" not in st or "deblock" in st or \
            any(p.planes.device_filtered for p in pics):
        raise AssertionError(f"host filters: stages {sorted(st)}")
    return {"pictures": len(pics),
            "stage_ms_per_picture": {k: v / len(pics)
                                     for k, v in st.items()},
            "launches": launches["intra_fused_banded"],
            "edge_launches": launches["edge_params"],
            "filter_launches": launches["loop_filters"]}


def check_cli():
    """Phase 5 (iv): `python3 -m openhevc_tpu_torch -i <stream> -o
    <yuv> -n` on the card, on i_main as Annex-B and as an MP4 written by
    the port's `container.mux_mp4`; every frame of the .yuv must hash to
    the sidecar's md5."""
    from openhevc_tpu_torch.bitstream.au_parser import AuParser
    from openhevc_tpu_torch.container import mux_mp4
    from openhevc_tpu_torch.container.mp4 import (annexb_to_length_prefixed,
                                                  make_hvcc)
    from openhevc_tpu_torch.decoder import split_nals
    data, want = load_stream("i_main_832x480")
    sps = parse_only(first_frames(data, 1))[0].sps
    p = AuParser()
    aus = p.feed(data) + p.flush()
    ps = {t: n for n in split_nals(aus[0])
          if (t := (n[0] >> 1) & 0x3F) in (32, 33, 34)}
    mp4 = mux_mp4([annexb_to_length_prefixed(au) for au in aus],
                  make_hvcc(ps[32], ps[33], ps[34]), sps.width, sps.height)
    fb = FRAME_BYTES["i_main_832x480"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, blob in (("265", data), ("mp4", mp4)):
            src = os.path.join(tmp, f"in.{label}")
            yuv = os.path.join(tmp, f"out_{label}.yuv")
            with open(src, "wb") as f:
                f.write(blob)
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "openhevc_tpu_torch",
                                "-i", src, "-o", yuv, "-n"], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=600)
            secs = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"CLI on .{label} exited "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
            raw = open(yuv, "rb").read()
            got = [hashlib.md5(raw[i:i + fb]).hexdigest()
                   for i in range(0, len(raw), fb)]
            n_ok = sum(g == w for g, w in zip(got, want))
            print(f"phase5 CLI .{label}: md5 {n_ok}/{len(want)} frames of "
                  f"the .yuv equal the sidecar ({secs} s for the process; "
                  f"{r.stdout.strip()})", flush=True)
            if len(got) != len(want) or n_ok != len(want):
                raise AssertionError(f"CLI on .{label}: the .yuv differs "
                                     f"from the md5 sidecar")
            out[label] = {"frames": n_ok, "process_seconds": secs}
    return out


# ---- phase 6: picture waves over a device mesh -------------------------------

def wave_meshes():
    """(frame-axis mesh, 2-D mesh) from the cards present, each card
    repeated in turn to the WAVE_FRAMES / WAVE_GRID entries asked for."""
    import torch
    from openhevc_tpu_torch.parallel import DeviceMesh
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    nf, nt = WAVE_GRID
    flat = [cards[i % len(cards)] for i in range(max(WAVE_FRAMES, nf * nt))]
    frame = DeviceMesh(flat[:WAVE_FRAMES], ("frame",))
    grid = DeviceMesh([flat[i * nt:(i + 1) * nt] for i in range(nf)],
                      ("frame", "tile"))
    print(f"phase6 meshes from {len(cards)} card(s): frame axis {frame}, "
          f"2-D {grid} (each card repeated "
          f"{-(-len(flat) // len(cards))} times)", flush=True)
    return frame, grid


def groups_with_jobs(fs, n_tile):
    """Tile groups (tile id % n_tile, from the picture's tile maps) that
    hold an intra job of the parsed picture: one kernel launch each."""
    import numpy as np
    from openhevc_tpu_torch.bitstream.ps import ctb_tile_maps
    im, sps = fs.native_raw["ij_meta"], fs.sps
    if not len(im):
        return set()
    tile_id = ctb_tile_maps(fs.pps, sps)[2] if fs.pps.tiles_enabled else \
        np.zeros((sps.ctbs_h, sps.ctbs_w), np.int32)
    chroma = im[:, 0] > 0
    lx = np.where(chroma, im[:, 1] << sps.hshift1, im[:, 1])
    ly = np.where(chroma, im[:, 2] << sps.vshift1, im[:, 2])
    return set((tile_id[ly >> sps.log2_ctb, lx >> sps.log2_ctb] % n_tile)
               .tolist())


def wave_decode(name, mesh, counters):
    """Phase 6 on one stream: decode it through the port's entry point
    with `mesh` (`ShvcDecoder` for two layers), every launch counter at 0
    just before; every frame md5-exact; launches of the stream's kernel
    equal to the prediction from the parse (frame axis: one a wave
    member with intra jobs; tile axis: one a tile shard whose group
    holds jobs), of the edge-parameter kernel one a picture deblocked on
    the card, of the in-loop filters' kernels as `filter_launches` says
    (per band on the tile axis), of the other kernels 0. Then one decode on one device
    and one more with the mesh, in turns with the first (host speed
    drifts within a call), each md5-checked. Returns a dict of what was
    seen (waves, launches, fps with the mesh and on one device)."""
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    from openhevc_tpu_torch.parallel import MeshFrameDecoder
    data, want = load_stream(name)
    two = name in TWO_LAYERS
    n_tile = int(mesh.shape.get("tile", 1))
    waves = []
    orig = MeshFrameDecoder.reconstruct_wave

    def spy(self, fs_list, refs_list=None):
        waves.append([(fs.poc, bool(fs.inter_pbs),
                       len(groups_with_jobs(fs, n_tile)) if n_tile > 1
                       else int(n_jobs(fs) > 0)) for fs in fs_list])
        return orig(self, fs_list, refs_list)

    def decode(blob, m=mesh):
        kw = dict(mesh=m) if m is not None else dict(device="cuda")
        dec = ShvcDecoder(**kw) if two else Decoder(**kw)
        sync()
        t0 = time.perf_counter()
        pics = dec.decode(blob) + dec.flush()
        sync()
        return pics, time.perf_counter() - t0

    with patched(MeshFrameDecoder, "reconstruct_wave", spy):
        decode(first_frames(data, 4 if two else 2))            # warm-up
        waves.clear()
        zero(counters)
        pics, dt = decode(data)
        launches, edges = read(counters)
    got = hash_pics(pics)
    times = {"wave": [dt], "one": []}
    for label, m in (("one", None), ("wave", mesh)):
        p, t = decode(data, m)
        if hash_pics(p) != want:
            raise AssertionError(f"waves: {name}, timed pass {label} "
                                 f"differs from the md5 sidecar")
        times[label].append(t)
    n_ok = sum(g == w for g, w in zip(got, want))
    predicted = sum(m[2] for w in waves for m in w)
    hist = {}
    for w in waves:
        key = f"{'inter' if any(m[1] for m in w) else 'intra'}_{len(w)}"
        hist[key] = hist.get(key, 0) + 1
    axis = "tile axis" if n_tile > 1 else "frame axis"
    out = {"frames": len(pics), "md5_ok": n_ok, "launches": launches,
           "predicted": predicted, "waves": len(waves),
           "wave_sizes": dict(sorted(hist.items())),
           "fps": len(pics) * len(times["wave"]) / sum(times["wave"]),
           "one_device_fps": len(pics) / times["one"][0],
           "phase4_fps": PHASE4_FPS[name],
           "pocs": [[m[0] for m in w] for w in waves]}
    print(f"phase6 {axis} {name}: md5 {n_ok}/{len(want)} frames equal the "
          f"sidecar ({len(pics)} decoded in {len(waves)} waves, sizes "
          f"{json.dumps(out['wave_sizes'])}; launches {launches}, "
          f"predicted {predicted} {KERNEL_OF[name]}); decode fps on the "
          f"device {out['fps']} (mean of 2 passes; one device, between "
          f"them: {out['one_device_fps']}; phase 4: {out['phase4_fps']})",
          flush=True)
    if len(pics) != len(want) or n_ok != len(want):
        raise AssertionError(f"waves, {axis}: {name} differs from the md5 "
                             f"sidecar")
    need = {n: predicted if n == KERNEL_OF[name] else 0
            for n in counters if n not in NEED} | edges
    if launches != need or predicted == 0:
        raise AssertionError(f"waves, {axis}: {name} launched {launches}, "
                             f"predicted {need}")
    return out


def check_tile_shard(reps=REPS):
    """Phase 6: the banded kernel on tile shard 0 (of WAVE_GRID[1]) of
    ra_tiles_1080p frame 0: the group's jobs with their levels
    renumbered densely == the plain version on the shard's first
    PLAIN_BANDS bands == the serial-order entry on the whole shard,
    timed beside the kernel on the whole frame. Returns the record."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_banded_ref
    from openhevc_tpu_torch.parallel.mesh import tile_group_map
    fs = parse_only(first_frames(load_stream("ra_tiles_1080p")[0], 1))[0]
    n_tile = WAVE_GRID[1]
    gmap = tile_group_map(fs, n_tile)
    k = TorchEngine("cuda").prepare(fs, shard=(gmap, 0))
    if k["bounds"] is None or not 0 < k["n"] < n_jobs(fs):
        raise AssertionError(f"ra_tiles_1080p frame 0, tile shard 0: "
                             f"{k['n']} of {n_jobs(fs)} jobs, bounds "
                             f"{k['bounds']}")
    head = _head(k, PLAIN_BANDS)
    out_k = _run_kernel(k, True, head=head)
    out_p = [k["luma"].clone(), k["chroma"].clone()]
    plain_ms = _elapsed_ms(lambda: intra_fused_banded_ref(
        k["meta"], head[1], head[0], *out_p, k["res_l"], k["res_c"],
        k["bd"]))
    err = max(_max_err(out_k, out_p),
              _max_err(_run_kernel(k, True), _run_serial(k)))
    if err != 0:
        raise AssertionError(f"intra_fused_banded on a tile shard differs "
                             f"from its plain version or the serial-order "
                             f"entry by up to {err}")
    n_levels = int(k["level_bounds"].numel()) - 1
    whole = TorchEngine("cuda").prepare(fs)
    ms_s, ms_w = [], []
    for _ in range(reps):          # alternate the shard and the frame
        ms_s.append(_kernel_ms(k, True, 1))
        ms_w.append(_kernel_ms(whole, True, 1))
    ms, frame_ms = sum(ms_s) / reps, sum(ms_w) / reps
    rec = {"poc": fs.poc, "tile_groups": n_tile, "jobs": k["n"],
           "frame_jobs": n_jobs(fs), "n_levels": n_levels,
           "frame_levels": int(fs.native_raw["n_levels"]),
           "plain_jobs": head[0], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": _bound_ms(fs, k),
           "us_per_level": ms * 1e3 / n_levels, "frame_ms": frame_ms}
    print(f"phase6 intra_fused_banded on tile shard 0 of {n_tile} of "
          f"ra_tiles_1080p POC {fs.poc} ({k['n']} of {n_jobs(fs)} jobs, "
          f"{n_levels} dense levels of the frame's {rec['frame_levels']}) "
          f"== plain on bands 0-{PLAIN_BANDS - 1} ({head[0]} jobs) == "
          f"serial-order entry: max_abs_err {err}; {ms} ms (the whole "
          f"frame: {frame_ms} ms)", flush=True)
    return rec


def run_waves(counters):
    """Phase 6: the frame axis and the 2-D mesh, then the tile shard's
    kernel. Returns ({(axis, stream): result}, tile-shard record)."""
    frame, grid = wave_meshes()
    out = {}
    for name in ("i_main_832x480", "ra_main_1080p", "ra_main10_4k",
                 "shvc_2layer_832x480"):
        out["frame", name] = wave_decode(name, frame, counters)
    sizes = out["frame", "i_main_832x480"]["pocs"]
    if any(len(w) != WAVE_FRAMES for w in sizes):
        raise AssertionError(f"waves: i_main in waves of "
                             f"{[len(w) for w in sizes]}")
    inter = [k for k in out["frame", "ra_main_1080p"]["wave_sizes"]
             if k.startswith("inter_") and int(k[6:]) >= 3]
    if not inter:
        raise AssertionError("waves: ra_main_1080p has no inter wave of 3 "
                             "or more pictures")
    for name in ("ra_tiles_1080p", "i_main_832x480"):
        out["tile", name] = wave_decode(name, grid, counters)
    return out, check_tile_shard()


# ---- phase 7: the bench script ---------------------------------------------

def check_bench(launches):
    """Phase 7: `python3 bench_torch.py --only i_main_832x480` as a
    subprocess on the card must exit 0 with a JSON last line in which
    i_main is md5-exact in every pass, its launches equal phase 4's
    (`launches`) and the device is this process's card. Returns the
    stream's record."""
    import torch
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                        "--only", "i_main_832x480"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    rec = line["configs"]["i_main_832x480"]
    card = torch.cuda.get_device_name(0)
    print(f"phase7 bench_torch.py --only i_main_832x480: exit 0 in "
          f"{secs} s; {rec['frames']} frames, exact {rec['bit_exact']} / "
          f"{rec['decode_only_exact']} / {rec['diagnostics_exact']}, "
          f"launches {rec['launches']} (phase 4: {launches}), device "
          f"{line['device']['name']!r}; fps {rec['fps']} fetched / "
          f"{rec['fps_decode_only']} on the device, busy share "
          f"{rec['busy_share']} profiled / {rec['busy_share_timed']} of the "
          f"timed pass, bytes a frame {rec['h2d_bytes_per_frame']} "
          f"H2D / {rec['d2h_bytes_per_frame']} D2H, peak memory "
          f"{rec['peak_mem_bytes']} B", flush=True)
    if not (rec["bit_exact"] and rec["decode_only_exact"]):
        raise AssertionError("bench_torch.py: i_main differs from the md5 "
                             "sidecar")
    if rec["launches"] != launches:
        raise AssertionError(f"bench_torch.py: launches {rec['launches']}, "
                             f"phase 4 {launches}")
    if line["device"]["name"] != card:
        raise AssertionError(f"bench_torch.py ran on "
                             f"{line['device']['name']!r}, not {card!r}")
    return rec


# ---- phase 8: the feature matrix ----------------------------------------------

def feature_manifest():
    """The entries of feature_streams/MANIFEST.json (tools/
    make_feature_streams.py writes it; a missing file raises)."""
    with open(os.path.join(FEATURE_DIR, "MANIFEST.json")) as f:
        return json.load(f)["streams"]


def feature_stream(entry):
    """(bytes, md5 a picture in output order) of a manifest entry."""
    path = os.path.join(FEATURE_DIR, f"{entry['name']}.265")
    with open(path, "rb") as f:
        data = f.read()
    with open(path + ".md5") as f:
        return data, f.read().split()


def picture_route(eng, fs, k):
    """The route one picture took through the engine `eng`, in the
    manifest's terms: its parse, its in-loop filters (none / device /
    host), the kernel plan (`TorchEngine.fused_plan`'s kind: whole,
    banded, or no_band_plan), its intra jobs, inter blocks and PCM
    blocks."""
    kind = eng.fused_plan(fs)[0]
    if (k["bounds"] is None) != (kind != "banded"):
        raise AssertionError(f"POC {fs.poc}: plan {kind} but bounds "
                             f"{k['bounds']}")
    return {"poc": int(fs.poc),
            "parse": "native" if fs.native_raw is not None else "python",
            "filters": k["filters"].route if k["filters"] else "none",
            "plan": kind, "jobs": int(k["n"]), "inter": bool(fs.inter_pbs),
            "pcm": len(fs.pcm_blocks)}


def feature_decoder(keep, device="cuda"):
    """`Decoder(device=device)` (the default configuration) whose engine
    notes every picture's route (`routes`, decode order) and which keeps
    (fs, refs) of the pictures for which keep(fs) holds (`kept`)."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine

    class RouteEngine(TorchEngine):
        def prepare(self, fs, ref_planes=None, shard=None):
            k = super().prepare(fs, ref_planes, shard)
            self.routes.append(picture_route(self, fs, k))
            return k

    class FeatureDecoder(Decoder):
        def _engine(self):
            if self._torch_engine is None:
                self._torch_engine = RouteEngine(self.device)
                self._torch_engine.routes = self.routes
            return self._torch_engine

        def _reconstruct(self, fs, refs):
            if keep(fs):
                self.kept.append((fs, dict(refs)))
            return super()._reconstruct(fs, refs)

    d = FeatureDecoder(device=device)
    d.routes, d.kept = [], []
    return d


def _keeper(entry):
    """keep(fs) for the phase's kernel checks: the first picture with
    intra jobs, and on a stream with constrained intra prediction also
    the first inter picture with intra jobs (the encoder writes PCM and
    CCP into intra streams only, so theirs have no inter picture)."""
    seen = set()
    also_inter = "constrained_intra" in entry["features"]

    def keep(fs):
        if not n_jobs(fs):
            return False
        for what, want in (("first", True),
                           ("inter", also_inter and bool(fs.inter_pbs))):
            if want and what not in seen:
                seen.add(what)
                return True
        return False
    return keep


def check_feature_routes(entry, routes, stats, launches=None, owed=None):
    """Parts 1-2 of phase 8 beside the md5s: every picture took the route
    its manifest entry predicts (parse, filters, plan, jobs, inter and
    PCM blocks, in decode order), the Python parser took the predicted
    slices, and, with `launches` (the counters of the decode), each
    intra kernel launched once a picture of its plan with jobs and,
    where `launches` counts them, the edge-parameter kernel and the
    in-loop filters' kernels as often as `owed` (the decode's NEED)
    says."""
    name = entry["name"]
    if routes != entry["routes"]:
        bad = [(g, w) for g, w in zip(routes, entry["routes"]) if g != w]
        raise AssertionError(f"{name}: routes differ from the manifest "
                             f"({len(routes)} pictures, "
                             f"{len(entry['routes'])} predicted; first "
                             f"differences {bad[:2]})")
    if stats["python_slices"] != entry["python_slices"]:
        raise AssertionError(f"{name}: {stats['python_slices']} slices "
                             f"through the Python parser, "
                             f"{entry['python_slices']} predicted")
    if launches is None:
        return None
    need = {"intra_fused": sum(r["jobs"] > 0 and r["plan"] != "banded"
                               for r in routes),
            "intra_fused_banded": sum(r["jobs"] > 0 and r["plan"] == "banded"
                                      for r in routes),
            "intra_fused_serial": 0}
    need.update({n: (owed or {}).get(n, 0) for n in NEED if n in launches})
    if launches != need:
        raise AssertionError(f"{name}: launches {launches}, predicted "
                             f"{need}")
    return need


@contextlib.contextmanager
def forced_banded(width, ctb_size, chroma_format_idc):
    """Every picture of this width, CTB size and chroma format takes the
    banded plan, one CTB row a band: the whole-frame gate at 0 and the
    band scratch budget at one row's (`one_row_budget`)."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as ifm
    hs = int(chroma_format_idc < 3)
    vs = int(chroma_format_idc == 1)
    with patched(TorchEngine, "FUSED_VMEM_BUDGET", 0), \
            patched(ifm, "VMEM_SCRATCH_BUDGET",
                    ifm.one_row_budget(width, ctb_size, hs, vs)):
        yield


def feature_kernels(entry, kept, repeats, device="cuda"):
    """Part 3 of phase 8: on each kept picture, the whole-frame kernel on
    the whole-frame layout and the banded kernel on a banded plan
    (Tier B: forced, one CTB row a band; Tier A: the picture's own) each
    == its plain version on the same inputs (Tier B; the serial-order
    entry on Tier A, where the plain version would take ~0.5 ms a job),
    and `repeats` launches in a row give identical planes. Returns
    {"pictures", "launches": {kernel: n}}."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as ifm
    tier_a = entry["tier"] == "A"
    launches = {"intra_fused": 0, "intra_fused_banded": 0}
    for fs, refs in kept:
        for banded in (False, True):
            with contextlib.ExitStack() as st:
                if not banded:
                    st.enter_context(patched(TorchEngine,
                                             "FUSED_VMEM_BUDGET", 1 << 62))
                elif not tier_a:
                    st.enter_context(forced_banded(
                        fs.sps.width, fs.sps.ctb_size,
                        fs.sps.chroma_format_idc))
                k = TorchEngine(device).prepare(fs, refs)
            rows = -(-fs.sps.height // fs.sps.ctb_size)
            if (k["bounds"] is not None) != banded or (
                    banded and not tier_a and k["bounds"].numel() != rows + 1):
                raise AssertionError(f"{entry['name']} POC {fs.poc}: plan "
                                     f"bounds {k['bounds']} (banded "
                                     f"{banded}, {rows} CTB rows)")
            if tier_a:
                want, label = _run_serial(k), "the serial-order entry"
            else:
                want = [k["luma"].clone(), k["chroma"].clone()]
                lead = (k["bounds"],) if banded else ()
                plain = ifm.intra_fused_banded_ref if banded else \
                    ifm.intra_fused_ref
                plain(k["meta"], *lead, k["n"], *want, k["res_l"],
                      k["res_c"], k["bd"])
                label = "its plain version"
            name = "intra_fused_banded" if banded else "intra_fused"
            for i in range(repeats):
                got = _run_kernel(k, banded)
                sync(device)
                launches[name] += 1
                err = _max_err(got, want)
                if err != 0:
                    raise AssertionError(
                        f"{entry['name']} POC {fs.poc}: launch {i} of {name} "
                        f"differs from {label} by up to {err}")
    return {"pictures": len(kept), "launches": launches}


def decode_feature_stream(entry, counters, banded=False, keep=None,
                          device="cuda"):
    """One decode of a manifest stream through `Decoder(device=device)`,
    with every launch counter of `counters` at 0 just before: every
    picture's md5 equal to the sidecar, and the routes, Python-parser
    slices and (with counters) launches the manifest predicts. With
    `banded`, every picture is forced onto the banded plan, one CTB row a
    band (`forced_banded`), and must take it. Returns (the decoder, the
    pictures, a dict of the frames, md5s equal, seconds and launches)."""
    data, want = feature_stream(entry)
    dec = feature_decoder(keep or (lambda fs: False), device)
    label = "banded" if banded else "default"
    with contextlib.ExitStack() as st:
        if banded:
            st.enter_context(forced_banded(entry["width"], entry["ctb_size"],
                                           entry["chroma_format_idc"]))
            entry = dict(entry, routes=[dict(r, plan="banded")
                                        for r in entry["routes"]])
        zero(counters)
        sync(device)
        t0 = time.perf_counter()
        pics = dec.decode(data) + dec.flush()
        sync(device)
        secs = time.perf_counter() - t0
    launches, owed = read(counters)
    got = hash_pics(pics)
    n_ok = sum(g == w for g, w in zip(got, want))
    print(f"phase8 {entry['name']} (tier {entry['tier']}, "
          f"{entry['width']}x{entry['height']} {entry['chroma_format_idc']}"
          f" {entry['bit_depth']} bit, {label} plan): md5 {n_ok}/"
          f"{len(want)}; launches {launches}; {secs:.3f} s", flush=True)
    if len(got) != len(want) or n_ok != len(want):
        raise AssertionError(f"{entry['name']} ({label} plan): decoded "
                             f"pictures differ from the md5 sidecar "
                             f"({n_ok}/{len(want)}, {len(got)} decoded)")
    check_feature_routes(entry, dec.routes, dec.stats, launches or None,
                         owed)
    return dec, pics, {"frames": len(pics), "md5_ok": n_ok,
                       "seconds": secs, "launches": launches}


def check_feature_stream(entry, counters, repeats):
    """Phase 8 on one manifest stream: its decode on the default
    configuration (`decode_feature_stream`); on tier B a second decode
    with every picture forced onto the banded plan, held to the same
    sidecar; then the kernels against their plain versions (or the
    serial-order entry) on the kept pictures. Returns a dict."""
    dec, _pics, out = decode_feature_stream(entry, counters,
                                            keep=_keeper(entry))
    if entry["tier"] == "B":
        out["banded"] = decode_feature_stream(entry, counters,
                                              banded=True)[2]
    out["checked"] = feature_kernels(entry, dec.kept, repeats)
    return out


def run_feature_matrix(counters):
    """Phase 8: every stream of feature_streams/MANIFEST.json. Returns
    {"seconds", "streams", "pictures", "launches" (default-configuration
    decodes, per kernel), "banded_pictures", "banded_launches" (tier B's
    forced-banded decodes), "check_launches" (part 3, per kernel),
    "checked_pictures", "by_stream"}."""
    t0 = time.perf_counter()
    out = {"by_stream": {}}
    for entry in feature_manifest():
        reps = FEATURE_REPEATS_A if entry["tier"] == "A" else FEATURE_REPEATS
        out["by_stream"][entry["name"]] = check_feature_stream(
            entry, counters, reps)
    rows = out["by_stream"].values()
    banded = [r["banded"] for r in rows if "banded" in r]
    out.update(
        seconds=time.perf_counter() - t0, streams=len(rows),
        pictures=sum(r["frames"] for r in rows),
        launches={n: sum(r["launches"][n] for r in rows) for n in counters},
        banded_streams=len(banded),
        banded_pictures=sum(r["frames"] for r in banded),
        banded_launches={n: sum(r["launches"][n] for r in banded)
                         for n in counters},
        check_launches={n: sum(r["checked"]["launches"].get(n, 0)
                               for r in rows) for n in counters},
        checked_pictures=sum(r["checked"]["pictures"] for r in rows))
    print(f"phase8 feature matrix: {out['streams']} streams, "
          f"{out['pictures']} pictures, every one md5-exact and on its "
          f"predicted route; launches {out['launches']}; forced one-row "
          f"banded plan: {out['banded_streams']} tier B streams, "
          f"{out['banded_pictures']} pictures md5-exact, launches "
          f"{out['banded_launches']}; kernels == plain (tier B) / "
          f"serial-order entry (tier A) on {out['checked_pictures']} "
          f"pictures, {out['check_launches']} launches; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# ---- phase 9: the two-layer (SHVC) feature matrix ------------------------

def shvc_manifest():
    """The entries of feature_streams/shvc/MANIFEST.json (tools/
    make_feature_streams.py --shvc writes it; a missing file raises)."""
    with open(os.path.join(SHVC_DIR, "MANIFEST.json")) as f:
        return json.load(f)["streams"]


def shvc_stream(entry):
    """(bytes, EL md5s, BL md5s), a picture each in output order, of a
    two-layer manifest entry."""
    path = os.path.join(SHVC_DIR, entry["name"])
    with open(path + ".265", "rb") as f:
        data = f.read()
    with open(path + ".md5") as f:
        el = f.read().split()
    with open(path + ".bl.md5") as f:
        return data, el, f.read().split()


def _col_il(dec, sh, ref_list, poc):
    """Whether the decoder `dec` (of either package: both choose alike)
    takes the inter-layer reference's motion as TMVP's collocated
    picture for the slice header `sh` and lists `ref_list` of picture
    `poc` (the choice `_decode_slice` makes: the collocated entry
    carries the picture's own POC and the inter-layer motion field
    exists)."""
    if not sh.temporal_mvp or getattr(dec, "_il_motion", None) is None:
        return False
    cl = 0 if sh.collocated_list else 1
    lst = ref_list[cl] or ref_list[1 - cl]
    return bool(lst) and \
        lst[min(sh.collocated_ref_idx, len(lst) - 1)][0] == poc


def shvc_layer_class(counters, keep, banded=False):
    """The `Decoder` of one layer in phase 9: it notes every picture's
    route (`routes`, decode order: phase 8's fields, then the MC mode of
    its inter blocks, whether its references hold the inter-layer
    picture, whether TMVP's collocated picture is it), the launches of
    each counter during its own reconstructions (`launches`), and keeps
    (fs, refs) of the pictures for which keep(layer, fs) holds (`kept`).
    With `banded`, each of its pictures is forced onto the banded plan,
    one CTB row a band at its own width (`forced_banded`)."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine

    class RouteEngine(TorchEngine):
        def prepare(self, fs, ref_planes=None, shard=None):
            k = super().prepare(fs, ref_planes, shard)
            route = picture_route(self, fs, k)
            route.update(
                mc=("pair" if self.pairs_mode(fs) else "tap")
                if fs.inter_pbs else "none",
                il_ref=fs.poc in (ref_planes or {}))
            self.routes.append(route)
            return k

    class LayerDecoder(Decoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.routes, self.kept, self.col = [], [], {}
            self.launches = dict.fromkeys(counters, 0)
            self.owed = dict.fromkeys(NEED, 0)   # its due launches

        def _engine(self):
            if self._torch_engine is None:
                self._torch_engine = RouteEngine(self.device)
                self._torch_engine.routes = self.routes
            return self._torch_engine

        def _build_ref_lists(self, sh, sps, poc, il=None):
            lists = super()._build_ref_lists(sh, sps, poc, il=il)
            self.col[poc] = _col_il(self, sh, lists, poc)
            return lists

        def _reconstruct(self, fs, refs):
            if keep(self.layer, fs):
                self.kept.append((fs, dict(refs)))
            before = {n: f.launches for n, f in counters.items()}
            owed = dict(NEED)
            with contextlib.ExitStack() as st:
                if banded:
                    st.enter_context(forced_banded(
                        fs.sps.width, fs.sps.ctb_size,
                        fs.sps.chroma_format_idc))
                out = super()._reconstruct(fs, refs)
            self.routes[-1]["col_il"] = self.col.pop(fs.poc, False)
            for n, f in counters.items():
                self.launches[n] += f.launches - before[n]
            for n in NEED:
                self.owed[n] += NEED[n] - owed[n]
            return out

    return LayerDecoder


def _shvc_keeper():
    """keep(layer, fs) for phase 9's kernel and MC checks: each layer's
    first picture with intra jobs, and the enhancement layer's first
    inter picture (its second AU, with the temporal and the inter-layer
    reference where the EL has both)."""
    seen = set()

    def keep(layer, fs):
        for what, want in (("first", n_jobs(fs) > 0),
                           ("inter", layer == 1 and bool(fs.inter_pbs))):
            if want and (layer, what) not in seen:
                seen.add((layer, what))
                return True
        return False
    return keep


def decode_shvc(entry, counters, two_layers=True, banded=False, keep=None,
                device="cuda"):
    """One decode of a two-layer manifest stream with every launch
    counter of `counters` at 0 just before: through
    `ShvcDecoder(device=device)` (two_layers; its EL pictures against
    the `.md5` sidecar) or `Decoder(device=device)` on layer 0 alone (BL
    pictures against `.bl.md5`). Every picture md5-exact, every picture
    of each layer decoded on the route the manifest predicts (on the
    forced banded plan with `banded`), no slice through the Python
    parser unless predicted, and, with counters, each layer's launches
    as its routes predict. Returns (decoders by layer, pictures, dict of
    frames, md5s equal, seconds, launches by layer)."""
    from openhevc_tpu_torch.decoder import ShvcDecoder
    data, want_el, want_bl = shvc_stream(entry)
    layer = shvc_layer_class(counters, keep or (lambda _l, _fs: False),
                             banded)
    if two_layers:
        dec = type("PhaseShvc", (ShvcDecoder,), {"layer_class": layer})(
            device=device)
        decs, want = {"bl": dec.bl, "el": dec.el}, want_el
    else:
        dec = layer(device=device)
        decs, want = {"bl": dec}, want_bl
    zero(counters)
    sync(device)
    t0 = time.perf_counter()
    pics = dec.decode(data) + dec.flush()
    sync(device)
    secs = time.perf_counter() - t0
    total = {n: f.launches for n, f in counters.items()}
    got = hash_pics(pics)
    n_ok = sum(g == w for g, w in zip(got, want))
    what = "EL" if two_layers else "BL alone"
    plan = "banded" if banded else "default"
    if len(got) != len(want) or n_ok != len(want):
        raise AssertionError(f"{entry['name']} ({what}, {plan} plan): "
                             f"pictures differ from the md5 sidecar "
                             f"({n_ok}/{len(want)}, {len(got)} decoded)")
    for lay, d in decs.items():
        routes = entry["routes"][lay]
        if banded:
            routes = [dict(r, plan="banded") for r in routes]
        check_feature_routes(
            dict(entry, name=f"{entry['name']} {lay} ({what}, {plan} plan)",
                 routes=routes,
                 python_slices=entry["python_slices"][lay]),
            d.routes, d.stats, d.launches or None, d.owed)
    by_layer = {lay: d.launches for lay, d in decs.items()}
    if counters and total != {n: sum(v[n] for v in by_layer.values())
                              for n in counters}:
        raise AssertionError(f"{entry['name']}: launches {total} outside "
                             f"the layers' reconstructions {by_layer}")
    return decs, pics, {"frames": len(pics), "md5_ok": n_ok,
                        "seconds": secs, "launches": by_layer}


def shvc_rate(entry, device="cuda"):
    """EL pictures a second on the device of one decode through a plain
    `ShvcDecoder(device=device)` (outputs left on the device; a decode
    came before it), md5-checked after its clock stops, and the mean ms
    an EL picture of each stage of both layers from one more decode with
    the engines' sync timers (bench_torch.py `breakdown`)."""
    data, want, _bl = shvc_stream(entry)
    pics, secs, _dec = decode_all(data, fetch=False, two_layers=True,
                                  device=device)
    rows, _timed, staged = breakdown(data, two_layers=True, device=device)
    if hash_pics(pics) != want or hash_pics(staged) != want:
        raise AssertionError(f"{entry['name']}: a timed decode differs from "
                             f"the md5 sidecar")
    return {"el_pictures_per_s": len(pics) / secs,
            "stages_ms": {k: v for k, v in rows.items() if v is not None}}


def check_shvc_stream(entry, counters, repeats=SHVC_REPEATS, device="cuda"):
    """Phase 9 on one two-layer stream (see the module's docstring).
    Returns a dict of what was seen and measured."""
    name, tier_a = entry["name"], entry["tier"] == "A"
    decs, _pics, out = decode_shvc(entry, counters, keep=_shvc_keeper(),
                                   device=device)
    bl_decs, bl_pics, out["bl_alone"] = decode_shvc(
        entry, counters, two_layers=False, device=device)
    if not tier_a:
        out["banded"] = decode_shvc(entry, counters, banded=True,
                                    device=device)[2]
        out["bl_banded"] = decode_shvc(entry, counters, two_layers=False,
                                       banded=True, device=device)[2]
    kept = {lay: [(fs, refs) for fs, refs in d.kept if n_jobs(fs)]
            for lay, d in decs.items()}
    if not kept["el"] or not (tier_a or kept["bl"]):
        counts = {k: len(v) for k, v in kept.items()}
        raise AssertionError(f"{name}: no picture with intra jobs to hold "
                             f"the kernels on ({counts})")
    out["checked"] = feature_kernels(
        entry, kept["el"] if tier_a else kept["bl"] + kept["el"], repeats,
        device)
    if tier_a:
        out["upsample"] = check_upsample(
            bl_pics[0], entry["width"], entry["height"], entry["bit_depth"])
        out["rate"] = shvc_rate(entry, device)
    if name == SHVC_MC_STREAM:
        fs, refs = next((fs, refs) for fs, refs in decs["el"].kept
                        if fs.inter_pbs)
        want = {fs.poc - 1, fs.poc}         # the temporal and the IL picture
        if not want <= set(refs) or not want <= set(fs.ref_poc_l0):
            raise AssertionError(f"{name} POC {fs.poc}: L0 {fs.ref_poc_l0}, "
                                 f"references {sorted(refs)}")
        out["mc_modes"] = check_mc_modes(name, fs, refs, device, "phase9")
    n = {lay: sum(r["jobs"] > 0 for r in entry["routes"][lay])
         for lay in ("bl", "el")}
    print(f"phase9 {name} (tier {entry['tier']}, BL {entry['bl_width']}x"
          f"{entry['bl_height']} -> EL {entry['width']}x{entry['height']}, "
          f"{','.join(entry['features'])}): EL md5 {out['md5_ok']}/"
          f"{out['frames']}, BL md5 {out['bl_alone']['md5_ok']}/"
          f"{out['bl_alone']['frames']} (layer 0 alone)"
          + (f", forced banded plan EL md5 {out['banded']['md5_ok']}/"
             f"{out['banded']['frames']} BL md5 "
             f"{out['bl_banded']['md5_ok']}/{out['bl_banded']['frames']}"
             if "banded" in out else "")
          + f"; routes as predicted (plans BL "
          f"{sorted({r['plan'] for r in entry['routes']['bl']})} EL "
          f"{sorted({r['plan'] for r in entry['routes']['el']})}, "
          f"pictures with jobs BL {n['bl']} EL {n['el']}); launches "
          f"{json.dumps(out['launches'])}; kernels == "
          f"{'serial-order entry' if tier_a else 'plain'} on "
          f"{out['checked']['pictures']} pictures "
          f"{json.dumps(out['checked']['launches'])}; {out['seconds']:.3f} s"
          + (f"; upsample {out['upsample']['bl']} -> {out['upsample']['el']}"
             f" == per-sample evaluation, {out['upsample']['ms']} ms (bound "
             f"{out['upsample']['bound_ms']} ms); "
             f"{out['rate']['el_pictures_per_s']} EL pictures a second on "
             f"the device, stages_ms {json.dumps(out['rate']['stages_ms'])}"
             if tier_a else ""), flush=True)
    return out


def check_shvc_cli(entries, device="cuda"):
    """Phase 9's entry points: `python3 -m openhevc_tpu_torch -i <stream>
    -o <yuv> -n -l 1` (EL pictures, `ShvcDecoder`) and `-l 0` (BL
    pictures, `Decoder` on layer 0) on each entry, all processes at once;
    every frame of each .yuv hashes to its sidecar's md5. Returns
    {(name, layer): {"frames", "process_seconds"}}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for entry in entries:
            src = os.path.join(SHVC_DIR, f"{entry['name']}.265")
            for layer in (1, 0):
                yuv = os.path.join(tmp, f"{entry['name']}_l{layer}.yuv")
                procs[entry["name"], layer] = (yuv, time.perf_counter(),
                                               subprocess.Popen(
                    [sys.executable, "-m", "openhevc_tpu_torch", "-i", src,
                     "-o", yuv, "-n", "-l", str(layer), "-d", device],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
        by_name = {e["name"]: e for e in entries}
        for (name, layer), (yuv, t0, p) in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            secs = time.perf_counter() - t0
            if p.returncode != 0:
                raise AssertionError(f"CLI -l {layer} on {name} exited "
                                     f"{p.returncode}: {stderr[-2000:]}")
            e = by_name[name]
            _data, want_el, want_bl = shvc_stream(e)
            want = want_el if layer else want_bl
            w, h = (e["width"], e["height"]) if layer else \
                (e["bl_width"], e["bl_height"])
            fb = w * h * 3 // 2
            raw = open(yuv, "rb").read()
            got = [hashlib.md5(raw[i:i + fb]).hexdigest()
                   for i in range(0, len(raw), fb)]
            n_ok = sum(g == x for g, x in zip(got, want))
            print(f"phase9 CLI -l {layer} {name}: md5 {n_ok}/{len(want)} "
                  f"frames of the .yuv equal the sidecar ({secs} s for the "
                  f"process; {stdout.strip()})", flush=True)
            if len(got) != len(want) or n_ok != len(want):
                raise AssertionError(f"CLI -l {layer} on {name}: the .yuv "
                                     f"differs from the md5 sidecar")
            out[name, layer] = {"frames": n_ok, "process_seconds": secs}
    return out


def run_shvc_matrix(counters, device="cuda"):
    """Phase 9: every stream of feature_streams/shvc/MANIFEST.json
    (`check_shvc_stream`), then the CLI on SHVC_CLI. Returns {"seconds",
    "streams", "pictures" and "md5_ok" by layer, "launches" (two-layer
    decodes), "base_layer_launches" (layer 0 alone), "banded_launches"
    (tier B, forced banded plan), "check_launches", "upsample" by
    stream, "rates" by stream, "mc_modes", "cli", "by_stream"}."""
    t0 = time.perf_counter()
    entries = shvc_manifest()
    rows = {e["name"]: check_shvc_stream(e, counters, device=device)
            for e in entries}

    def total(runs):
        return {n: sum(r["launches"][lay][n] for r in runs
                       for lay in r["launches"]) for n in counters}
    out = {
        "by_stream": rows, "streams": len(rows),
        "pictures": {"el": sum(r["frames"] for r in rows.values()),
                     "bl": sum(r["bl_alone"]["frames"]
                               for r in rows.values())},
        "md5_ok": {"el": sum(r["md5_ok"] for r in rows.values()),
                   "bl": sum(r["bl_alone"]["md5_ok"] for r in rows.values()),
                   "banded_el": sum(r["banded"]["md5_ok"]
                                    for r in rows.values() if "banded" in r),
                   "banded_bl": sum(r["bl_banded"]["md5_ok"]
                                    for r in rows.values()
                                    if "bl_banded" in r)},
        "launches": total(rows.values()),
        "base_layer_launches": total([r["bl_alone"] for r in rows.values()]),
        "banded_launches": total([r[k] for r in rows.values()
                                  for k in ("banded", "bl_banded")
                                  if k in r]),
        "check_launches": {n: sum(r["checked"]["launches"].get(n, 0)
                                  for r in rows.values()) for n in counters},
        "upsample": {n: r["upsample"] for n, r in rows.items()
                     if "upsample" in r},
        "rates": {n: r["rate"] for n, r in rows.items() if "rate" in r},
        "mc_modes": rows[SHVC_MC_STREAM]["mc_modes"]}
    out["cli"] = check_shvc_cli([e for e in entries if e["name"] in SHVC_CLI],
                                device)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase9 SHVC matrix: {out['streams']} two-layer streams, EL "
          f"{out['md5_ok']['el']}/{out['pictures']['el']} and BL (layer 0 "
          f"alone) {out['md5_ok']['bl']}/{out['pictures']['bl']} pictures "
          f"md5-exact, every picture of both layers on its predicted route; "
          f"launches {out['launches']} (both layers), "
          f"{out['base_layer_launches']} (layer 0 alone); forced one-row "
          f"banded plan (tier B): EL {out['md5_ok']['banded_el']} and BL "
          f"{out['md5_ok']['banded_bl']} pictures md5-exact, launches "
          f"{out['banded_launches']}; kernel checks "
          f"{out['check_launches']}; CLI -l 1 / -l 0 md5-exact on "
          f"{sorted({n for n, _l in out['cli']})}; {out['seconds']:.1f} s",
          flush=True)
    return out


def run():
    """Phases 3-10 on the card; returns the kernel records."""
    from openhevc_tpu_torch.ops import intra_fused as ifm
    from openhevc_tpu_torch.ops.filters import (apply_filters_device,
                                                edge_params)
    counters = {"intra_fused": ifm.intra_fused,
                "intra_fused_banded": ifm.intra_fused_banded,
                "intra_fused_serial": ifm.intra_fused_serial,
                "edge_params": edge_params,
                "loop_filters": apply_filters_device}

    # ---- phase 3: each kernel vs its plain version -----------------------
    fs = parse_only(first_frames(load_stream("i_main_832x480")[0], 1))[0]
    recs = {"intra_fused": check_intra_fused(fs)}
    r = recs["intra_fused"]
    print(f"phase3 intra_fused == plain on i_main frame 0 ({r['jobs']} "
          f"jobs, {r['n_levels']} wavefront levels): max_abs_err "
          f"{r['max_abs_err']}", flush=True)
    fs = parse_only(first_frames(load_stream("main10_4k")[0], 1))[0]
    recs["intra_fused_banded"], whole_4k_ms = check_intra_fused_banded(fs)
    r = recs["intra_fused_banded"]
    print(f"phase3 intra_fused_banded == plain on bands "
          f"0-{PLAIN_BANDS - 1} of main10_4k frame 0 ({r['plain_jobs']} "
          f"jobs): max_abs_err {r['max_abs_err']}; == intra_fused on the "
          f"whole frame ({r['jobs']} jobs, {r['bands']} bands, "
          f"{r['n_levels']} wavefront levels): max_abs_err "
          f"{r['whole_frame_max_abs_err']}", flush=True)
    fs, refs = inter_picture("ra_main_1080p")
    pre = check_banded_on_prefill(fs, refs)
    print(f"phase3 intra_fused_banded on the inter prefill of ra_main_1080p "
          f"POC {pre['poc']} ({pre['jobs']} jobs, {pre['n_levels']} levels, "
          f"intra share {pre['intra_share']}) == plain == serial-order "
          f"entry: max_abs_err {pre['max_abs_err']}; n == 0: no launch, "
          f"prefill unchanged", flush=True)
    r["max_abs_err"] = max(r["max_abs_err"], pre["max_abs_err"])
    r["prefilled_1080p"] = pre
    modes = {"ra_main_1080p": check_mc_modes("ra_main_1080p", fs, refs)}
    fs, refs = inter_picture("ra_main10_4k")
    modes["ra_main10_4k"] = check_mc_modes("ra_main10_4k", fs, refs)
    del fs, refs
    fs = parse_only(first_frames(load_stream("rext_444_832x480")[0], 1))[0]
    r444 = check_banded_444(fs)
    print(f"phase3 intra_fused_banded == plain == serial-order entry on the "
          f"whole of rext_444 frame 0 (4:4:4, {r444['jobs']} jobs, "
          f"{r444['bands']} bands, {r444['n_levels']} levels, "
          f"{r444['filtered_chroma_jobs']} chroma TUs with the smoothing "
          f"filter, {r444['chroma_32x32_jobs']} chroma TUs of 32x32): "
          f"max_abs_err {r444['max_abs_err']}", flush=True)
    r["max_abs_err"] = max(r["max_abs_err"], r444["max_abs_err"])
    r["rext_444_frame0"] = r444
    edge = check_edge_params()
    print(f"phase3 edge_params == plain on the card == plain on the CPU "
          f"on POC "
          f"{edge['poc']} of {os.path.basename(EDGE_STREAM)} "
          f"({edge['segments']} edge segments): max_abs_err "
          f"{edge['max_abs_err']}", flush=True)
    lf = check_loop_filters()
    counts = {k: len(v) for k, v in lf["pictures"].items()}
    each = sorted({n for v in lf["pictures"].values() for n in v})
    print(f"phase3 loop_filters == apply_filters_ref on every filtered "
          f"picture ({json.dumps(counts)} pictures, launches a picture "
          f"{each}): max_abs_err {lf['max_abs_err']}", flush=True)
    ups = check_shvc_2layer_upsample()
    print(f"phase3 upsample {ups['bl']} -> {ups['el']} == per-sample "
          f"evaluation of the tap plan: max_abs_err {ups['max_abs_err']}",
          flush=True)
    del fs

    # ---- phase 4: the main path of each stream ---------------------------
    runs = {name: main_path(name, counters)
            for name, _kind, _frames in CONFIGS}
    recs["edge_params"] = edge
    recs["loop_filters"] = lf
    for kernel, r in recs.items():
        r["launches_by_stream"] = {
            name: launches[kernel] for name, (_, launches, _) in runs.items()
            if kernel == KERNEL_OF[name] or kernel in NEED}
        r["launches"] = sum(r["launches_by_stream"].values())

    # ---- phase 5: the routes off the main path ---------------------------
    nbp = check_no_band_plan(counters, recs["intra_fused_banded"]["ms"])
    py = check_python_parser(counters)
    hf = check_host_filters(counters)
    cli = check_cli()
    recs["intra_fused"]["launches_by_route"] = {
        "main_path": recs["intra_fused"]["launches"],
        "no_band_plan": sum(nbp["launches"].values()),
        "python_parser": py["i_main_832x480"]["launches"],
        "host_filters": 0}
    recs["intra_fused_banded"]["launches_by_route"] = {
        "main_path": recs["intra_fused_banded"]["launches"],
        "no_band_plan": 0,
        "python_parser": py["ra_tiles_1080p"]["launches"],
        "host_filters": hf["launches"]}
    edge["launches_by_route"] = {
        "main_path": edge["launches"],
        "no_band_plan": sum(nbp["edge_launches"].values()),
        "python_parser": sum(row["edge_launches"] for row in py.values()),
        "host_filters": hf["edge_launches"]}
    lf["launches_by_route"] = {
        "main_path": lf["launches"],
        "no_band_plan": sum(nbp["filter_launches"].values()),
        "python_parser": sum(row["filter_launches"] for row in py.values()),
        "host_filters": hf["filter_launches"]}
    recs["intra_fused"]["main10_4k_frame0_whole_layout"] = {
        k: nbp[k] for k in ("ms", "bound_ms", "jobs")}

    # ---- phase 6: picture waves over a device mesh -----------------------
    waves, shard = run_waves(counters)
    for axis, route in (("frame", "waves_frame_axis"),
                        ("tile", "waves_tile_axis")):
        for kernel, r in recs.items():
            r["launches_by_route"][route] = sum(
                w["launches"][kernel] for (a, _), w in waves.items()
                if a == axis)
    r = recs["intra_fused_banded"]
    r["max_abs_err"] = max(r["max_abs_err"], shard["max_abs_err"])
    r["tile_shard_ra_tiles_1080p"] = shard

    # ---- phase 7: the bench script -----------------------------------------
    check_bench({n: c for n, c in runs["i_main_832x480"][1].items()
                 if n not in NEED})

    # ---- phase 8: the feature matrix ---------------------------------------
    fm = run_feature_matrix(counters)
    for kernel, r in recs.items():
        r["launches_by_route"]["feature_matrix"] = fm["launches"][kernel]
        r["launches_by_route"]["feature_matrix_banded"] = \
            fm["banded_launches"][kernel]

    # ---- phase 9: the two-layer (SHVC) feature matrix ----------------------
    sm = run_shvc_matrix(counters)
    for kernel, r in recs.items():
        r["launches_by_route"].update(
            shvc_matrix=sm["launches"][kernel],
            shvc_matrix_base_layer=sm["base_layer_launches"][kernel],
            shvc_matrix_banded=sm["banded_launches"][kernel])

    # ---- phase 10: report --------------------------------------------------
    for name, (nf, _, dec) in runs.items():
        report(name, nf, dec)
    for name, by_mode in modes.items():
        for mode, row in by_mode.items():
            for key, v in row.items():
                print(f"{name} mc_{mode}_mode {key} {v}")
    for r, frame in zip(list(recs.values())[:2],
                        ("i_main_832x480", "main10_4k")):
        print(f"{r['name']}_kernel_ms_per_frame {r['ms']} ({frame} frame 0; "
              f"{r['us_per_level']} us a level, {r['us_per_job']} us a job, "
              f"grid {r['grid']})")
        print(f"{r['name']}_serial_order_entry_ms {r['serial_ms']} "
              f"({frame} frame 0)")
        print(f"{r['name']}_plain_ms {r['plain_ms']} "
              f"({r.get('plain_jobs', r['jobs'])} jobs)")
        print(f"{r['name']}_launches {r['launches']} "
              f"{json.dumps(r['launches_by_stream'])}")
    print(f"edge_params_launches {edge['launches']} "
          f"{json.dumps(edge['launches_by_stream'])} (phase 4, one a "
          f"picture deblocked on the card)")
    print(f"intra_fused_kernel_ms_main10_4k_frame0 {whole_4k_ms} (same "
          f"band-sorted meta and planes)")
    print(f"intra_fused_banded_kernel_ms_rext_444_frame0 {r444['ms']} "
          f"({r444['jobs']} jobs, {r444['n_levels']} levels, "
          f"{r444['us_per_level']} us a level; serial-order entry "
          f"{r444['serial_ms']} ms; plain {r444['plain_ms']} ms; bound "
          f"{r444['bound_ms']} ms)")
    print(f"upsample_ms_per_picture {ups['ms']} ({ups['bl']} -> {ups['el']}, "
          f"torch ops; bound {ups['bound_ms']} ms)")
    print(f"intra_fused_banded_kernel_ms_prefilled_1080p {pre['ms']} "
          f"(ra_main_1080p POC {pre['poc']}, {pre['jobs']} jobs, "
          f"{pre['n_levels']} levels; plain {pre['plain_ms']} ms; bound "
          f"{pre['bound_ms']} ms)", flush=True)
    print(f"no_band_plan intra_fused_kernel_ms_main10_4k_frame0 {nbp['ms']} "
          f"(whole-frame layout; bound {nbp['bound_ms']} ms; banded kernel "
          f"{nbp['banded_ms']} ms on the same frame); decode fps "
          f"main10_4k {nbp['main10_4k_decode_fps']}, ra_main10_4k first "
          f"{RA_4K_PICTURES} pictures {nbp['ra_main10_4k_decode_fps']}; "
          f"launches {json.dumps(nbp['launches'])}")
    for name, row in py.items():
        print(f"python_parser {name} parse_ms_per_picture "
              f"{json.dumps(row['parse_ms'])} ([POC, ms] in decode order); "
              f"decode_ms_per_picture {row['decode_ms_per_picture']} over "
              f"{row['pictures']} pictures")
    for k, v in hf["stage_ms_per_picture"].items():
        print(f"host_filters stage_ms_per_picture {k} {v} (ra_tiles_1080p, "
              f"first {hf['pictures']} pictures)")
    for label, row in cli.items():
        print(f"cli .{label} {row['frames']} frames md5-exact, "
              f"{row['process_seconds']} s for the process")
    for (axis, name), w in waves.items():
        print(f"waves {axis} axis {name} decode_fps_device_resident "
              f"{w['fps']} (one device, in turns: {w['one_device_fps']}; "
              f"phase 4: {w['phase4_fps']}); {w['waves']} waves "
              f"{json.dumps(w['wave_sizes'])}")
    print(f"tile_shard intra_fused_banded_kernel_ms {shard['ms']} "
          f"(ra_tiles_1080p POC {shard['poc']}, shard 0 of "
          f"{shard['tile_groups']}: {shard['jobs']} of {shard['frame_jobs']} "
          f"jobs, {shard['n_levels']} levels, {shard['us_per_level']} us a "
          f"level; plain {shard['plain_ms']} ms on {shard['plain_jobs']} "
          f"jobs; bound {shard['bound_ms']} ms; the whole frame "
          f"{shard['frame_ms']} ms)")
    for name, u in sm["upsample"].items():
        print(f"shvc_matrix upsample_ms_per_picture {u['ms']} ({name}, "
              f"{u['bl']} -> {u['el']}; bound {u['bound_ms']} ms)")
    for name, rate in sm["rates"].items():
        print(f"shvc_matrix {name} el_pictures_per_s_device_resident "
              f"{rate['el_pictures_per_s']}")
        for k, v in rate["stages_ms"].items():
            print(f"shvc_matrix {name} stage_ms_per_el_picture {k} {v}")
    for mode, row in sm["mc_modes"].items():
        for key, v in row.items():
            print(f"shvc_matrix {SHVC_MC_STREAM} mc_{mode}_mode {key} {v}")
    for (name, layer), row in sm["cli"].items():
        print(f"shvc_matrix cli -l {layer} {name} {row['frames']} frames "
              f"md5-exact, {row['process_seconds']} s for the process")
    for r in recs.values():
        print(f"{r['name']}_launches_by_route "
              f"{json.dumps(r['launches_by_route'])}", flush=True)
    for name, row in lf["timed"].items():
        print(f"loop_filters_kernel_ms {row['ms']} ({name}, "
              f"{row['size']}, {row['launches']} launches a call between "
              f"CUDA events, mean of {REPS}; device time "
              f"{row['device_us']} us; plain {row['plain_ms']} ms; bound "
              f"{row['bound_ms']} ms)")
    print(f"loop_filters_launches {lf['launches']} "
          f"{json.dumps(lf['launches_by_stream'])} (phase 4, two for "
          f"deblocking and one for SAO a picture filtered on the card)",
          flush=True)
    print(f"edge_params_kernel_ms {edge['ms']} (POC {edge['poc']} of "
          f"{os.path.basename(EDGE_STREAM)}, one launch between CUDA "
          f"events, mean of {REPS}; device time {edge['device_us']} us; "
          f"plain {edge['plain_ms']} ms; bound {edge['bound_ms']} ms for "
          f"{edge['bytes']} B)", flush=True)
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

    with edge_watch(), filter_watch():
        kernels = run()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
