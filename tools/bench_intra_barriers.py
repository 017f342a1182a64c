#!/usr/bin/env python3
"""Time the level hand-over variants of the port's fused intra kernels
on one GPU (openhevc_tpu_torch; needs nvcc and a CUDA device):

    python3 tools/bench_intra_barriers.py [--reps 5]

For frame 0 of each bench stream (i_main 832x480: whole-frame plan;
main10_4k: banded plan) it builds tools/bench_intra_barriers.cu, which
runs the shipped scheduler and per-TU body with each hand-over variant,
checks every variant's planes against the serial-order kernel
(`intra_fused_serial`) exactly (but for the variant that runs the
hand-over without the jobs), and prints the mean CUDA-event time of
`--reps` launches, per launch and per wavefront level, for each variant,
team size (warps that share a job) and grid size, beside the shipped
wrappers' time, and the card's name and power limit. Exits non-zero on
any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {0: "done_count", 1: "grid_sync", 2: "arrive_counter",
            3: "cluster", 4: "hand_over_only"}
NO_OUTPUT = {4}         # variants that leave the planes untouched
# (variant, team): grids; team 0 = the shipped team size
GRIDS = {(0, 1): (66, 132, 264), (0, 2): (132, 264), (0, 4): (66, 132, 264),
         (0, 8): (132, 264, 396), (1, 0): (132, 264), (2, 0): (132, 264),
         (3, 0): (8, 16), (4, 0): (132,)}


TOO_LARGE = 720         # cudaErrorCooperativeLaunchTooLarge


class NotCoresident(Exception):
    """The runtime refused a cooperative grid that is not co-resident."""


def build():
    from openhevc_tpu_torch import kernels
    from openhevc_tpu_torch.buildutil import BUILD_DIR, PKG_DIR, build_once
    csrc = os.path.join(PKG_DIR, "csrc")
    src = os.path.join(ROOT, "tools", "bench_intra_barriers.cu")
    out = os.path.join(BUILD_DIR, "kernels", "libbench_intra_barriers.so")
    deps = [src] + [os.path.join(csrc, h) for h in kernels.HEADERS]
    print(build_once(out, deps, lambda o: [
        kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", csrc, src, "-o", o]))
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bench_launch.argtypes = [I, I, P, I, I, P, P, I, P, I, P, I, P, I,
                                 I, P, P, I, P]
    lib.bench_launch.restype = I
    lib.bench_max_grid.argtypes = [ctypes.POINTER(I)]
    lib.bench_max_grid.restype = I
    return lib


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        print("bench_intra_barriers: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as ifm
    lib = build()
    limit = ctypes.c_int(0)
    if lib.bench_max_grid(ctypes.byref(limit)):
        raise RuntimeError("occupancy query failed")
    print(f"co-resident blocks of {8 * 32} threads: {limit.value}")

    def run(k, variant, team, grid, planes):
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        rc = lib.bench_launch(
            variant, team, k["meta"].data_ptr(), k["meta"].shape[1], k["n"],
            k["order"].data_ptr(), k["level_bounds"].data_ptr(),
            k["level_bounds"].shape[0] - 1, counter.data_ptr(), grid,
            planes[0].data_ptr(), planes[0].shape[1], planes[1].data_ptr(),
            planes[1].shape[1], planes[1].shape[2], k["res_l"].data_ptr(),
            k["res_c"].data_ptr(), k["bd"],
            torch.cuda.current_stream().cuda_stream)
        if rc == TOO_LARGE:
            raise NotCoresident
        if rc:
            raise RuntimeError(f"variant {variant} team {team} grid {grid}: "
                               f"cudaError_t {rc}")

    def timed(fn, k):
        ms = []
        for _ in range(reps):
            planes = [k["luma"].clone(), k["chroma"].clone()]
            torch.cuda.synchronize()
            ms.append(cs._elapsed_ms(lambda: fn(planes)))
        return sum(ms) / len(ms), planes

    for name in ("i_main_832x480", "main10_4k"):
        fs = cs.parse_only(cs.first_frames(cs.load_stream(name)[0], 1))[0]
        k = TorchEngine("cuda").prepare(fs)
        nl = fs.native_raw["n_levels"]
        want = [k["luma"].clone(), k["chroma"].clone()]
        ifm.intra_fused_serial(k["meta"], k["n"], *want, k["res_l"],
                               k["res_c"], k["bd"])
        print(f"{name} frame 0: {k['n']} jobs, {nl} levels")
        cs._run_kernel(k, k["bounds"] is not None)      # builds at first use
        shipped = cs._kernel_ms(k, k["bounds"] is not None, reps)
        print(f"{name} shipped wrapper: {shipped} ms, "
              f"{shipped * 1e3 / nl} us/level")
        for (variant, team), grids in GRIDS.items():
            vname = VARIANTS[variant] + (f" team {team}" if team else "")
            for grid in grids:
                if variant != 3 and grid > limit.value:
                    continue
                try:
                    ms, got = timed(
                        lambda p: run(k, variant, team, grid, p), k)
                except NotCoresident:
                    print(f"{name} {vname} grid {grid}: not co-resident")
                    continue
                if variant in NO_OUTPUT:
                    print(f"{name} {vname} grid {grid}: {ms} ms, "
                          f"{ms * 1e3 / nl} us/level", flush=True)
                    continue
                err = cs._max_err(got, want)
                print(f"{name} {vname} grid {grid}: {ms} ms, "
                      f"{ms * 1e3 / nl} us/level, max_abs_err vs serial "
                      f"{err}", flush=True)
                if err:
                    return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
