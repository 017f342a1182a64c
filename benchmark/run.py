#!/usr/bin/env python3
"""The benchmark of openhevc_tpu_torch, the PyTorch and CUDA HEVC/SHVC
decoder, on NVIDIA cards.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell NAME of BENCHMARK.json names a
configuration (`benchmark/configs/<config>.json`: the streams, their
reference decoders' md5 sidecars and the entry point) and a traffic mix
(`benchmark/traffic/<mix>.json`), which the one generator in
`hevcbench/traffic.py` turns into sessions or arrivals. The run sets
up (builds or finds the program's kernels and parse core, reads the
streams, decodes one session of the cell's own traffic), measures for
S seconds, holds every picture that the window output against the
sidecars (its POC, and its md5 where it is in a sample of up to 256
pictures a layer drawn from the seed), and prints one JSON line last on
stdout: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics, each read by
`benchmark/metrics/<name>.py`), `device`, with --trace 1 `breakdown`,
and last `limits`: each compared count beside its limit, as the last
lines on stderr also give them.

Exit 2 without a card, or with fewer than the cell asks for; exit 3 when
JAX or the JAX package was loaded in this process. --fault (not used by
the measured runs) plants the control or a fault under the timed path.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "openhevc_tpu")


def loaded_forbidden() -> list[str]:
    """Modules of JAX, Flax or the JAX package in this process, by whole
    top-level name (the port's own name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=("lsb", "stale", "half", "flip"),
                    help="the control (lsb) or a fault, for the "
                         "benchmark's own checks")
    args = ap.parse_args(argv)
    # the decoder's parse-ahead knobs stay at the program's defaults
    for knob in ("OPENHEVC_PARSE_AHEAD", "OPENHEVC_PARSE_THREADS"):
        os.environ.pop(knob, None)
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    from hevcbench import cell, manifest
    chips = manifest.cell(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", fault=args.fault,
                      t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: loaded in this process: {bad}", file=sys.stderr)
        return 3
    import json
    for name, lim in result["limits"].items():
        print(f"{name} {lim['value']} limit {lim['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
