#!/usr/bin/env python3
"""Find the knee of an open-loop cell: the highest rate of access units
at which the backlog does not grow over the window.

    python3 benchmark/sweep.py --workload NAME --seed N --seconds S \
        --rates 6,8,10,12

One process sets up the cell as a run does, then drives its open loop
once at each rate (a fresh decoder each), and prints one line a rate:
pictures due, median and 95th percentile latency, the lag of the feed
behind the schedule at the start and the end of the window, and whether
every picture matched its sidecar. The cell's fixed rate is set from
one such sweep on the card, at about four fifths of the knee; the runs
that measure the cell never sweep.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    from hevcbench import check
    from hevcbench.cell import Cell, build, warm_up
    from hevcbench.drive import Memory, Tamper, decoder_class, open_loop
    from hevcbench.traffic import nearest_rank
    c = Cell(ROOT, args.workload)
    if c.mix["loop"] != "open":
        print("sweep: the cell is not an open loop", file=sys.stderr)
        return 1
    build("cuda")
    cls = decoder_class(c.two_layers)
    pocs = warm_up(c, "cuda")[0][0]
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(c.mix, rate_aus_per_s=rate)
        w = open_loop(c.streams[0], mix, args.seed, args.seconds, "cuda",
                      cls, Memory("cuda"), Tamper())
        lag = (w.lag[0] * 1e3, w.lag[-1] * 1e3)
        counts, due, lat = check.open_(w, c.streams[0], pocs)
        ms = [x * 1e3 for x in lat]
        print(json.dumps({"rate_aus_per_s": rate, "due": due,
                          "median_ms": nearest_rank(ms, 0.5),
                          "p95_ms": nearest_rank(ms, 0.95),
                          "lag_first_ms": lag[0], "lag_last_ms": lag[1],
                          "exact": check.passed(counts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
