#!/usr/bin/env python3
"""Where the port's prep stage (`TorchEngine.prepare`) spends its time on
one GPU (openhevc_tpu_torch; needs a CUDA device):

    python3 tools/profile_torch_prep.py [--frames 3]

For the first frames of each of the seven bench streams (`CONFIGS`; in
decode order; an inter picture is prepared with its decoded references
on the card, an enhancement-layer picture with its inter-layer
reference) it prints
(a) the synchronised host-clock time of prepare() and of its parts run
alone: the band sort on the host, the in-loop filters' plan
(`plan_filters`: control arrays and the grids the per-edge parameters
are made from on the card) and the motion
packing (`_pack_inter`: sparse deltas, weight grids, stage 1 of the
references, here all cached) on the host, the one host-to-device copy,
the residual planes, the meta derivation and the level schedule; (b) a
`torch.profiler` table of prepare(): operator count, host time and
device time by operator; and the card's name and power limit. Times are
means over the frames after one warm-up pass.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    nframes = ap.parse_args().frames
    if not torch.cuda.is_available():
        print("profile_torch_prep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openhevc_tpu_torch.models import pipeline as pl
    from openhevc_tpu_torch.ops import filters as flt
    from openhevc_tpu_torch.ops import intra_fused as ifm
    eng = pl.TorchEngine("cuda")

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def pictures(name):
        """(fs, refs) of the stream's first nframes pictures (of both
        layers of a two-layer stream's first nframes access units, the
        base layer's first)."""
        two = name in cs.TWO_LAYERS
        dec = cs.smoke_decoder(keep=lambda fs: True, two_layers=two)
        dec.decode(cs.first_frames(cs.load_stream(name)[0],
                                   nframes * (2 if two else 1)))
        dec.flush()
        return [kept for d in cs.layers(dec) for kept in d.kept]

    for name, _kind, _frames in cs.CONFIGS:
        fss = pictures(name)
        for fs, refs in fss:
            eng.prepare(fs, refs)                             # warm-up
        parts = {}

        def add(key, fn):
            ms, out = clock(fn)
            parts[key] = parts.get(key, 0.0) + ms / len(fss)
            return out

        for fs, refs in fss:
            sps = fs.sps
            npk = add("host_pack (native pack, else the Python packer)",
                      lambda: pl.host_pack(fs))
            H, W = sps.height, sps.width
            Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
            plan = eng.fused_plan(fs)
            add("prepare (all)", lambda: eng.prepare(fs, refs))
            add("plan_filters (host)", lambda: flt.plan_filters(fs))
            if fs.inter_pbs:
                add("_pack_inter (host; stage 1 cached)",
                    lambda: eng._pack_inter(fs, refs, (H, W, Hc, Wc)))
            host = dict(arena4=npk["arena4"], arena16=npk["arena16"],
                        esc=npk["esc"], meta6=npk["meta6"])
            if plan[0] == "banded":
                host["meta6"], _ = add("band sort (host)",
                                       lambda: ifm.sort_meta_by_band(
                                           npk["meta6"], npk["n"], plan[2],
                                           sps.vshift1, plan[3]))
            dev = add("upload", lambda: pl.upload(host, "cuda"))
            a4, a16, esc, m6 = (dev[k] for k in host)
            add("residual planes", lambda: pl._residual_acc(
                a4, a16, esc, caps=npk["caps"], H=H, W=W, Hc=Hc, Wc=Wc,
                bd=sps.bit_depth))
            add("derive_meta16", lambda: ifm.derive_meta16(
                m6[:5], False, sps.chroma_format_idc == 3,
                bool(sps.strong_intra_smoothing)))
            add("level_schedule", lambda: ifm.level_schedule(
                m6[5], npk["n"], fs.native_raw["n_levels"]))
        for key, ms in parts.items():
            print(f"{name} prep_part_ms_per_frame {key}: {ms}")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fs, refs in fss:
                eng.prepare(fs, refs)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        print(f"{name} prepare() over {len(fss)} frames: "
              f"{sum(e.count for e in avg)} profiler events")
        print(avg.table(sort_by="self_cpu_time_total", row_limit=14,
                        max_name_column_width=48))
        print(avg.table(sort_by="self_cuda_time_total", row_limit=10,
                        max_name_column_width=48))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
