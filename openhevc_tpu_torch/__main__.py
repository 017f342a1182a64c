"""CLI with parity to the reference's `hevc` tool (main_hm/main.c,
getopt flags main_hm/getopt.c:138-196):

    python -m openhevc_tpu_torch -i in.265 [-o out.yuv] [-n] [-c] [-p N]
                                 [-f T] [-t temporal_layer] [-l layer]
                                 [-d cuda|cpu]

Decodes an Annex-B stream (or the HEVC track of an MP4 / MOV, MPEG-TS,
Matroska or Ogg file), optionally writes planar YUV or yuv4mpeg2,
verifies SEI decoded-picture-hash MD5 (default on, like the reference
CLI), and reports frames + fps. Reconstruction runs on the card unless
`-d cpu` is given; without a card the default exits with status 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .api import OpenHevc, MD5Mismatch


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="openhevc_tpu_torch",
        description="PyTorch + CUDA HEVC decoder (openHEVC CLI parity)")
    ap.add_argument("-i", "--input", required=True,
                    help="Annex-B .265/.bin or .mp4/.mov (HEVC track)")
    ap.add_argument("-o", "--output",
                    help="write decoded video: planar YUV, or yuv4mpeg2"
                         " when the name ends in .y4m")
    ap.add_argument("-n", "--no-display", action="store_true",
                    help="no display (parity with the reference CLI)")
    ap.add_argument("-s", "--display", action="store_true",
                    help="play the stream in the terminal (ANSI "
                         "half-block renderer, paced to the stream "
                         "frame rate — the sdl.c role)")
    ap.add_argument("-c", "--no-check-md5", action="store_true",
                    help="disable SEI MD5 verification (default on)")
    ap.add_argument("-p", "--threads", type=int, default=1,
                    help="host parse threads")
    ap.add_argument("-f", "--thread-type", type=int, default=1,
                    help="1 frame / 2 slice(wpp) / 4 frameslice (parity)")
    ap.add_argument("-t", "--temporal-layer", type=int, default=None,
                    help="max sub-layer to decode (wrapper semantics: "
                         "keeps temporal_id <= N+1)")
    ap.add_argument("-l", "--layer", type=int, default=0,
                    help="SHVC output layer")
    ap.add_argument("-d", "--device", default="cuda",
                    help="torch device of the reconstruction (default "
                         "cuda; cpu only when asked for)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    with open(args.input, "rb") as f:
        data = f.read()
    dec = OpenHevc(args.threads, args.thread_type, device=args.device)
    dec.set_check_md5(not args.no_check_md5)
    if args.temporal_layer is not None:
        dec.set_temporal_layer_id(args.temporal_layer)
    dec.set_active_decoders(args.layer)
    dec.set_view_layers(args.layer)
    try:
        dec.start()
    except RuntimeError as e:            # no card for device "cuda"
        print(f"openhevc_tpu_torch: {e}", file=sys.stderr)
        return 2
    # MP4/MOV input: extract the HEVC track (mov.c role); MPEG-TS:
    # PAT/PMT/PES walk (mpegts.c role); Matroska: EBML track walk
    # (matroskadec.c role); Ogg: page/lacing walk (oggdec.c role)
    from .container import (is_mp4, demux_mp4, is_ts, demux_ts, is_mkv,
                            demux_mkv, is_ogg, demux_ogg)
    if is_mp4(data):
        hvcc, samples, _nls = demux_mp4(data)
        dec.copy_extradata(hvcc)
        data = b"".join(samples)
    elif is_ts(data):
        data = demux_ts(data)
    elif is_mkv(data):
        hvcc, samples, _nls = demux_mkv(data)
        dec.copy_extradata(hvcc)
        data = b"".join(samples)
    elif is_ogg(data):
        hvcc, samples, _nls = demux_ogg(data)
        dec.copy_extradata(hvcc)
        data = b"".join(samples)

    out_f = open(args.output, "wb") if args.output else None
    y4m = bool(args.output) and args.output.endswith(".y4m")
    disp = None
    n_frames = 0
    t0 = time.perf_counter()
    try:
        got = dec.decode(data)
        dec.flush()
        while True:
            frame = dec.get_output(1)
            if frame is None:
                break
            n_frames += 1
            fi = frame.frame_info
            if args.display and not args.no_display and disp is None:
                from .display import TerminalDisplay
                num, den = fi.frameRate
                disp = TerminalDisplay(fps=(num / den) if num and den
                                       else 25.0)
            if disp is not None:
                disp.show(frame.planes, fi.nBitDepth)
            if out_f is not None:
                bd = fi.nBitDepth
                if y4m:
                    from .display import y4m_header, y4m_frame
                    if n_frames == 1:
                        num, den = fi.frameRate
                        hsv = {0: (1, 1), 1: (1, 0),
                               2: (0, 0)}[fi.chromat_format]
                        out_f.write(y4m_header(
                            fi.nWidth, fi.nHeight, num or 25, den or 1,
                            hs=hsv[0], vs=hsv[1], bit_depth=bd))
                    out_f.write(y4m_frame(frame.planes, bd))
                    continue
                dt = "<u2" if bd > 8 else np.uint8
                for plane in frame.planes:
                    out_f.write(np.asarray(plane).astype(dt).tobytes())
    except MD5Mismatch as e:
        print(f"MD5 check FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if out_f is not None:
            out_f.close()
    dt = time.perf_counter() - t0
    if not args.quiet:
        md5_note = "" if args.no_check_md5 else " (MD5 verified)"
        print(f"frame= {n_frames} fps= {n_frames / dt:.2f} "
              f"time= {dt:.2f}{md5_note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
