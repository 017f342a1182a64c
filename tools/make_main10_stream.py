"""Make the frozen Main 10 random-access stream of the benchmark
configuration `hevc_main10_ra_2160p` and its per-picture md5 sidecar.

    python tools/make_main10_stream.py OUT_DIR [--width 3840] [--height 2160]
        [--frames 33] [--seed 20] [--qp 32]

writes OUT_DIR/hevc_ra_2160p10_qp32.265 and its `.md5` (one line a
picture, output order, the cropped Y, U, V planes hashed as uint16).

The in-repo encoder (`openhevc_tpu.encoder`) quantizes and reconstructs
with QpY, where a decoder scales with Qp'Y = QpY + QpBdOffsetY (H.265
8.6.1: QpBdOffsetY = 6 * (BitDepthY - 8), and the same for chroma). The
two agree at 8 bits; at 10 bits its levels come out four times too large,
the decode of its stream is not its reconstruction, and its inter
pictures code the drift (a 10-bit stream of smooth content decodes to
about 11 dB PSNR against its source). This script hands
`transforms_np.quantize` / `dequant` Qp' while the encoder codes a
picture; the encoder's files are left as they are. With that, the
encoder's reconstruction equals the decode of its stream picture for
picture, and a 10-bit stream takes the bytes of the same content at
8 bits.

The sidecar comes from the JAX package's numpy decoder with the serial
native parse (`parse_threads=1`), so that the threaded WPP parse, which
the benchmark cell exercises, is not its own witness.
"""
import argparse
import hashlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def encode(width, height, frames, seed, qp):
    from openhevc_tpu.encoder.inter_enc import PFrameEncoder, encode_ra_stream
    from openhevc_tpu.ops import transforms_np as T
    from tools.make_feature_streams import smooth_moving
    bd = 10
    pics = smooth_moving(width, height, frames, seed=seed, bd=bd)
    quantize, dequant = T.quantize, T.dequant

    def quantize_bd(c, log2, q, b, **kw):
        return quantize(c, log2, q + 6 * (b - 8), b, **kw)

    def dequant_bd(lv, log2, q, b, **kw):
        return dequant(lv, log2, q + 6 * (b - 8), b, **kw)

    def with_qp_prime(method):
        # Qp' only inside the encoder's own picture calls: with the loop
        # filters on, encode_ra_stream decodes each picture with the numpy
        # decoder for its reference, and that decoder's dequant already
        # takes Qp'.
        def call(self, *a, **kw):
            T.quantize, T.dequant = quantize_bd, dequant_bd
            try:
                return method(self, *a, **kw)
            finally:
                T.quantize, T.dequant = quantize, dequant
        return call

    saved = PFrameEncoder.encode_frame, PFrameEncoder.encode_frame_p
    PFrameEncoder.encode_frame = with_qp_prime(saved[0])
    PFrameEncoder.encode_frame_p = with_qp_prime(saved[1])
    try:
        data, _ = encode_ra_stream(
            pics, width, height, qp=qp, gop=8, ctb_log2=6, min_cb_log2=3,
            seed=seed, tmvp=True, sao=True, deblock=True, amp=True,
            bit_depth=bd, wpp=True)
    finally:
        PFrameEncoder.encode_frame, PFrameEncoder.encode_frame_p = saved
    return data, pics


def sidecar(data):
    from openhevc_tpu.config import DecoderConfig
    from openhevc_tpu.decoder import Decoder
    dec = Decoder("np", native_parse=True,
                  config=DecoderConfig.from_env(engine="np", parse_threads=1))
    lines = []
    for p in dec.decode(data) + dec.flush():
        h = hashlib.md5()
        for c in p.cropped():
            h.update(np.ascontiguousarray(np.asarray(c, np.uint16)).tobytes())
        lines.append(h.hexdigest())
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--qp", type=int, default=32)
    a = ap.parse_args()
    os.makedirs(a.out_dir, exist_ok=True)
    name = os.path.join(a.out_dir, f"hevc_ra_2160p10_qp{a.qp}.265")
    t = time.time()
    data, _ = encode(a.width, a.height, a.frames, a.seed, a.qp)
    with open(name, "wb") as f:
        f.write(data)
    print(f"encoded {len(data)} bytes in {time.time() - t:.1f} s", flush=True)
    t = time.time()
    lines = sidecar(data)
    with open(name + ".md5", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"sidecar {len(lines)} pictures in {time.time() - t:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
