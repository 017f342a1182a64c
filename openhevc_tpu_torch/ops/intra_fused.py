"""Fused intra reconstruction: every intra TU of a frame, in decode order,
in one kernel launch.

Counterpart of the JAX package's ops/intra_fused.py (`_build`, the
whole-frame Pallas kernel, and its per-TU body `_job`). The hand-written
CUDA kernel lives in csrc/intra_fused.cu; this module holds what
surrounds it:

  - the padded plane layout (origin (OY, OX) = (8, 128), bottom pad 48
    rows, right pad to a 128 multiple + 256), kept from the JAX package
    so every neighbour read up to x + 2s stays in bounds;
  - `derive_meta16`: the kernel's [16, npad] job meta from the 5 packed
    rows the native parser emits;
  - `intra_fused_ref`: the plain PyTorch version (a Python loop over
    jobs, tensor ops per TU), used for CPU tensors and as the yardstick
    the kernel is held against on the card;
  - `intra_fused`: the wrapper, with its launch counter.

Bit-exact with the JAX package's ops/intra_np.py (hevcpred_template.c:
intra_pred :30, pred_planar :359, pred_dc :388, pred_angular :419;
substitution 8.4.4.2.2, filtering 8.4.4.2.3).

Meta rows: 0 y(buf) 1 x(buf) 2 size_log2-2 3 mode 4 plane 5 do_filter
6 avail word0 (groups 0..15) 7 avail word1 (16..31) 8 angle 9 inv_angle
10 strong_allowed 11 any_avail 12 edge_filters 13 avail bit 32.
Availability is one bit per 4-sample group in spec order
[left s/2 groups (bottom->top) | corner | top s/2 groups].
"""
from __future__ import annotations

import ctypes

import torch

from .tables import TABLES

OY, OX = 8, 128
BOT, RIGHT = 48, 256


def padded_dims(h: int, w: int) -> tuple[int, int]:
    hp = (OY + h + BOT + 7) & ~7
    wp = OX + ((w + 127) & ~127) + RIGHT
    return hp, wp


def derive_meta16(meta8: torch.Tensor, sdis: bool, c444: bool,
                  strong: bool) -> torch.Tensor:
    """[5, npad] int16 packed rows (y, x, sl|plane<<2|mode<<4|av_hi<<10,
    av_w0, av_w1) -> the kernel's [16, npad] int32 meta. The derived rows
    are pure functions of size, mode and plane (pipeline.py
    _derive_meta16 in the JAX package)."""
    m8 = meta8.to(torch.int32)
    my, mx, mpk, mav0, mav1 = m8.unbind(0)
    msl = mpk & 3
    mplane = (mpk >> 2) & 3
    mmode = (mpk >> 4) & 63
    mavhi = (mpk >> 10) & 1
    ms = 4 << msl
    md = torch.minimum((mmode - 26).abs(), (mmode - 10).abs())
    thr = torch.where(ms == 8, 7, torch.where(ms == 16, 1,
                      torch.where(ms == 32, 0, 99)))
    filt_ok = ((mplane == 0) | bool(c444)) & (not sdis)
    m5 = filt_ok & (ms > 4) & (mmode != 1) & (md > thr)
    idx = mmode.clamp(0, 34).long()
    mang = TABLES["ANG"].to(m8.device)[idx].to(torch.int32)
    minv = TABLES["INV"].to(m8.device)[idx].to(torch.int32)
    m10 = (ms == 32) & bool(strong) & (mplane == 0)
    m11 = (mav0 != 0) | (mav1 != 0) | (mavhi != 0)
    m12 = (ms < 32) & (mplane == 0)
    z = torch.zeros_like(my)
    rows = [my, mx, msl, mmode, mplane, m5, mav0, mav1, mang, minv, m10,
            m11, m12, mavhi, z, z]
    return torch.stack([r.to(torch.int32) for r in rows]).contiguous()


# =========================================================================
# Plain version
# =========================================================================

def _sample_groups(s: int) -> list[int]:
    """Availability group of each of the 4s+1 reference samples."""
    h = s // 2
    return [i >> 2 for i in range(2 * s)] + [h] + \
        [h + 1 + (i >> 2) for i in range(2 * s)]


def _job_ref(buf, res, s: int, bd: int, f: list[int]):
    """One TU: gather, substitute, filter, predict, add residual, clip,
    store into `buf` in place. f: the job's 16 meta fields."""
    y, x, mode, do_filter = f[0], f[1], f[3], f[5]
    angle, inv, strong_allowed, edge = f[8], f[9], f[10], f[12]
    n = 4 * s + 1
    log2s = s.bit_length() - 1
    maxv = (1 << bd) - 1
    dev = buf.device
    w = (f[6] & 0xFFFF) | ((f[7] & 0xFFFF) << 16) | ((f[13] & 1) << 32)
    w &= (1 << (s + 1)) - 1
    # reference samples in spec order: left bottom->top | corner | top
    ref = torch.cat([buf[y:y + 2 * s, x - 1].flip(0),
                     buf[y - 1, x - 1:x + 2 * s]]).to(torch.int64)
    # 8.4.4.2.2 substitution: each unavailable sample takes the last
    # available one before it, or the first available one if none is
    if w == 0:
        ref = torch.full((n,), 1 << (bd - 1), dtype=torch.int64, device=dev)
    else:
        av = [(w >> g) & 1 for g in _sample_groups(s)]
        last = av.index(1)
        src = []
        for i in range(n):
            if av[i]:
                last = i
            src.append(last)
        ref = ref[torch.tensor(src, device=dev)]
    # 8.4.4.2.3 filtering
    if do_filter:
        f121 = ref.clone()
        f121[1:n - 1] = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
        if s == 32 and strong_allowed:
            c, r0, rn = ref[2 * s], ref[0], ref[4 * s]
            th = 1 << (bd - 5)
            cond = ((c + rn - 2 * ref[3 * s]).abs() < th) & \
                ((c + r0 - 2 * ref[s]).abs() < th)
            k = torch.arange(2 * s - 1, device=dev)
            strong = ref.clone()
            strong[2 * s + 1:4 * s] = ((63 - k) * c + (k + 1) * rn + 32) >> 6
            strong[1:2 * s] = (((63 - k) * c + (k + 1) * r0 + 32) >> 6) \
                .flip(0)
            f121 = torch.where(cond, strong, f121)
        ref = f121
    left = ref[:2 * s].flip(0)          # left[y] = p[-1][y]
    corner = ref[2 * s]
    top = ref[2 * s + 1:]               # top[x] = p[x][-1]
    yg = torch.arange(s, device=dev)[:, None]
    xg = torch.arange(s, device=dev)[None, :]
    if mode == 0:
        pr = ((s - 1 - xg) * left[yg] + (xg + 1) * top[s] +
              (s - 1 - yg) * top[xg] + (yg + 1) * left[s] + s) >> (log2s + 1)
    elif mode == 1:
        dc = (top[:s].sum() + left[:s].sum() + s) >> (log2s + 1)
        pr = dc.expand(s, s).clone()
        if edge:
            pr[0, 1:] = (top[1:s] + 3 * dc + 2) >> 2
            pr[1:, 0] = (left[1:s] + 3 * dc + 2) >> 2
            pr[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
    else:
        ver = mode >= 18
        main, side = (top, left) if ver else (left, top)
        r = torch.zeros(3 * s + 2, dtype=torch.int64, device=dev)
        r[s] = corner
        r[s + 1:3 * s + 1] = main
        if angle < 0:
            k = torch.arange(s, device=dev)
            proj = (-1 + ((-(k + 1) * inv + 128) >> 8)).clamp(0, 2 * s - 1)
            r[:s] = side[proj].flip(0)
        # rows advance along the side direction (yg), columns along main
        idx = ((yg + 1) * angle) >> 5
        fact = ((yg + 1) * angle) & 31
        pr = ((32 - fact) * r[s + xg + idx + 1] +
              fact * r[s + xg + idx + 2] + 16) >> 5
        if not ver:
            pr = pr.T.contiguous()
        if edge and mode == 26:
            pr[:, 0] = (top[0] + ((left[:s] - corner) >> 1)).clamp(0, maxv)
        if edge and mode == 10:
            pr[0, :] = (left[0] + ((top[:s] - corner) >> 1)).clamp(0, maxv)
    blk = (pr + res[y:y + s, x:x + s]).clamp(0, maxv)
    buf[y:y + s, x:x + s] = blk.to(buf.dtype)


def intra_fused_ref(meta, n, luma, chroma, res_l, res_c, bd):
    """Plain PyTorch version of the fused intra kernel: same arguments and
    in-place effect as `intra_fused`, one job at a time in meta order."""
    if n == 0:
        return luma, chroma
    cols = meta[:, :n].to("cpu").T.tolist()
    for f in cols:
        plane = f[4]
        buf, res = (luma, res_l) if plane == 0 else \
            (chroma[plane - 1], res_c[plane - 1])
        _job_ref(buf, res, 4 << f[2], bd, f)
    return luma, chroma


# =========================================================================
# Kernel wrapper
# =========================================================================

def _check(meta, n, luma, chroma, res_l, res_c, bd):
    if not 1 <= bd <= 16:
        raise ValueError(f"bit depth {bd} out of range")
    dev = luma.device
    for name, t in (("meta", meta), ("luma", luma), ("chroma", chroma),
                    ("res_l", res_l), ("res_c", res_c)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, want int32")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, luma on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if meta.dim() != 2 or meta.shape[0] != 16 or not 0 <= n <= meta.shape[1]:
        raise ValueError(f"meta {tuple(meta.shape)} with n={n}")
    if luma.dim() != 2 or chroma.dim() != 3 or chroma.shape[0] != 2:
        raise ValueError(f"planes {tuple(luma.shape)}, "
                         f"{tuple(chroma.shape)}")
    if res_l.shape != luma.shape or res_c.shape != chroma.shape:
        raise ValueError("residual planes must match the recon planes")


def intra_fused(meta, n, luma, chroma, res_l, res_c, bd):
    """Run the first n jobs of meta [16, npad] int32 over the padded
    planes luma [hl, wl] and chroma [2, hc, wc] (int32, updated IN PLACE)
    with residual planes of the same shapes; returns (luma, chroma).

    CUDA tensors launch csrc/intra_fused.cu on the current stream and
    count one launch; CPU tensors run `intra_fused_ref`."""
    _check(meta, n, luma, chroma, res_l, res_c, bd)
    if luma.device.type == "cpu":
        return intra_fused_ref(meta, n, luma, chroma, res_l, res_c, bd)
    if luma.device.type != "cuda":
        raise ValueError(f"unsupported device {luma.device}")
    if n == 0:
        return luma, chroma
    lib = _lib()
    with torch.cuda.device(luma.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.intra_fused_launch(
            meta.data_ptr(), meta.shape[1], n,
            luma.data_ptr(), luma.shape[1],
            chroma.data_ptr(), chroma.shape[1], chroma.shape[2],
            res_l.data_ptr(), res_c.data_ptr(), bd, stream)
    if rc != 0:
        raise RuntimeError(f"intra_fused launch failed: cudaError_t {rc}")
    intra_fused.launches += 1
    return luma, chroma


intra_fused.launches = 0


def _lib():
    from .. import kernels
    lib = kernels.load("intra_fused")
    fn = lib.intra_fused_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, I, P, I, I, P, P, I, P]
        fn.restype = I
    return lib
