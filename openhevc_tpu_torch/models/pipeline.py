"""PyTorch reconstruction pipeline (the device half of the decoder).

Counterpart of the JAX package's models/pipeline.py main path
(`JaxEngine.reconstruct` -> `_run_fused` -> `_frame_fused`): for each
parsed picture

  1. one host->device copy of the native parser's packed arenas and the
     intra job meta (`fs.native_pack`);
  2. level rebuild from the scan-prefix payload (`_arena_levels`);
  3. dequant + inverse transform per TU size (ops/idct.py) and the slot
     scatter into residual planes (`_residual_acc`);
  4. PCM prefill;
  5. kernel meta derivation and the fused intra kernel over every intra
     TU in decode order (ops/intra_fused.py, csrc/intra_fused.cu);
  6. crop + downcast into one flat uint8 tensor that stays on the device
     as the DPB entry (`TorchPlanes` fetches it to the host lazily).

Pictures outside this path (in-loop filters, inter prediction, scaling
lists, chroma formats other than 4:2:0, bit depth > 8) raise
NotImplementedError naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.idct import residual_bucket
from ..ops.intra_fused import (OY, OX, derive_meta16, intra_fused,
                               padded_dims)
from ..ops.tables import TABLES
from ..symbols import FrameSymbols


def _arena_levels(arena4, arena16, escs, caps):
    """Rebuild per-bucket raster levels from the scan-prefix payload
    (JAX package: pipeline.py _arena_levels; byte format: _pack_arena /
    native hevc_pack_frame). Yields (s, cap, x, y, qpf, levels
    [cap, s, s] int32) per non-empty bucket.

    torch indexing neither clamps nor drops out-of-range indices, so the
    payload gather clamps its offsets explicitly (offsets past the last
    TU's payload only feed positions beyond the prefix, which are zeroed)
    and the (-1, -1) escape padding pairs are masked to a zero add."""
    pay = arena4.to(torch.int64)
    a = arena16.to(torch.int64)
    esc = escs.to(torch.int64).reshape(-1, 2)
    segs = []
    off = 0
    for s, cap, has_sm, n_esc in caps:
        if has_sm:
            raise NotImplementedError(
                "scaling-list matrices: ROADMAP.md Queue 1 item 7 (RExt)")
        if cap == 0:
            segs.append(None)
            continue
        x, y, qpf, cw = (a[off + i * cap:off + (i + 1) * cap]
                         for i in range(4))
        off += 4 * cap
        segs.append((x, y, qpf, cw & 0xFFF, (cw >> 12) & 1))
    lens = [torch.where(g[4] == 1, g[3], (g[3] + 1) >> 1)
            for g in segs if g is not None]
    if not lens:
        return
    all_len = torch.cat(lens)
    all_off = all_len.cumsum(0) - all_len          # exclusive
    eoff = boff = 0
    last = pay.shape[0] - 1
    for (s, cap, _sm, n_esc), seg in zip(caps, segs):
        if seg is None:
            continue
        x, y, qpf, cnt, mode = seg
        offs = all_off[boff:boff + cap]
        boff += cap
        ss = s * s
        k = torch.arange(ss, device=pay.device)[None, :]
        bidx = offs[:, None] + torch.where(mode[:, None] == 1, k, k >> 1)
        raw = pay[bidx.clamp(0, last)]
        nib = torch.where((k & 1) == 1, raw >> 4, raw & 15) - 8
        lvs = torch.where(mode[:, None] == 1, raw - 128, nib)
        lvs = torch.where(k < cnt[:, None], lvs, 0)
        inv = TABLES[f"INV_SCAN{s}"].to(pay.device)
        lvf = lvs[:, inv].reshape(-1)                 # scan -> raster
        if n_esc:
            e = esc[eoff:eoff + n_esc]
            eoff += n_esc
            keep = e[:, 0] >= 0
            lvf = lvf.index_add(0, torch.where(keep, e[:, 0], 0),
                                torch.where(keep, e[:, 1], 0))
        yield s, cap, x, y, qpf, lvf.reshape(cap, s, s).to(torch.int32)


def _residual_acc(arena4, arena16, escs, *, caps, H, W, Hc, Wc, bd):
    """Residual planes of one picture: (acc_l [H, W], acc_c [2, Hc, Wc])
    int32, or (None, None) when it has no residual. TUs of size s are
    s-aligned, so each lands in one cell of a [hg * wg, s, s] slot grid;
    rows that belong to another plane, and the packers' padding rows
    (FAR coordinates), are masked to a zero add at slot 0 instead of
    JAX's dropped out-of-range scatter."""
    acc_l = acc_c = None
    for s, cap, x, y, qpf, lv in _arena_levels(arena4, arena16, escs, caps):
        plane = qpf & 3
        qp = qpf >> 7
        r = residual_bucket(lv, qp, (qpf >> 2) & 1 != 0, (qpf >> 3) & 1 != 0,
                            (qpf >> 4) & 1 != 0, (qpf >> 5) & 1 != 0,
                            (qpf >> 6) & 1 != 0, s=s, bit_depth=bd)
        inside = (x >= 0) & (y >= 0)
        for c in range(3):
            ph, pw = (H, W) if c == 0 else (Hc, Wc)
            hg, wg = -(-ph // s), -(-pw // s)
            slot = (y // s) * wg + x // s
            ok = inside & (plane == c) & (slot < hg * wg)
            g = torch.zeros((hg * wg, s, s), dtype=torch.int32,
                            device=r.device)
            g.index_add_(0, torch.where(ok, slot, 0),
                         torch.where(ok[:, None, None], r, 0))
            g = g.reshape(hg, wg, s, s).permute(0, 2, 1, 3) \
                .reshape(hg * s, wg * s)[:ph, :pw]
            if c == 0:
                acc_l = g if acc_l is None else acc_l + g
            else:
                if acc_c is None:
                    acc_c = torch.zeros((2, Hc, Wc), dtype=torch.int32,
                                        device=r.device)
                acc_c[c - 1] += g
    return acc_l, acc_c


def _upload(arrays, device) -> list[torch.Tensor]:
    """ONE host->device copy for a list of numpy arrays: they are packed
    into one byte buffer (16-byte aligned segments) and viewed back as
    typed tensors on the device."""
    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += (a.nbytes + 15) & ~15
    host = np.zeros(max(off, 16), np.uint8)
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8) \
            .reshape(-1)
    dev = torch.from_numpy(host).to(device)
    return [dev[o:o + a.nbytes].view(getattr(torch, a.dtype.name))
            .reshape(a.shape) for a, o in zip(arrays, offs)]


def crop_pack(luma, chroma, H, W, Hc, Wc):
    """Padded int32 planes -> flat uint8 [Y | Cb | Cr] (8-bit output)."""
    return torch.cat([luma[OY:OY + H, OX:OX + W].reshape(-1),
                      chroma[:, OY:OY + Hc, OX:OX + Wc].reshape(-1)]) \
        .to(torch.uint8)


def check_slice(fs: FrameSymbols):
    """Raise NotImplementedError for a picture outside the ported slice."""
    sps, pps = fs.sps, fs.pps
    why = None
    if sps.chroma_format_idc != 1:
        why = "chroma formats other than 4:2:0: ROADMAP.md Queue 1 item 7"
    elif sps.bit_depth > 8 or sps.bit_depth_chroma > 8:
        why = "bit depth > 8: ROADMAP.md Queue 1 item 6 (Main10)"
    elif fs.inter_pbs:
        why = "inter prediction: ROADMAP.md Queue 1 item 5 (ra_main)"
    elif not fs.deblock_disabled or fs.sao_luma or fs.sao_chroma:
        why = "in-loop filters: ROADMAP.md Queue 1 item 4"
    elif getattr(pps, "cross_component_prediction_enabled", 0):
        why = "cross-component prediction: ROADMAP.md Queue 1 item 7"
    elif fs.native_pack is None:
        why = ("pictures without a native pack (scaling lists or the "
               "Python parser): ROADMAP.md Queue 1 item 7")
    if why:
        raise NotImplementedError(f"POC {fs.poc}: {why}")


class TorchPlanes:
    """A decoded picture whose flat uint8 output stays on the device (the
    DPB entry); `get()` fetches it to the host once. Quacks like the
    [Y, Cb, Cr] list the decoder expects."""

    device_filtered = False

    def __init__(self, flat: torch.Tensor, H, W, Hc, Wc):
        self._dev = flat
        self._dims = (H, W, Hc, Wc)
        self._mat = None

    def get(self):
        if self._mat is None:
            H, W, Hc, Wc = self._dims
            host = self._dev.cpu().numpy()
            self._mat = [host[:H * W].reshape(H, W),
                         host[H * W:H * W + Hc * Wc].reshape(Hc, Wc),
                         host[H * W + Hc * Wc:].reshape(Hc, Wc)]
        return self._mat

    def __getitem__(self, i):
        return self.get()[i]

    def __iter__(self):
        return iter(self.get())

    def __len__(self):
        return 3


class TorchEngine:
    """Reconstructs parsed pictures on one torch device."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def reconstruct(self, fs: FrameSymbols, ref_planes=None) -> TorchPlanes:
        """Reconstruct one parsed picture; the output stays on the
        device. ref_planes is unused until inter prediction is ported."""
        k = self.prepare(fs)
        intra_fused(k["meta"], k["n"], k["luma"], k["chroma"], k["res_l"],
                    k["res_c"], k["bd"])
        return TorchPlanes(crop_pack(k["luma"], k["chroma"], *k["dims"]),
                           *k["dims"])

    def prepare(self, fs: FrameSymbols) -> dict:
        """Steps 1-5 up to the intra kernel: the kernel's arguments
        (meta, n, luma, chroma, res_l, res_c, bd) plus the frame dims
        (H, W, Hc, Wc), all on this engine's device."""
        check_slice(fs)
        sps = fs.sps
        H, W = sps.height, sps.width
        hs, vs = sps.hshift1, sps.vshift1
        Hc, Wc = H >> vs, W >> hs
        bd = sps.bit_depth
        hl, wl = padded_dims(H, W)
        hc, wc = padded_dims(Hc, Wc)
        npk = fs.native_pack
        arena4, arena16, escs, meta8 = _upload(
            [npk["arena4"], npk["arena16"], npk["esc"], npk["meta"]],
            self.device)
        n = npk["n"]

        acc_l, acc_c = _residual_acc(arena4, arena16, escs, caps=npk["caps"],
                                     H=H, W=W, Hc=Hc, Wc=Wc, bd=bd)
        res_l = torch.zeros((hl, wl), dtype=torch.int32, device=self.device)
        res_c = torch.zeros((2, hc, wc), dtype=torch.int32,
                            device=self.device)
        if acc_l is not None:
            res_l[OY:OY + H, OX:OX + W] = acc_l
            res_c[:, OY:OY + Hc, OX:OX + Wc] = acc_c

        if fs.pcm_blocks:
            p0 = np.zeros((hl, wl), np.int32)
            c0 = np.zeros((2, hc, wc), np.int32)
            for p in fs.pcm_blocks:
                s_ = p.size
                p0[OY + p.y:OY + p.y + s_, OX + p.x:OX + p.x + s_] = \
                    p.samples_y
                cy, cx = OY + (p.y >> vs), OX + (p.x >> hs)
                c0[0, cy:cy + (s_ >> vs), cx:cx + (s_ >> hs)] = p.samples_cb
                c0[1, cy:cy + (s_ >> vs), cx:cx + (s_ >> hs)] = p.samples_cr
            luma, chroma = _upload([p0, c0], self.device)
        else:
            luma = torch.zeros((hl, wl), dtype=torch.int32,
                               device=self.device)
            chroma = torch.zeros((2, hc, wc), dtype=torch.int32,
                                 device=self.device)

        meta16 = derive_meta16(
            meta8, sdis=bool(getattr(sps, "intra_smoothing_disabled", 0)),
            c444=False, strong=bool(sps.strong_intra_smoothing))
        return dict(meta=meta16, n=n, luma=luma, chroma=chroma,
                    res_l=res_l, res_c=res_c, bd=bd, dims=(H, W, Hc, Wc))
