"""Wave reconstruction over a device mesh.

Counterpart of the JAX package's parallel/mesh.py. A wave is a group of
mutually independent pictures of one SPS (parallel/frames.py, driven by
decoder.py's `_finish_parsed`); `MeshFrameDecoder.reconstruct_wave` runs
it over a `DeviceMesh`:

- **frame axis.** Member i runs the whole single-picture pipeline
  (`TorchEngine`: residual, inter prediction, the fused intra kernel,
  deblocking + SAO, crop) on frame shard i % n_frame. Its references are
  read where they lie and copied to the member's device
  (`TorchEngine._ref_plane_dev`): that is the wave's replicated
  reference pool, which the JAX package stacks and replicates with
  `P()`. Every member's prepare and kernel are enqueued before any
  member's filters and output, the counterpart of the JAX package's one
  sharded dispatch a wave. Weighted and unweighted members share a wave
  as they are: each member's engine takes its own weights.
- **tile axis** (a 2-D mesh `("frame", "tile")`). Each CTB belongs to
  tile shard `tile_id % n_tile` (untiled pictures: all CTBs to shard 0).
  Shard g of a member runs `TorchEngine.prepare(shard=(gmap, g))` and
  `launch` on its device: the residual TUs and intra jobs of its CTBs
  only (the standard makes another tile's samples unavailable to intra
  prediction), the inter prediction and PCM samples of the whole
  picture. One masked combine per plane on the frame shard's first
  device takes each CTB from its shard. The in-loop filters then follow
  the picture's filter plan (ops/filters.py `plan_filters`, the engine's
  plan): on its device route they run band-sharded (`band_filters`):
  shard g deblocks and SAOs CTB rows [g * rb, (g + 1) * rb), rb =
  ceil(ctbs_h / n_tile), on a band with a one-CTB halo, and the bands'
  interiors make up the picture. The plan's grids are uploaded to the
  first device, where `plan.args` makes the per-edge deblocking
  parameters in one launch, as on the engine's route; they and the
  plan's control arrays are cut per band. On the plan's host route the
  picture is filtered on the host (`host_filtered`).

What the JAX package does for its static shapes, and the port leaves
out: a wave is not padded to a multiple of the mesh (`mesh.py:321-322,
492-495` there), the residual buckets and job arrays are not stacked or
padded to common caps, and the reference pool is not padded to a power
of two. Torch compiles nothing per shape: a member, a shard and a band
each run at their own sizes, and a shard or a band with nothing to do
launches nothing.

One `TorchEngine` serves each distinct device of the mesh, however many
entries name it: an engine gives its stage-1 cache a quarter of its
card. A mesh may name one device several times, which is how it runs on
the CPU in the tests and on a machine with one card.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..bitstream.ps import ctb_tile_maps
from ..models.pipeline import (OX, OY, TorchEngine, TorchPlanes,
                               host_filtered, pack_planes, upload)
from ..ops.filters import plan_filters

AXES = (("frame",), ("frame", "tile"))


def _canonical(dev) -> torch.device:
    """A mesh entry as one torch device: "cpu" whatever its index; a
    CUDA entry with its index filled in. A CUDA entry with no card, or
    an index past the cards there are, raises: the mesh never remaps a
    device."""
    d = torch.device(dev)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type != "cuda":
        raise ValueError(f"mesh device {d}: want cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d}: no CUDA device is available")
    index = torch.cuda.current_device() if d.index is None else d.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"mesh device {d}: this machine has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


class DeviceMesh:
    """The port's stand-in for `jax.sharding.Mesh`: an object array of
    torch devices (`devices`) with named axes, ("frame",) or ("frame",
    "tile"). `shape` is an ordered dict of axis sizes, as the JAX Mesh's
    is. A device may appear more than once."""

    def __init__(self, devices, axis_names=("frame",)):
        axis_names = tuple(axis_names)
        if axis_names not in AXES:
            raise ValueError(f"axis_names {axis_names}: want one of {AXES}")
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [_canonical(d) for d in np.asarray(devices, object).flat]
        if len(shape) != len(axis_names) or not flat:
            raise ValueError(f"devices of shape {shape} for axes "
                             f"{axis_names}")
        self.devices = np.empty(len(flat), object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, shape))

    def __repr__(self):
        return (f"DeviceMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def tile_group_map(fs, n_tile: int) -> np.ndarray:
    """[ctbs_h, ctbs_w] int32 tile shard of each CTB: its tile id modulo
    the tile axis' size; an untiled picture lands on shard 0."""
    sps, pps = fs.sps, fs.pps
    if getattr(pps, "tiles_enabled", 0):
        return (ctb_tile_maps(pps, sps)[2] % n_tile).astype(np.int32)
    return np.zeros((sps.ctbs_h, sps.ctbs_w), np.int32)


def _expand(gmap, csy: int, csx: int, h: int, w: int):
    """Per-CTB values -> per-sample grid [h, w]."""
    return gmap.repeat_interleave(csy, 0).repeat_interleave(csx, 1)[:h, :w]


def band_units(cs: int, csv: int) -> dict:
    """Rows of each of the filters' named arrays (`FilterPlan.args`) per
    CTB row: luma 4 / 8-sample edge rows, chroma rows (csv chroma
    samples a CTB), one SAO row a CTB, the per-chroma-sample stale
    masks."""
    return dict(beta_v=cs // 4, tc_v=cs // 4, beta_h=cs // 8, tc_h=cs // 8,
                tc_cv1=csv // 4, tc_ch1=csv // 8, tc_cv2=csv // 4,
                tc_ch2=csv // 8, sao=1, nop_v=cs // 4, noq_v=cs // 4,
                nop_h=cs // 8, noq_h=cs // 8, nop_cv=csv // 4,
                noq_cv=csv // 4, nop_ch=csv // 8, noq_ch=csv // 8,
                nf4=cs // 4, nf4c=cs // 4, st_b0=csv, st_b2=csv, st_a3=csv)


def _band_rows(a, g: int, rb: int, unit: int):
    """Rows [(g * rb - 1) * unit, (g * rb + rb + 1) * unit) of `a` (numpy
    or torch), zero outside it: band g with its one-CTB halo above and
    below."""
    lo = (g * rb - 1) * unit
    n = (rb + 2) * unit
    if isinstance(a, np.ndarray):
        out = np.zeros((n,) + a.shape[1:], a.dtype)
    else:
        out = a.new_zeros((n,) + tuple(a.shape[1:]))
    src_lo, src_hi = max(lo, 0), min(lo + n, a.shape[0])
    if src_hi > src_lo:
        out[src_lo - lo:src_hi - lo] = a[src_lo:src_hi]
    return out


def band_filters(y, cb, cr, plan, args, *, devices, out_device=None):
    """The in-loop filters of one picture, band-sharded over the tile
    axis: band g (CTB rows [g * rb, (g + 1) * rb), rb = ceil(ctbs_h / T),
    T = len(devices)) is deblocked and SAO'd on devices[g] with a one-CTB
    halo (more than the 12 rows that deblock + SAO reach) by
    `plan.apply`; each of the filters' arguments is cut per band by
    `band_units` and goes to that device; `ybounds` holds the picture's
    true top and bottom rows in band coordinates, so the SAO edge classes
    stop at the picture and not at the halo. The bands' interiors make
    up the result, on out_device (y's by default).

    y [H, W], cb / cr [Hc, Wc] int32, the unfiltered picture; plan: its
    `FilterPlan` (device route); args: `plan.args`, whose arrays are
    numpy (uploaded in one copy a band) or tensors (the per-edge
    parameters, cut and copied to the band's device). Returns filtered
    (y, cb, cr) int32."""
    out_device = y.device if out_device is None else out_device
    T = len(devices)
    H, W = y.shape
    Hc, Wc = cb.shape
    cs = plan.cs
    csv = cs >> plan.vs
    ctbs_h = -(-H // cs)
    rb = -(-ctbs_h // T)
    units = band_units(cs, csv)
    outs = [torch.empty((H, W), dtype=torch.int32, device=out_device),
            torch.empty((Hc, Wc), dtype=torch.int32, device=out_device),
            torch.empty((Hc, Wc), dtype=torch.int32, device=out_device)]
    for g, dev in enumerate(devices):
        lo = g * rb * cs
        if lo >= H:
            break                        # rb * T CTB rows pass the picture
        cut = {k: _band_rows(a, g, rb, units[k]) for k, a in args.items()}
        fb = upload({k: a for k, a in cut.items()
                     if isinstance(a, np.ndarray)}, dev)
        fb.update((k, a.to(dev)) for k, a in cut.items()
                  if not isinstance(a, np.ndarray))
        planes = [_band_rows(p, g, rb, u).to(dev)
                  for p, u in ((y, cs), (cb, csv), (cr, csv))]
        ybounds = ((cs - lo, H + cs - lo),
                   (csv - g * rb * csv, Hc + csv - g * rb * csv))
        got = plan.apply(*planes, fb, ybounds=ybounds)
        for out, p, unit in zip(outs, got, (cs, csv, csv)):
            a = g * rb * unit
            b = min((g + 1) * rb * unit, out.shape[0])
            out[a:b] = p[unit:unit + b - a].to(out_device)
    return tuple(outs)


class MeshFrameDecoder:
    """reconstruct_wave(fs_list, refs_list) -> (one `TorchPlanes` per
    member, on its frame shard's first device; per member, whether its
    in-loop filters ran on the device)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.n_frame = int(mesh.shape["frame"])
        self.n_tile = int(mesh.shape.get("tile", 1))
        self._engines = {}             # torch.device -> TorchEngine

    def engine(self, device):
        """The one TorchEngine of a device of the mesh."""
        if device not in self._engines:
            self._engines[device] = TorchEngine(device)
        return self._engines[device]

    def _shard_devices(self, i: int) -> list:
        """Devices of frame shard i: [tile shard 0, 1, ...]."""
        row = self.mesh.devices[i % self.n_frame]
        return list(row) if self.n_tile > 1 else [row]

    def reconstruct_wave(self, fs_list, refs_list=None):
        """All pictures share one SPS and are mutually independent (no
        member references another member). refs_list: per picture {poc:
        planes} of its references (decoded pictures as `TorchPlanes`,
        the inter-layer reference of an SHVC EL picture among them).
        Returns (outs, filtered): outs[i] is member i's `TorchPlanes`,
        filtered[i] whether its in-loop filters ran on the device (False
        for a picture without filters and for one of the host-filter
        route, which comes back filtered on the host)."""
        if refs_list is None:
            refs_list = [None] * len(fs_list)
        if self.n_tile == 1:
            ks = []
            for i, (fs, refs) in enumerate(zip(fs_list, refs_list)):
                eng = self.engine(self._shard_devices(i)[0])
                k = eng.prepare(fs, refs)
                eng.launch(k)
                ks.append((eng, k))
            outs = [eng.finish(fs, k) for fs, (eng, k) in zip(fs_list, ks)]
        else:
            shards = []
            for i, (fs, refs) in enumerate(zip(fs_list, refs_list)):
                gmap = tile_group_map(fs, self.n_tile)
                ks = []
                for g, dev in enumerate(self._shard_devices(i)):
                    eng = self.engine(dev)
                    ks.append(eng.prepare(fs, refs, shard=(gmap, g)))
                    eng.launch(ks[-1])
                shards.append((gmap, ks))
            outs = [self._combine_and_filter(fs, gmap, ks,
                                             self._shard_devices(i))
                    for i, (fs, (gmap, ks)) in enumerate(zip(fs_list,
                                                             shards))]
        return outs, [o.device_filtered for o in outs]

    def _combine_and_filter(self, fs, gmap, ks, devices):
        """One member on the tile axis: the masked combine of its tile
        shards' planes on devices[0], then its filters (band-sharded over
        `devices`, or the host-filter route), crop and downcast."""
        sps = fs.sps
        H, W, Hc, Wc = ks[0]["dims"]
        hs, vs, bd = sps.hshift1, sps.vshift1, sps.bit_depth
        cs = 1 << sps.log2_ctb
        dev0 = devices[0]
        gm = torch.from_numpy(gmap).to(dev0)
        ml = _expand(gm, cs, cs, H, W)
        mc = _expand(gm, cs >> vs, cs >> hs, Hc, Wc)
        y = ks[0]["luma"][OY:OY + H, OX:OX + W]
        cb = ks[0]["chroma"][0, OY:OY + Hc, OX:OX + Wc]
        cr = ks[0]["chroma"][1, OY:OY + Hc, OX:OX + Wc]
        for g, k in enumerate(ks[1:], 1):
            luma = k["luma"].to(dev0)
            chroma = k["chroma"].to(dev0)
            y = torch.where(ml == g, luma[OY:OY + H, OX:OX + W], y)
            cb = torch.where(mc == g, chroma[0, OY:OY + Hc, OX:OX + Wc], cb)
            cr = torch.where(mc == g, chroma[1, OY:OY + Hc, OX:OX + Wc], cr)
        plan = plan_filters(fs)
        if plan is not None and plan.route == "host":
            return host_filtered(fs, pack_planes(y, cb, cr, bd), H, W, Hc,
                                 Wc)
        if plan is not None:
            # the per-edge parameters, made on devices[0] from the plan's
            # grids as the engine makes them
            args = plan.args(upload(plan.grids, dev0))
            y, cb, cr = band_filters(y, cb, cr, plan, args, devices=devices,
                                     out_device=dev0)
        return TorchPlanes(pack_planes(y, cb, cr, bd), H, W, Hc, Wc,
                           device_filtered=plan is not None)
