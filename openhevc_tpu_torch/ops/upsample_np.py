"""SHVC inter-layer prediction, host parts (numpy; SHM resampler).

The 16-phase interpolation tables of the inter-layer upsampler (8-tap
luma, 4-tap chroma; upsample_base_layer_frame, hevcdsp_template.c:2164),
the scale / offset derivation (hevc.c:475-485)

  scale = ((BL << 16) + (EL >> 1)) // EL
  add = ((phase * scale + 2) >> 2) + (1 << 11)

and the inter-layer motion field mapping. The plane upsampler itself runs
on the device (ops/upsample.py).
"""
from __future__ import annotations

import numpy as np

UP_FILTER_LUMA = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0]], np.int64)

UP_FILTER_CHROMA = np.array([
    [0, 64, 0, 0],
    [-2, 62, 4, 0],
    [-2, 58, 10, -2],
    [-4, 56, 14, -2],
    [-4, 54, 16, -2],
    [-6, 52, 20, -2],
    [-6, 46, 28, -4],
    [-4, 42, 30, -4],
    [-4, 36, 36, -4],
    [-4, 30, 42, -4],
    [-4, 28, 46, -6],
    [-2, 20, 52, -6],
    [-2, 16, 54, -4],
    [-2, 14, 56, -4],
    [-2, 10, 58, -2],
    [0, 4, 62, -2]], np.int64)


def scale_add(bl: int, el: int, phase: int = 0):
    scale = ((bl << 16) + (el >> 1)) // el
    add = ((phase * scale + 2) >> 2) + (1 << 11)
    return scale, add



def upscale_mv_field(bl_motion, bl_w, bl_h, el_w, el_h, grid_h4, grid_w4,
                     nb_list):
    """Inter-layer motion field mapping (ff_upscale_mv_block,
    hevc_filter.c:1311, whole-frame): per 16x16 EL block, sample the BL
    motion at the center-mapped 16-aligned position; SNR copies the
    MvField, spatial scales MVs by ScalingFactor = ((EL<<8)+(BL>>1))//BL
    per axis (clip +-4096 then +-32768 on the product>>8). nb_list: 1
    for P EL slices (the reference then scales list 0 only but still
    copies the full pred_flag — reproduced). Returns (pred_flag4, mv4,
    refpoc4) grids of [grid_h4, grid_w4] shape."""
    pf_b = np.asarray(bl_motion[0])
    mv_b = np.asarray(bl_motion[1], np.int64)
    poc_b = np.asarray(bl_motion[2])
    scale_x = ((bl_w << 16) + (el_w >> 1)) // el_w
    scale_y = ((bl_h << 16) + (el_h >> 1)) // el_h
    sf_x = int(np.clip(((el_w << 8) + (bl_w >> 1)) // bl_w, -4096, 4095))
    sf_y = int(np.clip(((el_h << 8) + (bl_h >> 1)) // bl_h, -4096, 4095))
    snr = scale_x == 65536 and scale_y == 65536
    # vectorized over the 16x16 EL block grid
    x_el = np.arange(0, el_w, 16)
    y_el = np.arange(0, el_h, 16)
    x_bl = ((np.minimum(x_el + 8, el_w - 1) * scale_x + (1 << 15))
            >> 16) + 4
    y_bl = ((np.minimum(y_el + 8, el_h - 1) * scale_y + (1 << 15))
            >> 16) + 4
    valid = (y_bl[:, None] < bl_h) & (x_bl[None, :] < bl_w)
    b4y = np.minimum((y_bl >> 4) << 2, pf_b.shape[0] - 1)
    b4x = np.minimum((x_bl >> 4) << 2, pf_b.shape[1] - 1)
    pfb = np.where(valid, pf_b[b4y[:, None], b4x[None, :]], 0)
    mvb = mv_b[b4y[:, None], b4x[None, :]]        # [ny, nx, 2, 2]
    pocb = poc_b[b4y[:, None], b4x[None, :]]      # [ny, nx, 2]
    if snr:
        mv_blk = mvb.astype(np.int32)
        poc_blk = pocb
    else:
        p = mvb * np.array([sf_x, sf_y], np.int64)     # per-axis product
        mv_blk = np.clip((p + 127 + (p < 0)) >> 8,
                         -32768, 32767).astype(np.int32)
        if nb_list < 2:
            mv_blk[:, :, 1] = 0
        poc_blk = pocb.copy()
        if nb_list < 2:
            poc_blk[:, :, 1] = 0
    live = pfb != 0
    mv_blk = np.where(live[..., None, None], mv_blk, 0)
    poc_blk = np.where(live[..., None], poc_blk, 0)
    rep = lambda a: np.repeat(np.repeat(a, 4, 0), 4, 1)  # noqa: E731
    pf = np.zeros((grid_h4, grid_w4), np.uint8)
    mv = np.zeros((grid_h4, grid_w4, 2, 2), np.int32)
    poc = np.zeros((grid_h4, grid_w4, 2), np.int32)
    h = min(grid_h4, pfb.shape[0] * 4)
    w = min(grid_w4, pfb.shape[1] * 4)
    pf[:h, :w] = rep(pfb.astype(np.uint8))[:h, :w]
    mv[:h, :w] = rep(mv_blk)[:h, :w]
    poc[:h, :w] = rep(poc_blk)[:h, :w]
    return pf, mv, poc
