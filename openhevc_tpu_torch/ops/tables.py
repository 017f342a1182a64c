"""Constant tables of the device half: the decoder's only "parameters".

Own copies (built here from the spec's definitions) of the inverse
transform matrices (H.265 8.6.4.2), the dequant level scales (8.6.3),
the coefficient scan LUTs of the scan-prefix payload format, and the
intra angle tables (Tables 8-4 / 8-5). `numpy_tables()` gives them as a
flat dict of numpy arrays; `tables_from_numpy()` turns such a dict
(from this module or any other source with the same keys) into the
torch tensors the port's device code indexes.
"""
from __future__ import annotations

import numpy as np
import torch

SIZES = (4, 8, 16, 32)

# ---- inverse transforms ----------------------------------------------------
# magnitudes of odd-index basis values per size (first columns of odd rows)
_ODDS = {
    4: (83, 36),
    8: (89, 75, 50, 18),
    16: (90, 87, 80, 70, 57, 43, 25, 9),
    32: (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4),
}


def _base_vals(n: int) -> list[int]:
    if n == 2:
        return [64, 64, 0]
    prev = _base_vals(n // 2)
    out = [0] * (n + 1)
    for j in range(0, n + 1, 2):
        out[j] = prev[j // 2]
    for i, j in enumerate(range(1, n, 2)):
        out[j] = _ODDS[n][i]
    return out


def dct_matrix(n: int) -> np.ndarray:
    """DCT basis M[k][j] (rows = basis vectors), int32."""
    base = _base_vals(n)
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            a = (k * (2 * j + 1)) % (4 * n)
            if a > 2 * n:
                a = 4 * n - a
            m[k, j] = -base[2 * n - a] if a > n else base[a]
    return m


DCT = {n: dct_matrix(n) for n in SIZES}
# inverse-DST stage matrix A (transform_4x4_luma): out = A @ in
DST4 = np.array([[29, 74, 84, 55],
                 [55, 74, -29, -84],
                 [74, 0, -74, 74],
                 [84, -74, 55, -29]], dtype=np.int32)
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)


# ---- coefficient scan (6.5.3: 4x4 groups, up-right diagonal) ---------------
def _diag(n):
    out = []
    x = y = 0
    while len(out) < n * n:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return out


def _scan_raster(s):
    """scan[i] = raster index of the i-th scanned coefficient."""
    cg = _diag(s // 4) if s > 4 else [(0, 0)]
    idx = np.empty(s * s, np.int32)
    i = 0
    for (cx, cy) in cg:
        for (ix, iy) in _diag(4):
            idx[i] = (cy * 4 + iy) * s + cx * 4 + ix
            i += 1
    return idx


SCAN = {s: _scan_raster(s) for s in SIZES}
INV_SCAN = {}
for _s, _sc in SCAN.items():
    _inv = np.empty(_s * _s, np.int32)
    _inv[_sc] = np.arange(_s * _s, dtype=np.int32)
    INV_SCAN[_s] = _inv

# ---- intra angles -----------------------------------------------------------
# intraPredAngle for modes 2..34 (Table 8-4)
ANGLES = (32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
          -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32)
# invAngle for negative angles (Table 8-5), keyed by angle
INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
             -21: -390, -26: -315, -32: -256}
# per-mode rows of the kernel meta (modes 0/1 carry 0)
ANG = np.zeros(35, np.int32)
ANG[2:] = ANGLES
INV = np.zeros(35, np.int32)
for _m in range(2, 35):
    INV[_m] = INV_ANGLE.get(ANGLES[_m - 2], 0)


def numpy_tables() -> dict[str, np.ndarray]:
    """Every constant table as a flat {name: numpy array} dict."""
    d = {"DST4": DST4, "LEVEL_SCALE": LEVEL_SCALE, "ANG": ANG, "INV": INV}
    for s in SIZES:
        d[f"DCT{s}"] = DCT[s]
        d[f"SCAN{s}"] = SCAN[s]
        d[f"INV_SCAN{s}"] = INV_SCAN[s]
    return d


TABLE_KEYS = tuple(sorted(numpy_tables()))


def tables_from_numpy(d: dict) -> dict[str, torch.Tensor]:
    """Flat {name: numpy array} -> {name: CPU int64 tensor}, holding the
    same integers. Raises on a missing or unknown key, or a shape that
    differs from this module's own table."""
    own = numpy_tables()
    if set(d) != set(own):
        raise KeyError(f"table keys differ: {sorted(set(d) ^ set(own))}")
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if a.shape != own[k].shape:
            raise ValueError(f"{k}: shape {a.shape} != {own[k].shape}")
        out[k] = torch.from_numpy(a.astype(np.int64))
    return out


TABLES = tables_from_numpy(numpy_tables())

# ---- inter prediction interpolation filters (8.5.3.3.3, Tables 8-11/8-12) --
# Rows are the fractional phases 1.. (phase 0 is a plain copy); numpy, like
# everything above, and outside `numpy_tables()`: ops/mc.py turns them into
# its all-phase matrices.
QPEL_FILTERS = np.array([
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int64)
EPEL_FILTERS = np.array([
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], np.int64)

# ---- deblocking thresholds (8.7.2.5.3, Table 8-12: tc' and beta' by Q) ------
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], np.int32)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34,
    36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)
