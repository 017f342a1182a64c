"""Published peaks of the cards the benchmark knows, by the name that
`torch.cuda.get_device_name()` gives. A card that is not listed has no
roofline: its shares are not measured."""
from __future__ import annotations

PEAKS = {
    # NVIDIA H100 SXM data sheet, HBM3 at 3.35 TB/s (at 700 W)
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")
