"""Share of the card's HBM roofline that the intra kernels reach in the
traced window: the least time the window's intra work could take (the
bytes that `hevcbench/work.py` counts from the parsed pictures, over the
card's published bandwidth) over the device time of the kernels whose
name holds "intra_fused" (csrc/intra_fused*.cu), in %. None without a
kernel in the trace, without intra work, or on a card with no entry in
`hevcbench/peaks.py`."""

KERNEL = "intra_fused"


def read(r):
    busy = r.device_s(KERNEL)
    if not busy or not r.intra_bytes or r.hbm_bytes_per_s is None:
        return None
    return 100.0 * r.intra_bytes / r.hbm_bytes_per_s / busy
