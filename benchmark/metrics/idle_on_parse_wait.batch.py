"""Share of the traced window, in %, in which the device is idle (no
kernel, memcpy or memset: gaps in the union of the trace's device
intervals) while the decoding thread's innermost span is the program's
`parse_wait` (its self time), the spans moved onto the trace's clock
(`hevcbench/spans.py`). None without device intervals, or where the
program records no such span."""
from hevcbench import spans


def read(r):
    if r.busy_s is None or not r.device_ops or not r.window_s:
        return None
    w = spans.window(r)
    if w is None or not w.named(("parse_wait",)):
        return None
    base = spans.base_ns()
    if base is None:
        return None
    return w.idle_share("parse_wait", r.device_ops, r.window_s * 1e6, base)
