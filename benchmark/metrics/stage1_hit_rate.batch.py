"""Share of the reference planes that MC stage 1 found in its cache
(ops/mc.py via models/pipeline.py Stage1Cache), in %: the hits over the
hits and misses that the program's `mc_stage1` spans in the traced
window carry (`hevcbench/spans.py`). None without inter pictures, or
where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    hits = w.counter("mc_stage1", "hits")
    total = hits + w.counter("mc_stage1", "misses")
    return 100.0 * hits / total if total else None
