"""Share of the deblocking filter's per-edge parameter sets that the
device made (ops/filters.py `edge_params`, called from
models/pipeline.py TorchEngine.prepare), in %: the program's
`edge_params` spans in the traced window with attribute `kernel` 1 over
all of them (0: the host's numpy `prep_filters` made them;
`hevcbench/spans.py`). None without a deblocked picture, or where the
program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    got = [] if w is None else w.named(("edge_params",))
    if not got:
        return None
    return 100.0 * sum(s.attrs.get("kernel") == 1 for s in got) / len(got)
