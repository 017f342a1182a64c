"""Share of the in-loop filters' steps that the kernels ran (ops/filters.py
`apply_filters_device`, csrc/loop_filters.cu, called from
models/pipeline.py TorchEngine.finish), in %: the program's `deblock`
and `sao` spans in the traced window with attribute `kernel` 1 over all
of them (0: the plain PyTorch version `apply_filters_ref` filtered;
`hevcbench/spans.py`). None without a filtered picture, or where the
program's spans carry no `kernel` attribute."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    got = [] if w is None else [s for s in w.named(("deblock", "sao"))
                                if "kernel" in s.attrs]
    if not got:
        return None
    return 100.0 * sum(s.attrs["kernel"] == 1 for s in got) / len(got)
