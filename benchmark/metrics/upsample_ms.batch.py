"""ms a picture of the inter-layer reference (ops/upsample.py,
ops/upsample_np.py): the program's `upsample` and `il_motion` spans in
the traced window, over the enhancement layer's pictures
(`hevcbench/spans.py`). None with one layer, or where the program
records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.ms(("upsample", "il_motion"))
