"""ms a picture of delivery where the program does it: its `crop_pack`
(models/pipeline.py) and `fetch` (`TorchPlanes.get`, the copy to the
host) spans in the traced window, both layers added
(`hevcbench/spans.py`). None where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.ms(("crop_pack", "fetch"))
