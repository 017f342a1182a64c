"""ms a picture of the engine on the host (models/pipeline.py
TorchEngine.reconstruct: every stage's host time, unsynchronised): the
program's `reconstruct` spans in the traced window, both layers added
(`hevcbench/spans.py`). None where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.ms(("reconstruct",))
