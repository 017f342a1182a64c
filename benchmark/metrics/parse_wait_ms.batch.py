"""ms a picture that the decoding thread waits on the parse-ahead queue:
the program's `parse_wait` spans in the traced window, both layers added
(`hevcbench/spans.py`). None where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.ms(("parse_wait",))
