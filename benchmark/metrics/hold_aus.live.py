"""Mean number of decode() calls from the call that fed a picture's
access unit to the call whose `output` returned it (the parse-ahead depth
and the pending reconstruction), over the display layer's pictures in
the traced window; pictures that flush() returned are left out
(`hevcbench/spans.py`). None where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.hold()
