"""ms a picture of the parse where the program does it: the program's
`parse` spans in the traced window (the parse-ahead worker's jobs and
the synchronous parses, on any thread), both layers added
(`hevcbench/spans.py`). None where the program records no such span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.ms(("parse",))
