"""ms a picture of the decoder's own control work (decoder.py: NAL
split, slice headers, POC / RPS, reference lists, motion fields, output
order): the self time of the program's `decode` and `flush` spans in
the traced window, their length less their child spans on the same
thread (`hevcbench/spans.py`). None where the program records no such
span."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms(("decode", "flush"))
