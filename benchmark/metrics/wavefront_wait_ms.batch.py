"""ms a picture that the native core's wavefront workers spent waiting on
the CTB row above (the spin waits of `decode_wpp_row` in
native/hevcparse.cc, summed over its workers): the `wave_wait_us` of
the program's `parse` spans in the traced window, added, over the
window's pictures (`hevcbench/spans.py`). None where the program's
spans carry no such figure, as a program that does not report it."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    got = [] if w is None else [s for s in w.named(("parse",))
                                if "wave_wait_us" in s.attrs]
    if not got:
        return None
    return w.per_picture(sum(s.attrs["wave_wait_us"] for s in got) / 1e3)
