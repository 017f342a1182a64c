"""Share of the window's native parses that ran threaded, in %: the
program's `parse` spans of route native that were handed 2 or
more substreams (WPP rows or tiles, by their entry points), ran on 2 or
more threads and did not fall back to the serial re-parse (attributes
`substreams`, `threads`, `fallback`; bitstream/native.py,
native/hevcparse.cc), over all of the window's native `parse` spans
(`hevcbench/spans.py`). None where the window has no native parse, or
where the program's spans do not say how it parsed."""
from hevcbench import spans


def read(r):
    w = spans.window(r)
    got = [] if w is None else [
        s for s in w.named(("parse",))
        if s.attrs.get("route") == "native" and "threads" in s.attrs]
    if not got:
        return None
    threaded = sum(s.attrs.get("substreams", 1) >= 2 and
                   s.attrs["threads"] >= 2 and s.attrs.get("fallback") == 0
                   for s in got)
    return 100.0 * threaded / len(got)
