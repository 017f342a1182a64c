"""ms a picture of the host parse alone (the native CABAC core and the
decoder's parse-ahead thread, no reconstruction), over one session of
the cell's traffic, on the host clock. None for two layers: the
enhancement layer's parse needs the base layer's pictures."""


def read(r):
    return r.parse_ms
