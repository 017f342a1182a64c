"""Terminal display sink — the `main_hm/sdl.c` role without SDL.

The reference CLI displays decoded frames in an SDL window and paces
playback with SDL_framerate.c. This environment has no display server,
so the display path renders frames as ANSI 24-bit-color half-block
cells (two pixels per character cell via '▀' with independent
foreground/background) directly to the terminal, downsampled to the
terminal width, paced to the stream frame rate (VUI timing when
present). Zero dependencies; works over ssh.

Also provides the yuv4mpeg2 (.y4m) writer — the pipe-friendly display
form every player understands (`mpv out.y4m`).
"""
from __future__ import annotations

import sys
import time

import numpy as np


def yuv_to_rgb(y, u, v, bit_depth=8):
    """BT.601 limited-range integer conversion to 8-bit RGB.
    y: [H, W]; u, v: [H, W] (already upsampled to luma size)."""
    sh = bit_depth - 8
    yy = (np.asarray(y, np.int32) >> sh) - 16
    uu = (np.asarray(u, np.int32) >> sh) - 128
    vv = (np.asarray(v, np.int32) >> sh) - 128
    r = (298 * yy + 409 * vv + 128) >> 8
    g = (298 * yy - 100 * uu - 208 * vv + 128) >> 8
    b = (298 * yy + 516 * uu + 128) >> 8
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _nearest(plane, h, w):
    plane = np.asarray(plane)
    ys = (np.arange(h) * plane.shape[0]) // h
    xs = (np.arange(w) * plane.shape[1]) // w
    return plane[ys][:, xs]


def render_frame(planes, bit_depth=8, cols=80):
    """[Y, U, V] planes (any chroma subsampling) -> ANSI art string of
    `cols` character columns, two pixels per cell row ('▀')."""
    y = np.asarray(planes[0])
    H, W = y.shape
    rows2 = max(2, (cols * H * 10 // (W * 21)) * 2)   # ~2.1:1 cell aspect
    ys = _nearest(y, rows2, cols)
    us = _nearest(planes[1], rows2, cols)
    vs = _nearest(planes[2], rows2, cols)
    rgb = yuv_to_rgb(ys, us, vs, bit_depth)
    out = []
    for r in range(0, rows2, 2):
        t, b = rgb[r], rgb[r + 1]
        line = []
        for c in range(cols):
            line.append("\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm▀"
                        % (t[c, 0], t[c, 1], t[c, 2],
                           b[c, 0], b[c, 1], b[c, 2]))
        out.append("".join(line))
    return "\x1b[0m\n".join(out) + "\x1b[0m"


class TerminalDisplay:
    """Paced terminal playback (SDL_framerate.c role: keep the display
    at the stream rate; drop pacing when decode is slower)."""

    def __init__(self, fps=25.0, cols=None, out=None):
        self.fps = fps or 25.0
        if cols is None:
            try:
                import shutil
                cols = min(shutil.get_terminal_size().columns, 100)
            except Exception:
                cols = 80
        self.cols = cols
        self.out = out or sys.stdout
        self._next = None
        self._shown = 0

    def show(self, planes, bit_depth=8):
        now = time.perf_counter()
        if self._next is None:
            self._next = now
        if now < self._next:                 # pace to the frame rate
            time.sleep(self._next - now)
        self._next = max(self._next + 1.0 / self.fps, now)
        art = render_frame(planes, bit_depth, self.cols)
        home = "\x1b[H" if self._shown else "\x1b[2J\x1b[H"
        self.out.write(home + art + "\n")
        self.out.flush()
        self._shown += 1


# ---- yuv4mpeg2 --------------------------------------------------------

_Y4M_CHROMA = {(1, 1): "420jpeg", (1, 0): "422", (0, 0): "444"}


def y4m_header(width, height, fps_num=25, fps_den=1, hs=1, vs=1,
               bit_depth=8):
    c = _Y4M_CHROMA.get((hs, vs), "420jpeg")
    if bit_depth > 8:
        c += "p%d" % bit_depth
    return ("YUV4MPEG2 W%d H%d F%d:%d Ip A0:0 C%s\n"
            % (width, height, fps_num, fps_den, c)).encode()


def y4m_frame(planes, bit_depth=8):
    dt = "<u2" if bit_depth > 8 else np.uint8
    return b"FRAME\n" + b"".join(
        np.ascontiguousarray(np.asarray(p).astype(dt)).tobytes()
        for p in planes)
