"""Logging + per-stage decode tracing.

The reference exposes av_log levels via libOpenHevcSetDebugMode
(openHevcWrapper.c:400 -> av_log_set_level(AV_LOG_DEBUG)) and prints
wall-clock fps in the CLI (main_hm/main.c:304-306). This module is the
decoder's equivalent observability surface:

  - av_log-style level gate (`set_level` / `log`), mapped onto Python's
    `logging` under the "openhevc_tpu_torch" logger so host applications can
    route it.
  - `StageTimers`: per-frame wall-clock accumulation for the decode
    pipeline stages (parse / pack / upload / kernel / filter / fetch),
    the SURVEY §5 tracing requirement. Cheap enough to stay always-on:
    one perf_counter pair per stage per frame.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager

# av_log level values (libavutil/log.h)
QUIET, PANIC, FATAL, ERROR, WARNING, INFO, VERBOSE, DEBUG, TRACE = (
    -8, 0, 8, 16, 24, 32, 40, 48, 56)

_logger = logging.getLogger("openhevc_tpu_torch")
_level = WARNING

_PY_LEVEL = {
    PANIC: logging.CRITICAL, FATAL: logging.CRITICAL, ERROR: logging.ERROR,
    WARNING: logging.WARNING, INFO: logging.INFO, VERBOSE: logging.INFO,
    DEBUG: logging.DEBUG, TRACE: logging.DEBUG,
}


def set_level(level: int):
    """av_log_set_level equivalent; also lowers the Python logger's
    threshold so gated records actually emit."""
    global _level
    _level = level
    _logger.setLevel(_PY_LEVEL.get(level, logging.WARNING))
    if level >= DEBUG and not _logger.handlers and not \
            logging.getLogger().handlers:
        logging.basicConfig(
            format="[%(name)s] %(levelname)s: %(message)s")


def get_level() -> int:
    return _level


def log(level: int, msg: str, *args):
    if level <= _level:
        _logger.log(_PY_LEVEL.get(level, logging.INFO), msg, *args)


class StageTimers:
    """Per-frame pipeline stage timers.

    Usage:
        t = StageTimers()
        with t.stage("parse"): ...
        t.frame_done()
        t.summary() -> {"parse_ms": mean, ..., "frames": n}
    """

    STAGES = ("parse", "pack", "upload", "kernel", "filter", "fetch")

    def __init__(self):
        self._cur = defaultdict(float)
        self._frames: list[dict] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._cur[name] += time.perf_counter() - t0

    def add(self, name: str, seconds: float):
        self._cur[name] += seconds

    def frame_done(self):
        if self._cur:
            self._frames.append(dict(self._cur))
            self._cur.clear()

    def reset(self):
        self._cur.clear()
        self._frames.clear()

    def summary(self) -> dict:
        """Mean ms per stage across completed frames."""
        out = {"frames": len(self._frames)}
        if not self._frames:
            return out
        keys = sorted({k for f in self._frames for k in f})
        for k in keys:
            tot = sum(f.get(k, 0.0) for f in self._frames)
            out[f"{k}_ms"] = round(1e3 * tot / len(self._frames), 3)
        return out

    def log_summary(self, level: int = VERBOSE):
        s = self.summary()
        log(level, "stage timers (mean ms/frame over %d): %s",
            s.pop("frames"), " ".join(f"{k}={v}" for k, v in s.items()))
