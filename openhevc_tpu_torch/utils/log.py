"""Logging.

The reference exposes av_log levels via libOpenHevcSetDebugMode
(openHevcWrapper.c:400 -> av_log_set_level(AV_LOG_DEBUG)) and prints
wall-clock fps in the CLI (main_hm/main.c:304-306). This module is the
decoder's equivalent observability surface:

  - av_log-style level gate (`set_level` / `log`), mapped onto Python's
    `logging` under the "openhevc_tpu_torch" logger so host applications can
    route it.

The decoder's spans (the SURVEY §5 tracing requirement) are in
`utils/trace.py`.
"""
from __future__ import annotations

import logging

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
