"""Typed decoder configuration (SURVEY §5: one config dataclass
replacing the reference's three-tier AVOption / compile-flag / getopt
system, hevc.c:4534-4546 + options_table.h + main_hm/getopt.c).

Every knob has one authoritative home here; environment variables
(OPENHEVC_*) remain as overrides for the threading knobs and fill unset
fields via `DecoderConfig.from_env()`. Constructor keyword arguments on
`Decoder` keep working and take precedence.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class DecoderConfig:
    # -- engine -----------------------------------------------------------
    engine: str = "torch"          # the PyTorch pipeline (the only one)
    device: str = "cuda"           # torch device; "cpu" only on request

    # -- threading (openHevcWrapper.c:80-90 knobs) ------------------------
    # nb_threads + thread_type: 1=frame (parse-ahead depth),
    # 2=slice/wpp (native substream workers), 3=frameslice (both)
    nb_threads: int | None = None
    thread_type: int = 3
    # direct overrides (None = derive from nb_threads/thread_type)
    parse_ahead: int | None = None     # decode pipeline depth
    parse_threads: int | None = None   # native WPP/tile substream workers

    # -- stream interpretation (AVOptions, hevc.c:4534-4546) --------------
    temporal_layer: int | None = None  # "temporal-layer-id"
    strict: bool = False               # err_recognition AV_EF_EXPLODE

    # -- parallel scale-out ----------------------------------------------
    mesh: object | None = None         # parallel.DeviceMesh (frame[,tile])
    wave_depth: int | None = None      # max pictures per wave

    @classmethod
    def from_env(cls, **overrides) -> "DecoderConfig":
        """Config with OPENHEVC_* environment fallbacks applied to any
        field not given in overrides."""
        def envi(name):
            v = os.environ.get(name)
            return int(v) if v not in (None, "") else None

        cfg = cls(**overrides)
        if cfg.parse_ahead is None:
            cfg.parse_ahead = envi("OPENHEVC_PARSE_AHEAD")
        if cfg.parse_threads is None:
            cfg.parse_threads = envi("OPENHEVC_PARSE_THREADS")
        return cfg

    def resolved_threads(self) -> tuple[int, int]:
        """(parse_ahead_depth, native_parse_threads) from the wrapper-
        style nb_threads/thread_type knobs plus direct overrides."""
        depth, workers = 2, 0          # defaults (0 = native auto)
        if self.nb_threads is not None and self.nb_threads >= 1:
            n = int(min(self.nb_threads, 8))
            if self.thread_type == 1:
                depth, workers = max(1, n), 1
            elif self.thread_type == 2:
                depth, workers = 1, n
            else:
                depth, workers = max(2, min(n, 4)), n
        if self.parse_ahead is not None:
            depth = max(1, int(self.parse_ahead))
        if self.parse_threads is not None:
            workers = max(0, int(self.parse_threads))
        return depth, workers
