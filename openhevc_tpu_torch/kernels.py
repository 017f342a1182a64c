"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (sm_90a) into a shared
library with a plain C interface under build/kernels/, at first use, and
loaded with ctypes. Nothing here runs at import time: the CPU tests
import every module on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import os
import shutil

from .buildutil import BUILD_DIR, PKG_DIR, build_once

SOURCES = {"intra_fused": "intra_fused.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, "kernels", f"lib{name}.so")


def build(name: str) -> str:
    """Compile kernel `name` if its library is missing or stale; returns
    nvcc's report (registers, shared memory, spills) or ''."""
    src = os.path.join(PKG_DIR, "csrc", SOURCES[name])
    return build_once(lib_path(name), [src],
                      lambda out: [_nvcc(), *NVCC_FLAGS, src, "-o", out])


def load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build(name)
        _libs[name] = ctypes.CDLL(lib_path(name))
    return _libs[name]
