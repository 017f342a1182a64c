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

SOURCES = {"intra_fused": "intra_fused.cu",
           "intra_fused_banded": "intra_fused_banded.cu",
           "edge_params": "edge_params.cu",
           "loop_filters": "loop_filters.cu"}
# the headers the intra sources include
HEADERS = ["intra_job.cuh", "intra_sched.cuh"]
INCLUDES = {"intra_fused": HEADERS, "intra_fused_banded": HEADERS}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, "kernels", f"lib{name}.so")


def build(name: str) -> str:
    """Compile kernel `name` if its library is missing or stale; returns
    nvcc's report (registers, shared memory, spills) or ''."""
    csrc = os.path.join(PKG_DIR, "csrc")
    src = os.path.join(csrc, SOURCES[name])
    deps = [src] + [os.path.join(csrc, h) for h in INCLUDES.get(name, [])]
    return build_once(lib_path(name), deps,
                      lambda out: [nvcc(), *NVCC_FLAGS, src, "-o", out])


def load(name: str, signatures=None) -> ctypes.CDLL:
    """Kernel library `name`, built at first use. signatures: {C function:
    argument types} to set, each returning a C int (an error code); a
    function the library lacks is skipped."""
    if name not in _libs:
        build(name)
        _libs[name] = ctypes.CDLL(lib_path(name))
    lib = _libs[name]
    for fn, types in (signatures or {}).items():
        f = getattr(lib, fn, None)
        if f is not None and f.argtypes is None:
            f.argtypes = types
            f.restype = ctypes.c_int
    return lib
