"""Build-at-first-use for the port's native libraries.

Both shared libraries (the C++ parse core and the CUDA kernels) are
compiled from the package's own sources into `openhevc_tpu_torch/build/`
(git-ignored) the first time they are needed. Several processes may ask
at once (pytest-xdist workers), so the compile runs under an exclusive
file lock and lands with an atomic rename.
"""
from __future__ import annotations

import fcntl
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "build")


def build_once(out: str, sources: list[str], cmd_for) -> str:
    """Compile `out` from `sources` unless it is newer than all of them.
    cmd_for(tmp_out) returns the compiler argv writing to tmp_out.
    Returns the compiler's stderr (empty when nothing was built)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)

    def fresh():
        return os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in sources)

    if fresh():
        return ""
    with open(out + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if fresh():
            return ""
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {os.path.basename(out)} failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return proc.stderr
