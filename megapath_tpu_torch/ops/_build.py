"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The role ``megapath_tpu/native/build.py`` plays for the host C++ code:
``csrc/*.cu`` compile at first use into one shared library with a plain
C interface, ``build/kernels/libmegapath_kernels.so`` under the checkout
(``build/`` is git-ignored). The library is rebuilt when a source is
newer than it. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libmegapath_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources())


def build(force: bool = False) -> float:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` if it is missing, stale or
    ``force`` is set. Returns the seconds spent; the compiler's output
    (ptxas register and spill counts) goes to ``LOG_PATH``. Raises
    RuntimeError when nvcc fails."""
    if not (force or stale()):
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a temporary name and rename, so a process that loads the
    # library never sees a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    LOG_PATH.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed, with every entry
    point's argument and result types declared."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mp_dp_full.argtypes = [vp] * 9 + [ci] * 7 + [vp]
        lib.mp_dp_full.restype = ci
        lib.mp_dp_full_max_width.argtypes = []
        lib.mp_dp_full_max_width.restype = ci
        _lib = lib
    return _lib
