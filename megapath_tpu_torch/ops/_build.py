"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The role ``megapath_tpu/native/build.py`` plays for the host C++ code:
``csrc/*.cu`` compile at first use into one shared library with a plain
C interface, ``build/kernels/libmegapath_kernels.so`` under the checkout
(``build/`` is git-ignored). Each source compiles in its own nvcc
process, all started together, and one more nvcc links the objects. The
library is rebuilt when a source is newer than it. Nothing is built or
loaded when this module is imported. ``load`` and ``count`` may be called
from several threads at once (the pipeline aligns its shards from a
thread pool).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libmegapath_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the seed walk's float32 tests must round as the JAX walk rounds them:
# no multiply-add contraction in that file
EXTRA_FLAGS = {"mmp_seed.cu": ("-fmad=false",)}

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()


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
    ``force`` is set. Returns the seconds spent; the compilers' output
    (ptxas register and spill counts) goes to ``LOG_PATH``. Raises
    RuntimeError when an nvcc fails."""
    if not (force or stale()):
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmpdir) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(src.name, ()), "-c",
                   "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
            objs.append(str(obj))
        log, failed = [], []
        for cmd, proc in procs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
        if not failed:
            # link to a temporary name and rename, so a process that loads
            # the library never sees a half-written file
            tmp = str(Path(tmpdir) / LIB_PATH.name)
            cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
            else:
                os.replace(tmp, LIB_PATH)
        LOG_PATH.write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def _signatures() -> dict:
    """Every entry point's (argument types, result type)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {
        "mp_dp_full": ([vp] * 9 + [ci] * 7 + [vp], ci),
        "mp_dp_fwd": ([vp] * 7 + [ci] * 7 + [vp], ci),
        "mp_dp_full_max_width": ([], ci),
        "mp_mmp_seed": ([vp] * 11 + [ci] * 12 + [cf, ci, cf, cf, ci, ci, vp], ci),
        "mp_locate": ([vp] * 6 + [ci] * 3 + [vp], ci),
        "mp_sw_subst": ([vp] * 11 + [ci] * 7 + [vp], ci),
        "mp_sw_subst_tile_rows": ([], ci),
        "mp_sw_subst_occupancy": ([vp], ci),
        "mp_sort_pairs_temp_bytes": ([ci, ci, ctypes.POINTER(ctypes.c_size_t)], ci),
        "mp_sort_pairs": ([vp, ctypes.c_size_t] + [vp] * 4 + [ci, ci,
                          ctypes.POINTER(ctypes.c_int), vp], ci),
    }


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Declare the argument and result types of ``names`` (default: every
    entry point) on ``lib``."""
    sigs = _signatures()
    for name in names or sigs:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sigs[name]
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed, with every entry
    point's argument and result types declared. Threads that call it at
    once wait for one build and one load."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                build()
                _lib = bind(ctypes.CDLL(str(LIB_PATH)))
    return _lib


def count(module, name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``module.name`` (a kernel's launches, or the
    pairs a stage handled). A bare ``+= 1`` on a module global can lose
    counts when pool threads launch at once; the counts show that a path
    went through its kernels, so they must be exact. Resetting a count is
    a plain assignment."""
    with _count_lock:
        setattr(module, name, getattr(module, name) + n)
