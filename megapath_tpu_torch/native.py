"""Build the port's host C++ libraries with g++ and load them with ctypes.

The port's counterpart of ``megapath_tpu/native/build.py`` for the two
host libraries the pipeline runs: ``csrc/host/bbduk.cpp`` (the bbduk
entropy and quality-trim scans) and ``csrc/host/spike.cpp`` (the SPIKE
moments fold). Each compiles at first use into
``build/host/lib<name>.so`` under the checkout (``build/`` is git-ignored)
and is rebuilt when its source is newer than it. There is no fallback: a
library that cannot be built or loaded raises. Nothing is built or loaded
when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent
SRC_DIR = PKG / "csrc" / "host"
BUILD_DIR = PKG.parent / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_vp, _i32, _i64, _f64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double
# entry point -> (library, argtypes); every pointer is a numpy buffer's address
_ENTRIES = {
    "bbduk_entropy": ("bbduk", [_vp, _vp, _i64, _i32, _i32, _i32, _vp]),
    "bbduk_qtrim": ("bbduk", [_vp, _vp, _vp, _i64, _i32, _vp, _f64, _f64, _vp, _vp]),
    "spike_moments": ("spike", [_vp, _vp, _vp, _i64, _vp, _vp, _vp]),
}


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host C++ libraries cannot be built")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str, force: bool = False) -> Path:
    """Compile ``csrc/host/<name>.cpp`` into ``lib_path(name)`` if it is
    missing, stale or ``force`` is set. Raises RuntimeError when g++ is
    missing or fails."""
    src, out = SRC_DIR / f"{name}.cpp", lib_path(name)
    if not force and out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    gxx = _gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so that a process that loads
    # the library (another test worker) never sees a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The host library ``name`` ("bbduk" or "spike"), built first if
    needed, with its entry points' argument and result types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (owner, argtypes) in _ENTRIES.items():
                if owner == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = None
            _libs[name] = lib
        return lib
