"""Build the port's host C++ libraries with g++ and load them with ctypes.

The port's counterpart of ``megapath_tpu/native/build.py`` for the three
host libraries the pipeline runs: ``csrc/host/bbduk.cpp`` (the bbduk
entropy and quality-trim scans), ``csrc/host/spike.cpp`` (the SPIKE
moments fold) and ``csrc/host/fastq.cpp`` (the gzip FASTQ reader, linked
with zlib; ``NativeFastqReader``). Each compiles at first use into
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
from typing import Dict, List, Tuple

import numpy as np

PKG = Path(__file__).resolve().parent
SRC_DIR = PKG / "csrc" / "host"
BUILD_DIR = PKG.parent / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# libraries to link after the source, by library
LINK = {"fastq": ("-lz",)}

_vp, _i32, _i64, _f64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double
# entry point -> (library, argtypes, restype); every pointer but fq_open's
# path is a numpy buffer's address or a reader handle
_ENTRIES = {
    "bbduk_entropy": ("bbduk", [_vp, _vp, _i64, _i32, _i32, _i32, _vp], None),
    "bbduk_qtrim": ("bbduk", [_vp, _vp, _vp, _i64, _i32, _vp, _f64, _f64, _vp, _vp], None),
    "spike_moments": ("spike", [_vp, _vp, _vp, _i64, _vp, _vp, _vp], None),
    "fq_open": ("fastq", [ctypes.c_char_p], _vp),
    "fq_close": ("fastq", [_vp], None),
    "fq_next_batch": ("fastq", [_vp, _i64, ctypes.c_int, _vp, _vp, _vp, _vp, _vp,
                                ctypes.c_int], _i64),
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
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp), *LINK.get(name, ())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The host library ``name`` ("bbduk", "spike" or "fastq"), built
    first if needed, with its entry points' argument and result types
    declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (owner, argtypes, restype) in _ENTRIES.items():
                if owner == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


class NativeFastqReader:
    """Streaming (gzip) FASTQ/FASTA reader that parses and packs batches in
    C++ (``csrc/host/fastq.cpp``), off the interpreter lock, so a reader
    thread overlaps parsing with the engines' work. Names are cut at the
    first space or tab, a ``/1``-style suffix is dropped, and a name keeps
    at most ``NAME_CAP - 1`` characters; reads longer than ``max_len`` are
    cut to it. Raises when the library cannot be built."""

    NAME_CAP = 96

    def __init__(self, path, max_len: int = 512):
        self._lib = load("fastq")
        self._h = self._lib.fq_open(os.fspath(path).encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.max_len = max_len

    def next_batch(self, cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
        """Up to ``cap`` records: (codes [n, max_len] u8, lens [n] i32,
        quals [n, max_len] u8 ASCII, seqs [n, max_len] u8 raw ASCII,
        names); n == 0 at the end of the file."""
        L = self.max_len
        codes = np.zeros((cap, L), dtype=np.uint8)
        lens = np.zeros(cap, dtype=np.int32)
        quals = np.zeros((cap, L), dtype=np.uint8)
        seqs = np.zeros((cap, L), dtype=np.uint8)
        names = ctypes.create_string_buffer(cap * self.NAME_CAP)
        n = self._lib.fq_next_batch(
            self._h, cap, L, codes.ctypes.data, lens.ctypes.data, quals.ctypes.data,
            seqs.ctypes.data, ctypes.addressof(names), self.NAME_CAP,
        )
        if n < 0:
            raise ValueError("malformed FASTQ stream")
        raw = names.raw
        out_names = [
            raw[i * self.NAME_CAP : (i + 1) * self.NAME_CAP].split(b"\0", 1)[0].decode()
            for i in range(n)
        ]
        return codes[:n], lens[:n], quals[:n], seqs[:n], out_names

    def close(self) -> None:
        if self._h:
            self._lib.fq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
