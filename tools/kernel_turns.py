#!/usr/bin/env python3
"""Time two builds of the port's kernel library in turns on one CUDA card.

    python3 tools/kernel_turns.py --old build/old [--large] [--probe]

``--old`` names a directory that holds another version's ``dp_full.cu``
and ``mmp_seed.cu`` (for example a parent commit's, written there with
``git show <commit>:megapath_tpu_torch/csrc/dp_full.cu``); ``locate.cu``
comes from the checkout when the directory has none. They are compiled
with the library's own nvcc flags into ``<old>/libold_kernels.so`` and
loaded beside the checkout's library (each with its own ctypes handle, so
the two sets of symbols never meet). Every case runs old, new, new, old,
each a median of 10 CUDA-event timed launches through the port's
wrappers (``chip_smoke._median_ms``: the card spins ahead of each one, so
the events time the kernel and not the wrapper's host work), and both builds' outputs must equal the plain version's first.
The cases are the main path's DP shapes, the walk on the toy workload's
8,192 walkers (default and exact dials), the exact rescue's 1,024 walkers
and, with ``--large``, the 512 Mbp shard's 40,960 walkers and its rescue
shape. A walk's time is also given per iteration of its longest walker.
``--probe`` measures the card's dependent-load latency (one thread
chasing pointers through an 8 MB and a 4 GB random cycle): one walk
iteration can take no less than one such round trip. Lines go to stdout and to
``chiprun_out/kernel_turns.txt``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from megapath_tpu_torch.align import seeding_dev  # noqa: E402
from megapath_tpu_torch.align.params import AlignParams  # noqa: E402
from megapath_tpu_torch.ops import _build, dp_cuda, seed_cuda  # noqa: E402
from megapath_tpu_torch.ops.dp import DPParams, sw_align, sw_align_full  # noqa: E402

OUT = ROOT / "chiprun_out" / "kernel_turns.txt"
_lines = []

# one thread follows next[] for `hops` hops; the caller times the launch
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void chase(const uint32_t* __restrict__ next, long long hops,
                      uint32_t* out) {
  uint32_t i = 0;
  for (long long h = 0; h < hops; ++h) i = next[i];
  *out = i;
}
extern "C" int mp_chase(const void* next, long long hops, void* out,
                        void* stream) {
  chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(next), hops, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
"""


def say(line: str) -> None:
    print(line, flush=True)
    _lines.append(line)


def nvcc_library(sources, out: Path, extra=()) -> ctypes.CDLL:
    """Compile ``sources`` (with the library's flags) into ``out``."""
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = []
        for src in sources:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS.get(Path(src).name, ()),
                   *extra, "-c", "-o", str(obj), str(src)]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            objs.append(str(obj))
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(out), *objs],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


class Turns:
    """Runs a case with either library behind the port's wrappers."""

    def __init__(self, old: ctypes.CDLL, new: ctypes.CDLL):
        self.libs = {"old": old, "new": new}

    def use(self, which: str) -> None:
        _build._lib = self.libs[which]

    def check(self, tag, fn, want, fields) -> None:
        for which in ("old", "new"):
            self.use(which)
            cs._hold(f"{tag} ({which})", fn(), want, fields)

    def time(self, tag: str, fn, smi: str, per=None, bound_ms=None) -> dict:
        got = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            self.use(which)
            got[which].append(cs._median_ms(fn))
        self.use("new")
        old, new = statistics.mean(got["old"]), statistics.mean(got["new"])
        line = (f"[turns] {tag}: old {got['old'][0]:.4f} / {got['old'][1]:.4f} ms, "
                f"new {got['new'][0]:.4f} / {got['new'][1]:.4f} ms; "
                f"old / new = {old / new:.2f}x")
        if per:
            line += f"; {1e3 * old / per:.3f} -> {1e3 * new / per:.3f} us an iteration ({per})"
        if bound_ms:
            line += (f"; bound {bound_ms:.4f} ms: {100 * bound_ms / old:.1f}% -> "
                     f"{100 * bound_ms / new:.1f}%")
        say(line + f" [{smi}]")
        return {"old": old, "new": new}


def dp_cases(turns: Turns, dev, smi: str) -> None:
    rng = np.random.default_rng(4)
    params = DPParams()
    shapes = [(4096, 100, 192), (20480, 100, 192), (1024, 100, 1024),
              (1024, 250, 1152), (256, 1023, 1920)]
    for C, R, W in shapes:
        batch = cs.planted_batch(rng, C, R, W)
        t = [torch.from_numpy(a).to(dev) for a in batch]
        want = sw_align_full(*t, params)
        turns.check(f"dp_full {C},{R},{W}", lambda: dp_cuda.sw_align_full_cuda(*t, params),
                    want, cs.FIELDS)
        cells, nbytes = cs.dp_work(batch[2], batch[3], R, W, want._replace(
            **{f: getattr(want, f).cpu() for f in cs.FIELDS}))
        turns.time(f"dp_full ({C},{R},{W}) {cells} cells",
                   lambda: dp_cuda.sw_align_full_cuda(*t, params), smi,
                   bound_ms=cs.bound(cells, nbytes)[0])
        if (C, R, W) in ((4096, 100, 192), (1024, 100, 1024)):
            want = sw_align(*t, params)
            turns.check(f"dp_fwd {C},{R},{W}", lambda: dp_cuda.sw_align_cuda(*t, params),
                        want, cs.FWD_FIELDS)
            cells, nbytes = cs.dp_work(batch[2], batch[3], R, W)
            turns.time(f"dp_fwd ({C},{R},{W}) {cells} cells",
                       lambda: dp_cuda.sw_align_cuda(*t, params), smi,
                       bound_ms=cs.bound(cells, nbytes)[0])
    (ref, reads, lens, starts), W = cs.graft_inputs(dev)
    from megapath_tpu_torch.align import device as tdev

    t = (reads, tdev.gather_windows(ref, starts, W), lens, torch.full_like(lens, W))
    turns.check("dp_fwd graft", lambda: dp_cuda.sw_align_cuda(*t, params),
                sw_align(*t, params), cs.FWD_FIELDS)
    turns.time("dp_fwd graft (256,128,256)", lambda: dp_cuda.sw_align_cuda(*t, params), smi)


def walk_cases(turns: Turns, dev, smi: str, fm, read_ends, tag: str) -> None:
    reads, lens = read_ends
    dfm = seeding_dev.DeviceFM.from_host(fm, dev)
    n = len(lens)
    walkers, wlens = seeding_dev.build_walkers(
        torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev))
    base = AlignParams().mmp
    exact = dataclasses.replace(base, kill_ratio=0.0, sibling_kill_steps=0)
    rw = torch.cat([walkers[:512], walkers[n : n + 512]])
    rl = torch.cat([wlens[:512], wlens[n : n + 512]])
    L = reads.shape[1]
    max_seeds, chg = int(min(16, max(4, L // 16 + 2))), 3 * L + 64
    for name, wk, wl, mmp in (("default dials", walkers, wlens, base),
                              ("exact dials", walkers, wlens, exact),
                              ("rescue exact dials", rw, rl, exact)):
        args = (dfm, wk, wl, mmp, max_seeds, chg, chg)
        stats = {}
        want = seeding_dev.mmp_seed_device_plain(*args, stats=stats)
        turns.check(f"mmp_seed {tag} {name}", lambda: seed_cuda.mmp_seed_cuda(*args),
                    want, cs.SEED_FIELDS)
        nbytes = cs.walk_bytes(wk.shape[0], L, max_seeds, stats)
        turns.time(f"mmp_seed {tag} {name}, {wk.shape[0]} walkers",
                   lambda: seed_cuda.mmp_seed_cuda(*args), smi, per=stats["iterations"],
                   bound_ms=cs.bound(0, nbytes)[0])


def probe(dev, smi: str) -> None:
    """ns a dependent load, one thread, through an 8 MB (L2) and a 4 GB
    (device memory) random cycle of 64-byte-apart entries. The 4 GB chase
    visits 2,000,000 entries (128 MB of lines) a launch, more than the L2
    holds, so the timed launches do not find the warm-up's lines."""
    d = ROOT / "build" / "probe"
    d.mkdir(parents=True, exist_ok=True)
    src = d / "chase.cu"
    src.write_text(PROBE_SRC)
    lib = nvcc_library([src], d / "libchase.so")
    lib.mp_chase.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.mp_chase.restype = ctypes.c_int
    stride = 16  # uint32 entries: 64 bytes apart
    for name, nbytes, hops in (("8 MB (L2)", 8 << 20, 200_000), ("4 GB (HBM)", 4 << 30, 2_000_000)):
        n = nbytes // 64
        g = torch.Generator(device=dev).manual_seed(7)
        perm = torch.randperm(n, device=dev, generator=g)
        nxt = torch.zeros(n * stride, dtype=torch.int64, device=dev)
        nxt[perm * stride] = torch.roll(perm, -1) * stride  # one cycle over all entries
        nxt = nxt.to(torch.int32)
        out = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run():
            if lib.mp_chase(nxt.data_ptr(), hops, out.data_ptr(), stream):
                raise RuntimeError("mp_chase launch failed")

        ms = cs._median_ms(run, reps=3)
        say(f"[probe] dependent load, {name}: {1e6 * ms / hops:.1f} ns a hop "
            f"({hops} hops, median of 3) [{smi}]")
        del nxt, perm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of the other version's sources")
    ap.add_argument("--large", action="store_true", help="also the 512 Mbp shard's walk")
    ap.add_argument("--probe", action="store_true", help="measure dependent-load latency")
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    old_dir = Path(args.old).resolve()
    srcs = [old_dir / "dp_full.cu", old_dir / "mmp_seed.cu"]
    srcs.append(old_dir / "locate.cu" if (old_dir / "locate.cu").exists()
                else _build.CSRC / "locate.cu")
    old = _build.bind(nvcc_library(srcs, old_dir / "libold_kernels.so"))
    new = _build.load()
    say(f"[turns] old: {', '.join(str(s.relative_to(ROOT)) for s in srcs)}; "
        f"new: {_build.LIB_PATH.relative_to(ROOT)}")
    turns = Turns(old, new)
    if args.probe:
        probe(dev, smi)
    dp_cases(turns, dev, smi)
    ref, fm, reads1, lens1, reads2, lens2 = cs.toy_workload(dev)
    ends = (np.concatenate([reads1[:2048], reads2[:2048]]),
            np.concatenate([lens1[:2048], lens2[:2048]]))
    walk_cases(turns, dev, smi, fm, ends, "toy")
    if args.large:
        del fm
        ref, fm, reads1, lens1, reads2, lens2 = cs.large_workload(dev)
        ends = (np.concatenate([reads1[:10240], reads2[:10240]]),
                np.concatenate([lens1[:10240], lens2[:10240]]))
        walk_cases(turns, dev, smi, fm, ends, "512 Mbp")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
