#!/usr/bin/env python3
"""Time two builds of the port's kernel library in turns on one CUDA card.

    python3 tools/kernel_turns.py --old build/old [--large] [--probe]
                                  [--locate-scan]

``--old`` names a directory that holds another version of any of
``dp_full.cu``, ``mmp_seed.cu``, ``locate.cu`` and ``sw_subst.cu`` (for
example a parent commit's, written there with ``git show
<commit>:megapath_tpu_torch/csrc/locate.cu``). They are compiled with the
library's own nvcc flags into ``<old>/libold_kernels.so`` and loaded
beside the checkout's library (each with its own ctypes handle, so the
two sets of symbols never meet); only the kernels the directory holds are
compared. Every case runs old, new, new, old, each a median of 10
CUDA-event timed launches through the port's wrappers
(``chip_smoke._median_ms``: the card spins ahead of each one, so the
events time the kernel and not the wrapper's host work), and both builds'
outputs must equal the plain version's first. The cases are the main
path's DP shapes; the walk on the toy workload's 8,192 walkers (default
and exact dials) and the exact rescue's 1,024 walkers; the locate on the
SA rows of the toy's 4,096 read ends' seeds, both builds on the same
tables (the checkout's layout); the protein DP at phase 3's main shape
and at a batch padded to a 29.6 kbp contig's frame. With ``--large``
also the 512 Mbp shard's
40,960 walkers, its rescue shape and the locate on their rows. A walk's
time is also given per iteration of its longest walker, a locate's beside
its bytes bound and, with ``--probe``, its chain floor. ``--probe``
measures the card's dependent-load latency (``chip_smoke.load_latency``:
one thread chasing pointers through an 8 MB and a 4 GB random cycle).
``--locate-scan`` splits a locate launch's time (``locate_scan``). Lines
go to stdout and to ``chiprun_out/kernel_turns.txt``.
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
from megapath_tpu_torch.ops import _build, dp_cuda, protein_cuda, seed_cuda  # noqa: E402
from megapath_tpu_torch.ops.dp import DPParams, sw_align, sw_align_full  # noqa: E402

OUT = ROOT / "chiprun_out" / "kernel_turns.txt"
_lines = []

def say(line: str) -> None:
    print(line, flush=True)
    _lines.append(line)


def nvcc_library(sources, out: Path) -> ctypes.CDLL:
    """Compile ``sources`` (with the library's flags) into ``out``."""
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = []
        for src in sources:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS.get(Path(src).name, ()),
                   "-c", "-o", str(obj), str(src)]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            objs.append(str(obj))
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(out), *objs],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


class Turns:
    """Runs a case with any of its libraries (named, "old" and "new" for
    the turns) behind the port's wrappers."""

    def __init__(self, libs: dict):
        self.libs = libs

    def use(self, which) -> None:
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


def subst_cases(turns: Turns, dev, smi: str) -> None:
    """The protein DP at phase 3's main shape (a 10 kbp contig's 48 frames
    x 64 candidates) and at a blastx batch padded to a 29.6 kbp contig's
    frame (most candidates far shorter than R)."""
    rng = np.random.default_rng(5)
    subst = torch.from_numpy(cs.BLOSUM62).to(dev)
    params = cs.PROTEIN_PARAMS
    for C, R, W in ((3072, 3334, 320), (4096, 9873, 297)):
        batch = cs.protein_batch(rng, C, R, W)
        if R > 5000:  # a few long frames among many read-length ones
            batch[2][64:] = np.minimum(batch[2][64:], 50)
        t = [torch.from_numpy(a).to(dev) for a in batch]
        turns.check(f"sw_subst {C},{R},{W}",
                    lambda: protein_cuda.sw_align_substmat_cuda(*t, subst, params),
                    cs.sw_align_substmat(*t, subst, params), cs.FWD_FIELDS)
        cells, nbytes = cs.subst_work(batch[2], batch[3], R, W, subst.shape[0])
        turns.time(f"sw_subst ({C},{R},{W}) {cells} cells",
                   lambda: protein_cuda.sw_align_substmat_cuda(*t, subst, params), smi,
                   bound_ms=cs.bound(cells, nbytes, cs.SUBST_CELLS_PER_S)[0])


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


def locate_cases(turns: Turns, smi: str, dfm, rows, tag: str, lat: dict, level: str) -> None:
    """The locate on ``rows``, old against new on the same tables."""
    stats = {}
    want = seeding_dev.locate_device_plain(dfm, rows, stats=stats)
    fn = lambda: seed_cuda.locate_cuda(dfm, rows)  # noqa: E731
    turns.check(f"locate {tag}", fn, want, None)
    line = f"locate {tag}, {len(rows)} rows, {stats['lf_steps']} LF steps"
    if level in lat:
        loads, floor_ms = cs.chain_floor(stats, lat[level])
        line += f", chain floor {floor_ms:.4f} ms ({loads} loads x {lat[level]:.1f} ns)"
    turns.time(line, fn, smi, bound_ms=cs.bound(0, cs.locate_bytes(len(rows), stats))[0])


def locate_scan(turns: Turns, smi: str, dfm, rows, tag: str, lat: dict, level: str) -> None:
    """What a locate launch's time is made of: an empty launch timed the
    same way (the probe kernel with no hops), the chase of as many
    dependent loads as the longest row's chain, and each build's locate
    on the row with the longest chain, the 32 and the 1,024 longest, all
    rows longest first (warps of equal chains) and all rows as the walk
    gives them."""
    dev = rows.device
    pos = seeding_dev.locate_device_plain(dfm, rows)
    steps = (pos.long() % dfm.sa_interval).cpu()  # LF steps to the mark
    order = torch.argsort(steps, descending=True, stable=True).to(dev)
    loads = int(steps.max()) + cs.CHAIN_EXTRA_LOADS
    # a cycle over 8 MB (L2) or 4 GB (HBM) lines, as load_latency chases
    nxt = cs.chase_table(dev, 8 << 20 if level == "L2" else 4 << 30)
    say(f"[scan] locate {tag}: empty launch {cs.chase_ms(dev, nxt, 0):.4f} ms, chase of the "
        f"longest chain's {loads} loads ({level} {lat.get(level, float('nan')):.1f} ns) "
        f"{cs.chase_ms(dev, nxt, loads):.4f} ms [{smi}]")
    del nxt
    subsets = [(f"{m} longest", order[:m]) for m in (1, 32, 1024)]
    subsets += [("all, longest first", order), ("all, as given", None)]
    for which in ("old", "new", "new", "old"):
        turns.use(which)
        parts = []
        for name, idx in subsets:
            sub = rows if idx is None else rows[idx].contiguous()
            fn = lambda: seed_cuda.locate_cuda(dfm, sub)  # noqa: E731
            cs._hold(f"locate {tag} ({which}) on {name}", fn(),
                     pos if idx is None else pos[idx], None)
            parts.append(f"{name} {cs._median_ms(fn):.4f}")
        say(f"[scan] locate {tag} {which}, ms on rows: " + ", ".join(parts) + f" [{smi}]")
    turns.use("new")


# the entry points each kernel source holds
ENTRY_POINTS = {
    "dp_full.cu": ("mp_dp_full", "mp_dp_fwd", "mp_dp_full_max_width"),
    "mmp_seed.cu": ("mp_mmp_seed",),
    "locate.cu": ("mp_locate",),
    "sw_subst.cu": ("mp_sw_subst", "mp_sw_subst_tile_rows"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of the other version's sources")
    ap.add_argument("--large", action="store_true", help="also the 512 Mbp shard's cases")
    ap.add_argument("--probe", action="store_true", help="measure dependent-load latency")
    ap.add_argument("--locate-scan", action="store_true",
                    help="split a locate launch's time (empty launch, chase, row subsets)")
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    old_dir = Path(args.old).resolve()
    srcs = [old_dir / name for name in ENTRY_POINTS if (old_dir / name).exists()]
    if not srcs:
        raise SystemExit(f"{old_dir} holds none of {', '.join(ENTRY_POINTS)}")
    old = _build.bind(nvcc_library(srcs, old_dir / "libold_kernels.so"),
                      [e for src in srcs for e in ENTRY_POINTS[src.name]])
    new = _build.load()
    have = {src.name for src in srcs}
    say(f"[turns] old: {', '.join(str(s.relative_to(ROOT)) for s in srcs)}; "
        f"new: {_build.LIB_PATH.relative_to(ROOT)}")
    turns = Turns({"old": old, "new": new})
    lat = cs.load_latency(dev, smi) if args.probe else {}
    for level, ns in lat.items():
        say(f"[probe] dependent load, {level}: {ns:.1f} ns a hop [{smi}]")
    if "dp_full.cu" in have:
        dp_cases(turns, dev, smi)
    if "sw_subst.cu" in have:
        subst_cases(turns, dev, smi)
    workloads = [("toy", cs.toy_workload, 2048, "L2")] if have & {"mmp_seed.cu",
                                                                   "locate.cu"} else []
    if args.large:
        workloads.append(("512 Mbp", cs.large_workload, 10240, "HBM"))
    for tag, make, n, level in workloads:
        ref, fm, *batch = make(dev)
        ends = (np.concatenate([batch[0][:n], batch[2][:n]]),
                np.concatenate([batch[1][:n], batch[3][:n]]))
        if "mmp_seed.cu" in have:
            walk_cases(turns, dev, smi, fm, ends, tag)
        if "locate.cu" in have:
            dfm = seeding_dev.DeviceFM.from_host(fm, dev)
            rows = cs.seed_rows(dfm, batch, n)
            locate_cases(turns, smi, dfm, rows, tag, lat, level)
            if args.locate_scan:
                locate_scan(turns, smi, dfm, rows, tag, lat, level)
            del dfm, rows
        del ref, fm, batch
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
