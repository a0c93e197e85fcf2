#!/usr/bin/env python3
"""Time two builds of the port's kernel library in turns on one CUDA card.

    python3 tools/kernel_turns.py --old build/old [--large] [--probe]
                                  [--locate-scan] [--step-split]

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
tables (the checkout's layout); the protein DP at phase 3's main shape,
at a batch padded to a 29.6 kbp contig's frame with its 64 long
candidates first and, the same batch, last (the adverse order for blocks
taken in index order), at long frames in 1,537-row and 4,097-row windows
(tiles carried through scratch), then the checkout's build alone under
each rule of which candidates are long (``--subst-scan``). A build of
the one-warp ``sw_subst.cu`` of commit 9a55593, whose C entry takes no
schedule, runs through a copy of that commit's wrapper call
(``unscheduled_sw_subst``). With ``--large`` also the 512 Mbp shard's
40,960 walkers, its rescue shape and the locate on their rows. A walk's
time is also given per iteration of its longest walker, a locate's beside
its bytes bound and, with ``--probe``, its chain floor. ``--probe``
measures the card's dependent-load latency (``chip_smoke.load_latency``:
one thread chasing pointers through an 8 MB and a 4 GB random cycle).
``--step-split`` times a step of the protein DP's wavefront cut into
parts (``tools/sw_step_probe.cu``: one warp alone, the shuffles, the code
load and its table row, each lane's rows).
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
from megapath_tpu_torch.ops.dp import DPParams, DPResult, sw_align, sw_align_full  # noqa: E402

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
        self.which = "new"

    def use(self, which) -> None:
        self.which = which
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


# the C entry of commit 9a55593's mp_sw_subst: no order, no schedule, one
# block of 4 warps for each 4 candidates in index order
UNSCHEDULED_SW_SUBST = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                        ctypes.c_int)


def unscheduled_sw_subst(lib, reads, refs, read_lens, ref_lens, subst, params) -> DPResult:
    """The wrapper call of ``ops/protein_cuda.py`` at commit 9a55593 on a
    library built from that commit's ``sw_subst.cu``."""
    B, R = reads.shape
    W = refs.shape[1]
    dev = reads.device
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    carry = torch.empty((B, 2, R, 2), dtype=torch.int32, device=dev) if W > 512 else None
    err = lib.mp_sw_subst(
        reads.data_ptr(), refs.data_ptr(), read_lens.data_ptr(), ref_lens.data_ptr(),
        subst.data_ptr(), *(out[k].data_ptr() for k in range(3)),
        None if carry is None else carry.data_ptr(), B, R, W, subst.shape[0],
        params.gap_open, params.gap_extend, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mp_sw_subst (unscheduled) launch failed: CUDA error {err}")
    return DPResult(*out)


def subst_call(turns: Turns, t, subst, params, long_factor=protein_cuda.LONG_FACTOR):
    """The protein DP through whichever build ``turns`` uses: one whose C
    entry takes no schedule by its own call, a later one through the
    port's wrapper."""
    def fn():
        lib = turns.libs[turns.which]
        if not hasattr(lib, "mp_sw_subst_occupancy"):
            return unscheduled_sw_subst(lib, *t, subst, params)
        return protein_cuda.sw_align_substmat_cuda(*t, subst, params, long_factor)
    return fn


# (tag, B, R, W, where the long candidates stand): the main shape, a
# blastx batch padded to a 29.6 kbp contig's 9,873-aa frame (64 long
# frames, the other candidates' queries cut to 50 aa), long first and
# last, and long frames in windows of 1,537 rows (a warp's tiles) and
# 4,097 rows (a block's tiles)
SUBST_CASES = (
    ("main", 3072, 3334, 320, None),
    ("padded, long first", 4096, 9873, 297, "first"),
    ("padded, long last", 4096, 9873, 297, "last"),
    ("1,537-row windows", 4096, 9873, 1537, "first"),
    ("4,097-row windows", 256, 9873, 4097, "first"),
)
# the long rules the scan times the checkout's build under
LONG_FACTORS = (None, 1, 2, 4)


def subst_batches(rng):
    """SUBST_CASES' batches; the main and the padded one are drawn as
    commit 9a55593's turns drew its two cases."""
    padded = None  # the first batch with its long candidates first
    for tag, C, R, W, long in SUBST_CASES:
        if long is None:
            batch = cs.protein_batch(rng, C, R, W)
        elif long == "last":
            batch = cs.move_long(padded, "last")
        else:
            batch = cs.long_batch(rng, C, R, W)
            padded = batch if padded is None else padded
        yield tag, batch


def subst_cases(turns: Turns, dev, smi: str, scan: bool) -> None:
    """The protein DP on SUBST_CASES, both builds equal to the plain
    version first; with ``scan`` the checkout's build under each of
    LONG_FACTORS on the first three."""
    rng = np.random.default_rng(5)
    subst = torch.from_numpy(cs.BLOSUM62).to(dev)
    params = cs.PROTEIN_PARAMS
    for which, lib in turns.libs.items():
        if hasattr(lib, "mp_sw_subst_occupancy"):
            turns.use(which)
            occ = protein_cuda.occupancy(dev)
            say(f"[turns] sw_subst {which}: {occ['registers']} registers, {occ['local_bytes']} "
                f"bytes local, {occ['shared_bytes']} bytes shared, {occ['blocks_per_sm']} blocks "
                f"an SM [{smi}]")
    turns.use("new")
    for k, (tag, batch) in enumerate(subst_batches(rng)):
        C, R = batch[0].shape
        W = batch[1].shape[1]
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in batch]
        fn = subst_call(turns, t, subst, params)
        want = cs.sw_align_substmat(*t, subst, params)
        turns.check(f"sw_subst {tag} {C},{R},{W}", fn, want, cs.FWD_FIELDS)
        cells, nbytes = cs.subst_work(batch[2], batch[3], R, W, subst.shape[0])
        bound_ms = cs.bound(cells, nbytes, cs.SUBST_CELLS_PER_S)[0]
        turns.time(f"sw_subst {tag} ({C},{R},{W}) {cells} cells", fn, smi, bound_ms=bound_ms)
        if not scan or k > 2:
            continue
        turns.use("new")
        parts = []
        occ = protein_cuda.occupancy(dev)
        for factor in LONG_FACTORS:
            fn = subst_call(turns, t, subst, params, factor)
            cs._hold(f"sw_subst {tag} long factor {factor}", fn(), want, cs.FWD_FIELDS)
            _, sched = protein_cuda.schedule(t[2], t[3], R, W, occ["blocks_per_sm"]
                                             * occ["sms"] * occ["warps"], factor)
            parts.append(f"{factor}: {int(sched[1])} long, {cs._median_ms(fn):.4f} ms")
        say(f"[scan] sw_subst {tag}, new build by long factor: " + "; ".join(parts)
            + f" [{smi}]")


# the step probe's (part, rows a lane) cases: the shuffles alone, then PR
# 10's step (code loaded by every lane) and the code carried by shuffle,
# each with no rows and with 1-16 rows a lane, and the code-load step with
# its rows' loop leaving at a row count known at run time
STEP_PARTS = ((0, 0),) + tuple((part, rows) for part in (1, 2)
                               for rows in (0, 1, 2, 3, 4, 8, 10, 16)) + tuple(
    (3, rows) for rows in (1, 2, 3, 4, 8, 10, 16))
STEP_PART_NAMES = {0: "shuffles", 1: "code load", 2: "code by shuffle",
                   3: "code load, run-time rows"}


def step_split(dev, smi: str) -> None:
    """Clocks a step of the wavefront takes, one warp alone on the card
    over a 9,873-column frame (``tools/sw_step_probe.cu``), and the split
    of the one-warp step into its shuffles, its code load with the table
    row it selects, and its rows."""
    probe_dir = ROOT / "build" / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    lib = nvcc_library([ROOT / "tools" / "sw_step_probe.cu"], probe_dir / "libstep_probe.so")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mp_step_probe.argtypes = [ci, ci, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.mp_step_probe.restype = ci
    rng = np.random.default_rng(6)
    n_cols = 9873
    rd = torch.from_numpy(rng.integers(0, 24, n_cols).astype(np.uint8)).to(dev)
    rf = torch.from_numpy(rng.integers(0, 24, 32 * 16).astype(np.uint8)).to(dev)
    subst = torch.from_numpy(cs.BLOSUM62).to(dev)
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(32, dtype=torch.int32, device=dev)
    go, ge = cs.PROTEIN_PARAMS.gap_open, cs.PROTEIN_PARAMS.gap_extend
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_step = {}
    for part, rows in STEP_PARTS:
        def fn(part=part, rows=rows):
            err = lib.mp_step_probe(part, rows, rd.data_ptr(), rf.data_ptr(), subst.data_ptr(),
                                    subst.shape[0], n_cols, go, ge, clocks.data_ptr(),
                                    sink.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"mp_step_probe failed: CUDA error {err}")
        ms = cs._median_ms(fn, reps=5)
        per_step[part, rows] = int(clocks) / (n_cols + 31)
        say(f"[split] {STEP_PART_NAMES[part]}, {rows} rows a lane: "
            f"{per_step[part, rows]:.1f} clocks a step, {1e6 * ms / (n_cols + 31):.1f} ns a "
            f"step ({ms:.4f} ms for {n_cols + 31} steps) [{smi}]")
    for part in (1, 2, 3):
        rows = [r for p, r in STEP_PARTS if p == part and r > 0]
        slope = np.polyfit(rows, [per_step[part, r] for r in rows], 1)[0]
        line = f"[split] {STEP_PART_NAMES[part]}: shuffles {per_step[0, 0]:.1f} clocks"
        if (part, 0) in per_step:
            line += f", the code and its table row {per_step[part, 0] - per_step[0, 0]:.1f}"
        say(line + f", a row {slope:.1f} (slope over 1-16 rows a lane) [{smi}]")


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
    "sw_subst.cu": ("mp_sw_subst_tile_rows",),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of the other version's sources")
    ap.add_argument("--large", action="store_true", help="also the 512 Mbp shard's cases")
    ap.add_argument("--probe", action="store_true", help="measure dependent-load latency")
    ap.add_argument("--locate-scan", action="store_true",
                    help="split a locate launch's time (empty launch, chase, row subsets)")
    ap.add_argument("--subst-scan", action="store_true",
                    help="time the protein DP under each rule of which candidates are long")
    ap.add_argument("--step-split", action="store_true",
                    help="split a protein DP step's clocks (tools/sw_step_probe.cu)")
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    old_dir = Path(args.old).resolve()
    srcs = [old_dir / name for name in ENTRY_POINTS if (old_dir / name).exists()]
    if not srcs:
        raise SystemExit(f"{old_dir} holds none of {', '.join(ENTRY_POINTS)}")
    old = _build.bind(nvcc_library(srcs, old_dir / "libold_kernels.so"),
                      [e for src in srcs for e in ENTRY_POINTS[src.name]])
    if hasattr(old, "mp_sw_subst_occupancy"):
        _build.bind(old, ["mp_sw_subst", "mp_sw_subst_occupancy"])
    elif hasattr(old, "mp_sw_subst"):
        old.mp_sw_subst.argtypes, old.mp_sw_subst.restype = UNSCHEDULED_SW_SUBST
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
    if args.step_split:
        step_split(dev, smi)
    if "sw_subst.cu" in have:
        subst_cases(turns, dev, smi, args.subst_scan)
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
