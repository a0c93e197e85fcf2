#!/usr/bin/env python3
"""Drive the PyTorch port's alignment path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the script
exits non-zero and prints no result line):

1. device   -- CUDA must be present; prints torch/CUDA versions and the
               card's name and power limit as nvidia-smi gives them.
2. build    -- compiles ``megapath_tpu_torch/csrc/*.cu`` with nvcc into
               ``build/kernels/`` and prints the seconds it took.
3. kernels  -- the CUDA DP kernel against the plain PyTorch version on
               the card, at the main path's shapes and on an edge batch;
               all five integer outputs must be equal (tolerance 0).
               Median times over CUDA events, both sides.
4. golden   -- the port engine on ``cuda`` over the soap4 fixture must
               give 0/200 read-end mismatches against the soap4 golden.
5. slice    -- ``align_pairs`` on the bench's toy workload (4 x 2 Mbp,
               20,000 pairs x 100 bp, made here as ``bench.py`` makes
               it): 1 warm-up and 3 timed passes, the kernel's launch
               count over them, and the hits' digest against the JAX
               engine's (``tests/fixtures/torch_toy_hits.json``).

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports torch, numpy and
``megapath_tpu_torch``, and nothing of jax or ``megapath_tpu``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FIX = HERE / "tests" / "fixtures"

from megapath_tpu_torch.align.engine import AlignEngine  # noqa: E402
from megapath_tpu_torch.align.output import best_per_seq, format_comment  # noqa: E402
from megapath_tpu_torch.align.params import AlignParams  # noqa: E402
from megapath_tpu_torch.index.fm import build_fm_index  # noqa: E402
from megapath_tpu_torch.index.pack import pack_fasta, pack_fasta_file, pack_reads  # noqa: E402
from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx, trim_readno  # noqa: E402
from megapath_tpu_torch.ops import _build, dp_cuda  # noqa: E402
from megapath_tpu_torch.ops.dp import (  # noqa: E402
    OFF_TEXT_CODE,
    DPParams,
    sw_align_full,
)

KERNEL_SOURCE = "megapath_tpu_torch/csrc/dp_full.cu"
KERNEL_REPLACES = "megapath_tpu/ops/dp_pallas.py:248"
FIELDS = ("score", "end_ref", "end_read", "start_ref", "start_read")


# ----------------------------------------------------------------------
# inputs and digests (the CPU tests import these too)
# ----------------------------------------------------------------------
def planted_batch(rng: np.random.Generator, C: int, R: int, W: int):
    """C candidates: a random window with a read planted in it, with up
    to 4 substitutions and at most one short indel; random read and
    window lengths. Returns numpy (reads u8 [C,R], refs u8 [C,W],
    read_lens i32 [C], ref_lens i32 [C])."""
    reads = np.zeros((C, R), np.uint8)
    refs = rng.integers(0, 4, (C, W)).astype(np.uint8)
    rl = rng.integers(max(1, R // 2), R + 1, C).astype(np.int32)
    wl = rng.integers(max(1, W // 2), W + 1, C).astype(np.int32)
    for b in range(C):
        r = int(min(rl[b], wl[b]))
        p = int(rng.integers(0, wl[b] - r + 1))
        read = refs[b, p : p + r].copy()
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, r))
            read[q] = (read[q] + 1 + rng.integers(0, 3)) % 4
        indel = int(rng.integers(0, 3))
        if indel and r > 8:
            q = int(rng.integers(2, r - 4))
            k = int(rng.integers(1, 4))
            if indel == 1:  # deletion from the read
                read = np.concatenate([read[:q], read[q + k :]])
            else:  # insertion into the read
                read = np.concatenate(
                    [read[:q], rng.integers(0, 4, k).astype(np.uint8), read[q:]]
                )[:R]
        reads[b, : len(read)] = read
        rl[b] = len(read)
    return reads, refs, rl, wl


def edge_batch(rng: np.random.Generator, R: int, W: int, C: int = 32):
    """Rows that decide the contract's corners: zero-length reads,
    win_len < W and win_len = 0, off-text cells, reads planted twice
    in one window and repeats (ties decide end and start), all
    mismatches (score 0), read_len = R; the rest planted at random."""
    reads, refs, rl, wl = planted_batch(rng, C, R, W)
    half = min(R, W // 2)

    def plant(b, read, window, n_read, n_win):
        reads[b] = 0
        refs[b] = window
        reads[b, :n_read] = read[:n_read]
        rl[b], wl[b] = n_read, n_win

    rnd = lambda n: rng.integers(0, 4, n).astype(np.uint8)  # noqa: E731
    win = rnd(W)
    plant(0, win[5:], win, 0, W)  # zero-length read
    win = rnd(W)  # match straddles win_len: its tail must not count
    plant(1, win[W // 2 - half // 2 :], win, half, W // 2)
    win = rnd(W)
    plant(2, win[3:], win, half, 0)  # win_len = 0
    win = rnd(W)  # the read's middle lies on off-text cells
    read = win[10 : 10 + half].copy()
    win[10 + half // 3 : 10 + 2 * half // 3] = OFF_TEXT_CODE
    plant(3, read, win, half, W)
    n = max(4, min(R, W // 3))  # the same read planted twice
    read = rnd(n)
    win = rnd(W)
    win[2 : 2 + n] = read
    win[W - n - 1 : W - 1] = read
    plant(4, read, win, n, W)
    rep = np.resize(np.array([0, 1], np.uint8), max(R, W))  # ACAC... repeat
    plant(5, rep, rep[:W].copy(), min(R, W - 6), W)
    plant(6, np.zeros(R, np.uint8), np.zeros(W, np.uint8), R, W)  # homopolymer
    plant(7, np.zeros(R, np.uint8), np.ones(W, np.uint8), R, W)  # score 0
    win = rnd(W)  # read_len = R, window full of off-text cells at both ends
    win[: W // 4] = OFF_TEXT_CODE
    win[-W // 4 :] = OFF_TEXT_CODE
    plant(8, np.resize(win[W // 4 :], R), win, R, W)
    win = rnd(W)  # a short read that matches at the last rows of the window
    plant(9, win[W - 12 :], win, 12, W)
    win = rnd(W)  # and at the first rows
    plant(10, win[:12], win, 12, W)
    return reads, refs, rl, wl


def toy_workload(
    device: torch.device,
    n_seqs: int = 4,
    seq_len: int = 2_000_000,
    n_pairs: int = 20_000,
    read_len: int = 100,
    insert: int = 350,
    seed: int = 11,
):
    """The bench's toy workload, drawn as ``bench.build_workload`` draws
    it (same generator, same order of draws): ``n_seqs`` random
    sequences, an FM index with sa_interval 8 and an 8-mer table (its
    suffix array sorted on ``device``), and ``n_pairs`` pairs at the
    insert size with Poisson(1) substitutions per read. Returns (ref, fm,
    reads1, lens1, reads2, lens2) as numpy."""
    rng = np.random.default_rng(seed)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [rng.integers(0, 4, seq_len).astype(np.uint8) for _ in range(n_seqs)]
    ref = pack_fasta(
        FastqRecord(f"seq{i}", decode[s].tobytes().decode()) for i, s in enumerate(seqs)
    )
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=device)
    comp = np.array([3, 2, 1, 0], np.uint8)
    reads1 = np.zeros((n_pairs, read_len), dtype=np.uint8)
    reads2 = np.zeros((n_pairs, read_len), dtype=np.uint8)
    for i in range(n_pairs):
        c = seqs[i % n_seqs]
        p = int(rng.integers(0, len(c) - insert))
        r1 = c[p : p + read_len].copy()
        r2 = comp[c[p + insert - read_len : p + insert][::-1]].copy()
        for arr in (r1, r2):
            for _ in range(int(rng.poisson(1.0))):
                q = int(rng.integers(0, read_len))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        reads1[i], reads2[i] = r1, r2
    lens = np.full(n_pairs, read_len, dtype=np.int32)
    return ref, fm, reads1, lens, reads2, lens.copy()


def workload_digest(ref_codes, reads1, lens1, reads2, lens2) -> str:
    """sha256 of the alignment inputs (shard text and read batches)."""
    h = hashlib.sha256()
    for a in (ref_codes, reads1, lens1, reads2, lens2):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


HIT_FIELDS = ("read", "end", "seq", "score", "raw_score", "start", "stop",
              "strand", "paired")


def canonical_hits(hits) -> np.ndarray:
    """[n, 9] int64 table of a BatchHits (either package's), rows
    sorted on every column."""
    cols = [np.asarray(getattr(hits, f)).astype(np.int64) for f in HIT_FIELDS]
    tab = np.stack(cols, axis=1) if cols[0].size else np.zeros((0, 9), np.int64)
    order = np.lexsort(tab.T[::-1])
    return tab[order]


def hits_digest(hits) -> str:
    return hashlib.sha256(canonical_hits(hits).tobytes()).hexdigest()


def parse_score_comment(comment: str):
    """SCORE comment -> (best, {name: score}), as the parity suites read it."""
    if not comment.startswith("SCORE:"):
        raise ValueError(f"not a SCORE comment: {comment!r}")
    segs = comment[6:].split(";")
    best = int(segs[0])
    hits = {}
    for seg in segs[1:]:
        if seg:
            sc, name = seg.split(",", 1)
            hits[name] = max(hits.get(name, 0), int(sc))
    return best, hits


def golden_mismatches(engine, fix_dir: Path = FIX):
    """Align the soap4 fixture pairs (reads packed at width 80) and
    compare each read end's SCORE comment with the soap4 golden.
    Returns (mismatches, n_read_ends)."""
    r1 = list(read_fastx(fix_dir / "align_r1.fq"))
    r2 = list(read_fastx(fix_dir / "align_r2.fq"))
    reads1, lens1 = pack_reads([r.seq for r in r1], 80)
    reads2, lens2 = pack_reads([r.seq for r in r2], 80)
    hits = engine.align_pairs(reads1, lens1, reads2, lens2)
    table = best_per_seq(hits, len(r1), engine.params.megapath_mode)
    golden = {}
    seen = collections.Counter()
    for rec in read_fastx(fix_dir / "align_golden.cfq"):
        name = trim_readno(rec.name)
        golden[(name, seen[name])] = rec
        seen[name] += 1
    bad = []
    for i, rec in enumerate(r1):
        name = trim_readno(rec.name)
        for end in (0, 1):
            want = parse_score_comment(golden[(name, end)].comment)
            got = parse_score_comment(
                format_comment(table[end][i], engine.ref, engine.params)
            )
            if want != got:
                bad.append((name, end, want, got))
    return bad, 2 * len(r1)


# ----------------------------------------------------------------------
# phases on the card
# ----------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script needs one NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}"
    )
    print(smi)
    return smi


def phase_build() -> None:
    secs = _build.build(force=True)
    print(f"[build] nvcc built {_build.LIB_PATH.name} in {secs:.1f} s")
    # ptxas -v: an entry function's mangled name (dp_full_kernel<CH> is
    # "dp_full_kernelILi<CH>E"), then its spill and register lines
    ch = "?"
    for ln in _build.LOG_PATH.read_text().splitlines():
        if "Compiling entry function" in ln and "dp_full_kernelILi" in ln:
            ch = ln.split("dp_full_kernelILi", 1)[1].split("E", 1)[0]
        elif "registers" in ln or "spill" in ln:
            print(f"[build] ptxas CH={ch}: {ln.split('ptxas info    :')[-1].strip()}")


def _median_ms(fn, reps: int = 10) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels(dev: torch.device, smi: str) -> dict:
    rng = np.random.default_rng(20261016)
    params = DPParams()
    # the main path's shapes: deep DP at 100 bp (W = 192, CH = 6) and
    # 150 bp (W = 256, CH = 8), mate rescue at 100 bp (W = 1024) and 80 bp
    # (W = 896: rows 896..1023 are the kernel's padding); a C that is not
    # a multiple of the block's 4 warps; the contract's corners; and one
    # batch for each other chunk size the library holds (CH = 2, 4, 12,
    # 16, 24: the deep DP of shorter and longer reads)
    cases = [
        ("deep_dp", planted_batch(rng, 4096, 100, 192)),
        ("mate_rescue", planted_batch(rng, 1024, 100, 1024)),
        ("deep_dp_150bp", planted_batch(rng, 4096, 150, 256)),
        ("mate_rescue_80bp", planted_batch(rng, 1024, 80, 896)),
        ("ragged_c", planted_batch(rng, 1001, 100, 192)),
        ("edge_w192", edge_batch(rng, 100, 192)),
        ("edge_w1024", edge_batch(rng, 100, 1024)),
    ] + [
        (f"width_w{w}", planted_batch(rng, 256, r, w))
        for r, w in ((30, 64), (60, 128), (250, 384), (400, 512), (600, 768))
    ]
    worst = 0
    timing = {}
    for tag, batch in cases:
        t = [torch.from_numpy(a).to(dev) for a in batch]
        got = dp_cuda.sw_align_full_cuda(*t, params)
        torch.cuda.synchronize()
        want = sw_align_full(*t, params)
        errs = {
            f: int((getattr(got, f).long() - getattr(want, f).long()).abs().max())
            for f in FIELDS
        }
        err = max(errs.values())
        worst = max(worst, err)
        if err != 0:
            raise AssertionError(f"[kernels] {tag}: kernel != plain, max |err| per output {errs}")
        C, R = batch[0].shape
        W = batch[1].shape[1]
        line = f"[kernels] {tag} C={C} R={R} W={W}: 5/5 outputs equal (tolerance 0)"
        if tag in ("deep_dp", "mate_rescue", "deep_dp_150bp", "mate_rescue_80bp"):
            ms = _median_ms(lambda: dp_cuda.sw_align_full_cuda(*t, params))
            plain_ms = _median_ms(lambda: sw_align_full(*t, params))
            timing[tag] = (ms, plain_ms)
            line += f"; median of 10: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{smi}]"
        print(line)
    ms, plain_ms = timing["deep_dp"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_golden(dev: torch.device) -> None:
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=dev)
    engine = AlignEngine(ref, fm, AlignParams(), device=dev)
    bad, n = golden_mismatches(engine)
    print(f"[golden] soap4 fixture on {dev}: {len(bad)}/{n} read-end mismatches")
    if bad:
        raise AssertionError(f"[golden] mismatches vs soap4: {bad[:5]}")


def phase_slice(dev: torch.device, smi: str) -> int:
    want = json.loads((FIX / "torch_toy_hits.json").read_text())
    t0 = time.perf_counter()
    ref, fm, reads1, lens1, reads2, lens2 = toy_workload(dev)
    print(f"[slice] toy workload ready in {time.perf_counter() - t0:.1f} s: "
          f"{ref.total_len} bp, {len(lens1)} pairs x {reads1.shape[1]} bp")
    got_in = workload_digest(ref.codes, reads1, lens1, reads2, lens2)
    if got_in != want["input_sha256"]:
        raise AssertionError(
            f"[slice] the workload's inputs differ from the fixture's "
            f"({got_in[:16]} vs {want['input_sha256'][:16]}): numpy's "
            f"generator drifted, this is not a port fault"
        )

    engine = AlignEngine(ref, fm, AlignParams(), device=dev)
    split = collections.defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[name] += time.perf_counter() - t
        return run

    # host seed = walk + locate + decode; device DP = upload, kernel
    # launches and the one pull of each DP call; the rest is pairing
    # and host bookkeeping
    engine.seed_positions = timed("seed", engine.seed_positions)
    engine._deep_dp_fused_call = timed("dp", engine._deep_dp_fused_call)
    engine._device_align = timed("dp", engine._device_align)

    dp_cuda.launches = 0
    engine.align_pairs(reads1, lens1, reads2, lens2)  # warm-up
    passes = []
    for _ in range(3):
        split.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits = engine.align_pairs(reads1, lens1, reads2, lens2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        passes.append((dt, dict(split)))
    launches = dp_cuda.launches

    n_reads = 2 * len(lens1)
    for dt, sp in passes:
        print(
            f"[slice] pass {dt:.3f} s = {n_reads / dt:.0f} reads/s; "
            f"host seed {sp.get('seed', 0.0):.3f} s, device DP "
            f"{sp.get('dp', 0.0):.3f} s, rest "
            f"{dt - sp.get('seed', 0.0) - sp.get('dp', 0.0):.3f} s"
        )
    med = statistics.median(dt for dt, _ in passes)
    print(f"[slice] median of 3: {n_reads / med:.0f} reads/s ({med:.3f} s/pass), "
          f"hits={len(hits)} [{smi}]")
    print(f"[slice] DP kernel launches over the 4 passes: {launches}")
    if launches <= 0:
        raise AssertionError("[slice] the main path never launched the DP kernel")
    got = hits_digest(hits)
    if len(hits) != want["n_hits"] or got != want["hits_sha256"]:
        raise AssertionError(
            f"[slice] hits differ from the JAX engine's: {len(hits)} hits, "
            f"digest {got[:16]} vs {want['n_hits']} hits, "
            f"{want['hits_sha256'][:16]}"
        )
    print(f"[slice] hits digest equals the JAX engine's ({got[:16]}, {len(hits)} hits)")
    return launches


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k = phase_kernels(dev, smi)
    phase_golden(dev)
    launches = phase_slice(dev, smi)
    print(json.dumps({"kernels": [{
        "name": "dp_full", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
