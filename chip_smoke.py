#!/usr/bin/env python3
"""Drive the PyTorch port's alignment paths and its MegaPath pipeline once
on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the script
exits non-zero and prints no result line):

1. device   -- CUDA must be present; prints torch/CUDA versions and the
               card's name and power limit as nvidia-smi gives them.
2. build    -- compiles ``megapath_tpu_torch/csrc/*.cu`` with nvcc into
               ``build/kernels/`` (one nvcc per source, all at once) and
               prints the seconds it took and ptxas' register and spill
               counts; compiles the host C++ (``csrc/host/*.cpp``, bbduk
               and SPIKE) with g++ into ``build/host/``.
   The toy workload (4 x 2 Mbp, 20,000 pairs x 100 bp, made here as
   ``bench.py`` makes it, its FM index built on the card) is made next;
   phases 3 and 5 use it.
3. kernels  -- each kernel against its plain PyTorch version on the card,
               every output equal (tolerance 0), median CUDA-event times
               of both beside the bound (the DP's cells at the card's
               cell rate, the walk's and the locate's bytes at its memory
               rate): ``dp_full`` at the main path's shapes, an odd C,
               pairs whose two candidates differ in read and window
               length, ties for both passes' orders, edge batches and one
               batch for every instantiation the library holds (W = 32 to
               2048, W = 1025, 1152 and 1920 among them); ``dp_fwd`` at
               the graft entry's (256, 128, 256), at (4096, 100, 192),
               (1024, 100, 1024) and on those corners;
               ``mp_dp_full_max_width()`` == ``dp_cuda.MAX_WIDTH``
               (2048), and both refuse what leaves the int16 range;
               ``mmp_seed`` on 2 x 4,096 read ends of the toy workload
               under the default and the exact dials, the exact rescue's
               1,024 walkers, an odd walker count and 250 bp and 1,023 bp
               walkers, timed also per iteration of the longest walker;
               ``locate`` on every SA row the default walk's seeds expand
               to.
4. golden   -- the port engine on ``cuda`` over the soap4 fixture, on
               host and on device seeding: 0/200 read-end mismatches
               against the soap4 golden on each.
5. step     -- ``align_step`` and ``pair_align_step`` (the single-chip
               entry, ``__graft_entry__.entry``'s inputs) on the card:
               the forward kernel's launches, outputs equal to the plain
               version's on the CPU.
6. slice    -- ``align_pairs`` on the toy workload on device seeding: 1
               warm-up and 3 timed passes split into walk / locate / DP
               / rest, each kernel's launch count over them, the hits'
               digest against the JAX device-seeding engine's
               (``tests/fixtures/torch_toy_hits_devseed.json``); then one
               pass on host seeding against the JAX host-seeding digest
               (``tests/fixtures/torch_toy_hits.json``).
7. large    -- the 512 Mbp shard of ``tools/build_bench_shard.py`` (8 x
               64 Mbp, seed 23, 20,000 pairs), drawn here, its index
               built on the card (seconds and peak card memory printed):
               1 warm-up and 3 timed device-seeding passes; the first
               2,000 pairs' hits equal the host-seeding engine's; the
               full hit count printed beside the JAX engine's 40,044.
8. cascade  -- ``MegaPathPipeline.run_records`` on the real-soap4 cascade
               fixture (two NT shards), on device and on host seeding:
               the report byte-identical to ``cascade/cascade.report``,
               the per-read records equal to ``cascade.lsam.id``.
9. world    -- every pipeline stage at 2 x 250 bp (``world_workload``:
               bbduk with the TruSeq table, the hg and ribo filters, two NT
               shards, mate rescue at W = 1152), on device and on host
               seeding: both reports, both LSAM.id digests and the five
               counters equal the JAX pipeline's records
               (``tests/fixtures/torch_pipeline_reports.json``).
10. pipeline -- the realistic run: phase 7's 512 Mbp shard as the human
               filter, ``tools/e2e_eval.py``'s community (22 species + 3
               decoys x 400 kbp) as the NT shard, its 50,000 pairs plus
               phase 7's 20,000 as human reads, bbduk on, device seeding.
               The human filter keeps exactly ``LARGE_HG_KEPT`` (two pairs
               the walk's step bound cannot seed); the reports and
               LSAM.id equal the JAX pipeline's over the community and
               those pairs, every taxon row equals the JAX e2e reports';
               1 warm-up and 3 timed ``run_records`` calls, the median
               reads/s and the stage split (bbduk, hg, nt, tail, other).

Each pipeline phase zeroes the kernels' launch counts before its run and
fails unless its engines launched the DP (and, on device seeding, the
walk and the locate). The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports torch, numpy and
``megapath_tpu_torch``, and nothing of jax or ``megapath_tpu``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FIX = HERE / "tests" / "fixtures"

from megapath_tpu_torch.align import device as tdev  # noqa: E402
from megapath_tpu_torch.filters.bbduk import build_kmer_ref  # noqa: E402
from megapath_tpu_torch.align import seeding_dev  # noqa: E402
from megapath_tpu_torch.align.engine import AlignEngine  # noqa: E402
from megapath_tpu_torch.align.output import best_per_seq, format_comment  # noqa: E402
from megapath_tpu_torch.align.params import AlignParams  # noqa: E402
from megapath_tpu_torch.index.fm import build_fm_index  # noqa: E402
from megapath_tpu_torch.index.pack import (  # noqa: E402
    PackedReference,
    pack_fasta,
    pack_fasta_file,
    pack_reads,
)
from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx, trim_readno  # noqa: E402
from megapath_tpu_torch import native  # noqa: E402
from megapath_tpu_torch.ops import _build, dp_cuda, seed_cuda  # noqa: E402
from megapath_tpu_torch.ops.dp import (  # noqa: E402
    OFF_TEXT_CODE,
    DPParams,
    sw_align,
    sw_align_full,
)
from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline, PipelineConfig  # noqa: E402
from megapath_tpu_torch.taxonomy.taxdb import TaxDB  # noqa: E402
from megapath_tpu_torch.utils.timing import StageTimer  # noqa: E402

# (source in the repo, the TPU kernel or XLA program it replaces)
KERNELS = {
    "dp_full": ("megapath_tpu_torch/csrc/dp_full.cu",
                "megapath_tpu/ops/dp_pallas.py:248"),
    "dp_fwd": ("megapath_tpu_torch/csrc/dp_full.cu",
               "megapath_tpu/ops/dp_pallas.py:27"),
    "mmp_seed": ("megapath_tpu_torch/csrc/mmp_seed.cu",
                 "megapath_tpu/align/seeding_jax.py:346"),
    "locate": ("megapath_tpu_torch/csrc/locate.cu",
               "megapath_tpu/align/seeding_jax.py:1031"),
}
FIELDS = ("score", "end_ref", "end_read", "start_ref", "start_read")
FWD_FIELDS = ("score", "end_ref", "end_read")
STEP_FIELDS = ("score", "end_ref", "end_read", "passed")
SEED_FIELDS = ("offset", "length", "sa_lo", "sa_count", "n_seeds")
# the JAX engine's full hit count on the 512 Mbp workload (BENCH_r05.json)
LARGE_JAX_HITS = 40044
LARGE_GATE_PAIRS = 2000
# pairs of each kind in the world workload; tests/fixtures/
# make_torch_pipeline_reports.py records the JAX pipeline at this count
WORLD_PAIRS_PER_KIND = 8
# the 512 Mbp workload's pairs that the realistic pipeline cell's human
# filter keeps, on both seeding paths: each end's substitutions lie near
# the end its productive walker starts from, and the walk spends its
# charged-step bound (3L + 64, the reference's, seeding.py / seeding_jax.py)
# on the short matches there before it reaches the 60-65 bp exact segment
# (with 1,000 steps it seeds them). They reach the NT stage unclassified.
LARGE_HG_KEPT = (5190, 15363)
CASCADE = FIX / "cascade"
# The card's peaks the bounds use (NVIDIA H100 SXM): device memory at
# 3.35 TB/s, and the DP's cell rate: 64 integer lanes a clock x 132 SMs x
# 1.98 GHz (the maximum SM clock) over 3 lane-instructions a cell (DPX in
# 16x2 form: one cell pair in 6).
HBM_BYTES_PER_S = 3.35e12
DP_CELLS_PER_S = 64 * 132 * 1.98e9 / 3
# what a rank reads of an occ row (4 checkpoints | 8 BWT words; its 4
# pad words are never loaded)
OCC_ROW_BYTES = 48
MARK_ROW_BYTES = 8  # one mark row: bitmap word, rank checkpoint


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


def padded_batch(rng: np.random.Generator, C: int, L: int, R: int, W: int):
    """Planted candidates with reads of at most ``L`` chars in rows
    padded to ``R`` (the pipeline pads reads to its max_read_len)."""
    reads, refs, rl, wl = planted_batch(rng, C, L, W)
    return np.pad(reads, ((0, 0), (0, R - L))), refs, rl, wl


def tie_batch(rng: np.random.Generator, R: int, W: int, C: int = 64):
    """Periodic reads in periodic windows (periods 1-4, 6), so that many
    cells share the best score in both passes: the forward pass must take
    the lowest j, then the lowest i, the backward pass the highest j, then
    the highest i. Each adjacent pair of candidates differs in read and
    window length."""
    reads = np.zeros((C, R), np.uint8)
    refs = np.zeros((C, W), np.uint8)
    rl = np.zeros(C, np.int32)
    wl = np.zeros(C, np.int32)
    for b in range(C):
        p = int(rng.choice([1, 2, 3, 4, 6]))
        motif = rng.integers(0, 4, p).astype(np.uint8)
        refs[b] = np.resize(motif, W)
        phase = int(rng.integers(0, p))
        read = np.resize(np.roll(motif, -phase), R)
        if b % 3 == 1:  # a mismatch in the middle splits the read's runs
            read[R // 2] = (read[R // 2] + 1) % 4
        reads[b] = read
        rl[b] = int(rng.integers(1, R + 1)) if b % 2 else R
        wl[b] = int(rng.integers(1, W + 1)) if b % 2 == 0 else W
    return reads, refs, rl, wl


def pair_lens_batch(rng: np.random.Generator, R: int, W: int, C: int = 64):
    """Planted candidates where the two of each pair (rows 2p, 2p + 1,
    the kernel's two register halves) differ in read_lens and ref_lens:
    every odd row's read and window are cut to about a third and a half."""
    reads, refs, rl, wl = planted_batch(rng, C, R, W)
    rl[1::2] = np.maximum(1, rl[1::2] // 3)
    wl[1::2] = np.maximum(1, wl[1::2] // 2)
    return reads, refs, rl, wl


def dp_work(read_lens, ref_lens, R: int, W: int, res=None) -> tuple:
    """(cells, bytes) a DP launch must cover: the forward cells
    sum(rl * wl) (lengths clamped to R and W) and, given the full
    result, the backward cells sum(end_read * end_ref); the bytes read
    once (reads, windows, lengths) and written once (3 outputs, or 5)."""
    rl = np.clip(np.asarray(read_lens, np.int64), 0, R)
    wl = np.clip(np.asarray(ref_lens, np.int64), 0, W)
    cells = int((rl * wl).sum())
    n_out = 3
    if res is not None:
        cells += int((np.asarray(res.end_read, np.int64) * np.asarray(res.end_ref, np.int64)).sum())
        n_out = 5
    C = len(rl)
    return cells, C * (R + W + 8 + 4 * n_out)


def walk_bytes(n_walkers: int, L: int, max_seeds: int, stats: dict) -> int:
    """Bytes a seed walk must move, each input read once and each output
    written once: the walker codes and lengths, every occ row that the
    extending steps rank in and every k-mer table entry (two words) that
    the fresh steps look up (the plain walk's ``stats``), the slots and
    seed counts."""
    return (n_walkers * (L + 4) + stats["occ_rows"] * OCC_ROW_BYTES
            + stats["lut_keys"] * 8 + n_walkers * (16 * max_seeds + 4))


def locate_bytes(n_rows: int, stats: dict) -> int:
    """Bytes a locate must move, each input read once: each row in and
    out and one sampled position, every mark row and occ row the walk
    reads (the plain locate's ``stats``)."""
    return (n_rows * 12 + stats["mark_rows"] * MARK_ROW_BYTES
            + stats["occ_rows"] * OCC_ROW_BYTES)


def bound(cells: int, nbytes: int) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes at the memory rate
    and the DP cells at the cell rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = cells / DP_CELLS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


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


def large_workload(
    device: torch.device,
    n_seqs: int = 8,
    seq_len: int = 64_000_000,
    n_pairs: int = 20_000,
    read_len: int = 100,
    insert: int = 350,
    seed: int = 23,
    lut_k: int = 8,
    sa_interval: int = 4,
):
    """The 512 Mbp bench shard, drawn as ``tools/build_bench_shard.build``
    draws it (same generator, same order of draws): ``n_seqs`` random
    sequences of ``seq_len``, an FM index with ``sa_interval`` 4 and an
    8-mer table built on ``device``, and ``n_pairs`` pairs at the insert
    size with Poisson(1) substitutions per read. Returns (ref, fm,
    reads1, lens1, reads2, lens2) as numpy."""
    ref, *batch = large_draw(n_seqs, seq_len, n_pairs, read_len, insert, seed)
    fm = build_fm_index(ref.codes, sa_interval=sa_interval, lut_k=lut_k, device=device)
    return (ref, fm, *batch)


def large_draw(
    n_seqs: int = 8,
    seq_len: int = 64_000_000,
    n_pairs: int = 20_000,
    read_len: int = 100,
    insert: int = 350,
    seed: int = 23,
):
    """``large_workload``'s shard text and pairs without its index:
    (ref, reads1, lens1, reads2, lens2)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n_seqs * seq_len, dtype=np.int64).astype(np.uint8)
    names = [f"bigseq{i}" for i in range(n_seqs)]
    ref = PackedReference(
        codes=codes,
        names=names,
        annotations=list(names),
        offsets=np.arange(n_seqs + 1, dtype=np.int64) * seq_len,
        ambiguous=np.zeros((0, 2), np.int64),
    )
    reads1 = np.zeros((n_pairs, read_len), dtype=np.uint8)
    reads2 = np.zeros((n_pairs, read_len), dtype=np.uint8)
    comp = np.array([3, 2, 1, 0], np.uint8)
    for i in range(n_pairs):
        p = (i % n_seqs) * seq_len + int(rng.integers(0, seq_len - insert))
        r1 = codes[p : p + read_len].copy()
        r2 = comp[codes[p + insert - read_len : p + insert][::-1]].copy()
        for arr in (r1, r2):
            for _ in range(int(rng.poisson(1.0))):
                q = int(rng.integers(0, read_len))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        reads1[i], reads2[i] = r1, r2
    lens = np.full(n_pairs, read_len, dtype=np.int32)
    return ref, reads1, lens, reads2, lens.copy()


def human_pairs(reads1, lens1, reads2, lens2, rows=None):
    """The 512 Mbp workload's pairs as the pipeline's human reads
    (name ``hg`` + the pair index, quality 'I')."""
    rows = range(len(lens1)) if rows is None else rows
    qual = "I" * reads1.shape[1]
    return [(f"hg{i:06d}", _text(reads1[i, : lens1[i]]), qual,
             _text(reads2[i, : lens2[i]]), qual) for i in rows]


# the TruSeq adapter the world's read-through pairs carry (both packages
# build their bbduk k-mer table from this one string)
TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0], np.uint8)


def _text(codes: np.ndarray) -> str:
    return _ACGT[codes].tobytes().decode()


def world_workload(n: int = 8, read_len: int = 250, insert: int = 600, seed: int = 123):
    """Every stage of the pipeline at 2 x 250 bp. The genomes are
    ``tests/test_pipeline.py``'s world (seed 123: two NT shards of two
    species each, a human shard) plus a 3 kb ribosome sequence drawn next
    from the same generator. The pairs, ``n`` per kind: from each NT
    species (Poisson(2) substitutions per end), NT pairs whose second end
    has a substitution every 12th base (no seed survives: mate rescue finds
    it), human and ribosome pairs (the hg and ribo stages remove them),
    low-complexity pairs, pairs whose ends run into the TruSeq adapter
    (kmask), pairs with a '#'-quality tail and a few N bases (quality
    trim), and random pairs. Returns {"nt": [shard0, shard1], "hg": [...],
    "ribo": [...]} with a shard as a list of (name, description, codes),
    and the pairs as (name, seq1, qual1, seq2, qual2)."""
    rng = np.random.default_rng(seed)
    mk = lambda k: rng.integers(0, 4, k).astype(np.uint8)  # noqa: E731
    nt0 = [("NC_000913.1", "Escherichia coli K-12", mk(8000)),
           ("NC_003197.1", "Salmonella enterica", mk(7000))]
    nt1 = [("NC_045512.1", "SARS-CoV-2", mk(5000)),
           ("NC_002645.1", "HCoV-229E", mk(4000))]
    hg = [("NC_000001.1", "Homo sapiens chr1", mk(9000))]
    ribo = [("SILVA_1", "", mk(3000))]
    good = "I" * read_len

    def pair(g, subs=True):
        p = int(rng.integers(0, len(g) - insert))
        a = g[p : p + read_len].copy()
        b = _COMP[g[p + insert - read_len : p + insert][::-1]].copy()
        if subs:
            for arr in (a, b):
                for _ in range(int(rng.poisson(2.0))):
                    q = int(rng.integers(0, read_len))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        return a, b

    pairs = []
    for shard in (nt0, nt1):
        for acc, _, g in shard:
            for i in range(n):
                a, b = pair(g)
                pairs.append((f"{acc}_{i}", _text(a), good, _text(b), good))
    for i in range(n):  # the mate only rescue finds
        a, b = pair(nt0[i % 2][2], subs=False)
        b[(np.arange(read_len) % 12) == 5] ^= 1
        pairs.append((f"rescue{i}", _text(a), good, _text(b), good))
    for tag, g, subs in (("human", hg[0][2], True), ("ribo", ribo[0][2], False)):
        for i in range(n):
            a, b = pair(g, subs)
            pairs.append((f"{tag}{i}", _text(a), good, _text(b), good))
    for i in range(n):  # low complexity
        unit = "AT" if i % 2 else "AAC"
        s = (unit * read_len)[:read_len]
        pairs.append((f"lowc{i}", s, good, s[::-1], good))
    for i in range(n):  # read-through into the adapter
        a, b = pair(nt1[i % 2][2])
        tail = TRUSEQ + _text(mk(40 - len(TRUSEQ)))
        pairs.append((f"adapter{i}", _text(a)[:-40] + tail, good,
                      _text(b)[:-40] + tail, good))
    for i in range(n):  # low-quality tail and N bases
        a, b = pair(nt0[i % 2][2])
        sa = list(_text(a))
        for q in rng.integers(0, read_len, 3):
            sa[int(q)] = "N"
        bad = "I" * (read_len - 60) + "#" * 60
        pairs.append((f"qtail{i}", "".join(sa), bad, _text(b), bad))
    for i in range(n):
        pairs.append((f"random{i}", _text(mk(read_len)), good, _text(mk(read_len)), good))
    return {"nt": [nt0, nt1], "hg": hg, "ribo": ribo, "pairs": pairs}


def e2e_workload(n_pairs: int = 50_000, n_species: int = 22, n_decoys: int = 3,
                 genome_len: int = 400_000, read_len: int = 100, insert: int = 320,
                 err: float = 0.005, seed: int = 67):
    """The simulated community of ``tools/e2e_eval.py`` (``simulate``),
    drawn in memory by the same generator in the same order: ``n_species``
    + ``n_decoys`` random genomes, uneven abundance over ~4 orders of
    magnitude, pairs with ``err`` substitutions per base. Returns (genomes
    as [(name, codes)], pairs as (name, seq1, qual1, seq2, qual2))."""
    rng = np.random.default_rng(seed)
    genomes = [rng.integers(0, 4, genome_len).astype(np.uint8)
               for _ in range(n_species + n_decoys)]
    w = np.logspace(0, -3.7, n_species)
    w /= w.sum()
    counts = rng.multinomial(n_pairs, w)
    rows = [sp for sp in range(n_species) for _ in range(counts[sp])]
    rng.shuffle(rows)
    qual = "I" * read_len
    pairs = []
    for i, sp in enumerate(rows):
        g = genomes[sp]
        p = int(rng.integers(0, genome_len - insert))
        r1 = g[p : p + read_len].copy()
        r2 = _COMP[g[p + insert - read_len : p + insert][::-1]].copy()
        for arr in (r1, r2):
            for _ in range(int(rng.binomial(read_len, err))):
                q = int(rng.integers(0, read_len))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        pairs.append((f"rd{i:06d}", _text(r1), qual, _text(r2), qual))
    return [(f"genome{i}", g) for i, g in enumerate(genomes)], pairs


def write_e2e_taxonomy(d: Path, n_genomes: int = 25) -> None:
    """The community's taxonomy files, as ``tools/e2e_eval.write_taxonomy``
    writes them: one species per genome under one superkingdom."""
    with open(d / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\t\n")
        f.write("2\t|\t1\t|\tsuperkingdom\t|\t\n")
        for i in range(n_genomes):
            f.write(f"{10+i}\t|\t2\t|\tspecies\t|\t\n")
    with open(d / "names.dmp", "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        f.write("2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
        for i in range(n_genomes):
            f.write(f"{10+i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n")
    with open(d / "acc2tid.map", "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for i in range(n_genomes):
            f.write(f"genome{i}\tgenome{i}.1\t{10+i}\t0\n")


def pipeline_record(res) -> dict:
    """What the pipeline gates compare (either package's PipelineResult):
    both reports, the sha256 of both LSAM.id texts and the counters."""
    def sha(recs):
        return hashlib.sha256("".join(r.to_line() + "\n" for r in recs).encode()).hexdigest()

    return {
        "report": res.report, "ra_report": res.ra_report,
        "lsam_sha256": sha(res.lsam_id), "ra_lsam_sha256": sha(res.ra_lsam_id),
        "counters": {k: getattr(res, k) for k in PIPELINE_COUNTERS},
    }


PIPELINE_COUNTERS = ("n_input_pairs", "n_after_preprocess", "n_after_human",
                     "spike_removed", "n_after_ribo")


def graft_inputs(device: torch.device):
    """The single-chip entry's inputs (``__graft_entry__.entry``: the
    same draws): a 64 kbp shard and C = 256 candidates of L = 128 with
    W = 256 windows, every other one a real 100 bp match. Returns
    (ref, reads, lens, starts) tensors on ``device`` and W."""
    rng = np.random.default_rng(0)
    N, C, L, W = 1 << 16, 256, 128, 256
    ref = rng.integers(0, 4, N).astype(np.uint8)
    reads = rng.integers(0, 4, (C, L)).astype(np.uint8)
    starts = rng.integers(0, N - W, C).astype(np.int32)
    for c in range(0, C, 2):
        p = int(starts[c]) + 20
        reads[c, :100] = ref[p : p + 100]
    lens = np.full(C, 100, dtype=np.int32)
    return [torch.from_numpy(a).to(device) for a in (ref, reads, lens, starts)], W


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


def mini_taxdb(fix_dir: Path = FIX) -> TaxDB:
    """The port's TaxDB over the mini taxonomy of ``tests/fixtures``."""
    db = TaxDB(size=1024)
    db.read_nodes(fix_dir / "nodes.dmp")
    db.read_names(fix_dir / "names.dmp")
    db.read_acc2tid(fix_dir / "acc2tid.map")
    return db


def fastq_records(pairs):
    """(recs1, recs2) of the port's FastqRecord from (name, seq1, qual1,
    seq2, qual2) tuples."""
    return ([FastqRecord(n, s1, q1) for n, s1, q1, _, _ in pairs],
            [FastqRecord(n, s2, q2) for n, _, _, s2, q2 in pairs])


def pairs_digest(pairs) -> str:
    h = hashlib.sha256()
    for p in pairs:
        h.update("\t".join(p).encode() + b"\n")
    return h.hexdigest()


def cascade_pipeline(dev: torch.device, device_seeding: bool) -> MegaPathPipeline:
    """The port's pipeline over the real-soap4 cascade fixture's two shards
    (``tests/test_cascade_parity.py``'s configuration)."""
    def shard(path):
        ref = pack_fasta_file(path)
        return ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=dev)

    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True,
                         device_seeding=device_seeding)
    return MegaPathPipeline([shard(CASCADE / "shard0.fa"), shard(CASCADE / "shard1.fa")],
                            mini_taxdb(), config=cfg, device=dev)


def cascade_reads():
    recs1, recs2 = list(read_fastx(CASCADE / "r1.fq")), list(read_fastx(CASCADE / "r2.fq"))
    for r in recs1 + recs2:
        r.name = trim_readno(r.name)
    return recs1, recs2


def lsam_id_table(lines) -> dict:
    """(name, flag) -> (score, set of hit taxids) of LSAM.id lines, as
    ``tests/test_cascade_parity.py`` compares them."""
    out = {}
    for line in lines:
        c = line.rstrip("\n").split("\t")
        hits = frozenset(h.split(",")[1] for h in c[5].split(";")) if c[5] != "*" else frozenset()
        out[(c[0], c[1])] = (int(float(c[2])), hits)
    return out


def world_config(device_seeding: bool) -> PipelineConfig:
    return PipelineConfig(read_len=250, max_read_len=250, device_seeding=device_seeding)


def world_pipeline(world, dev: torch.device, device_seeding: bool) -> MegaPathPipeline:
    """The port's pipeline over ``world_workload``'s shards: bbduk with the
    TruSeq table, the hg and ribo filters and two NT shards."""
    def shard(seqs):
        ref = pack_fasta([FastqRecord(name, _text(codes), "", desc)
                          for name, desc, codes in seqs])
        return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=dev)

    return MegaPathPipeline(
        [shard(s) for s in world["nt"]], mini_taxdb(), hg_shard=shard(world["hg"]),
        adapters=build_kmer_ref([TRUSEQ], k=27, hdist=1),
        config=world_config(device_seeding), ribo_shard=shard(world["ribo"]), device=dev,
    )


def text_diff(got: str, want: str) -> tuple:
    """Line counts and the first differing lines of two texts."""
    g, w = got.splitlines(), want.splitlines()
    return f"{len(g)} vs {len(w)} lines", [
        (i, a, b) for i, (a, b) in enumerate(zip(g, w)) if a != b][:5]


def record_diff(got: dict, want: dict) -> list:
    """The fields of two pipeline records that differ, with the first
    differing report lines."""
    bad = [(k, *text_diff(got[k], want[k])) for k in ("report", "ra_report")
           if got[k] != want[k]]
    for k in ("lsam_sha256", "ra_lsam_sha256"):
        if got[k] != want[k]:
            bad.append((k, got[k][:16], want[k][:16]))
    if got["counters"] != want["counters"]:
        bad.append(("counters", got["counters"], want["counters"]))
    return bad


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
    t = time.perf_counter()
    libs = [native.build(name, force=True).name for name in ("bbduk", "spike")]
    print(f"[build] g++ built the host libraries {', '.join(libs)} in "
          f"{time.perf_counter() - t:.1f} s")
    # ptxas -v: an entry function's mangled name (dp_wave_kernel<G, CH,
    # bwd> is "dp_wave_kernelILi<G>ELi<CH>ELb<bwd>EE"), then its register line
    name = "?"
    for ln in _build.LOG_PATH.read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z][a-z_]*_kernel)(I(?:L[a-z]\d+E)+E)?", ln)
            name = m.group(1) + (f"<{','.join(re.findall(r'L[a-z](\d+)E', m.group(2)))}>"
                                 if m.group(2) else "")
        elif "registers" in ln or "spill stores" in ln and " 0 bytes spill" not in ln:
            print(f"[build] ptxas {name}: {ln.split('ptxas info    :')[-1].strip()}")


# ~1 ms of a spinning kernel ahead of each timed call: the card is busy
# while the host runs the wrapper's Python and enqueues the launch, so the
# events around it time the card's work and not the host's
SPIN_CYCLES = 2_000_000


def _median_ms(fn, reps: int = 10) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(got, want, fields) -> dict:
    return {
        f: int((getattr(got, f).long() - getattr(want, f).long()).abs().max())
        if getattr(got, f).numel() else 0
        for f in fields
    }


def _hold(tag: str, got, want, fields) -> int:
    """The largest |kernel - plain| over the outputs; raises unless it
    is 0 (every output of the kernel equals the plain one)."""
    torch.cuda.synchronize()
    errs = _max_err(got, want, fields)
    if max(errs.values()) != 0:
        raise AssertionError(f"[kernels] {tag}: kernel != plain, max |err| per output {errs}")
    return max(errs.values())


def _share(ms: float, bound_ms: float) -> str:
    return f"bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it"


def kernels_dp(dev: torch.device, smi: str) -> dict:
    """dp_full and dp_fwd against sw_align_full and sw_align, at the main
    path's shapes, the contract's corners and every (lanes a pair, rows a
    lane) instantiation the library holds (W up to dp_cuda.MAX_WIDTH)."""
    rng = np.random.default_rng(20261016)
    params = DPParams()
    lib = _build.load()
    if lib.mp_dp_full_max_width() != dp_cuda.MAX_WIDTH:
        raise AssertionError(f"[kernels] the library takes W <= {lib.mp_dp_full_max_width()}, "
                             f"dp_cuda.MAX_WIDTH is {dp_cuda.MAX_WIDTH}")
    print(f"[kernels] mp_dp_full_max_width() == dp_cuda.MAX_WIDTH == {dp_cuda.MAX_WIDTH}")
    # the windows past 1024 rows (32 lanes, CH = 36-64): the 2x250 mate
    # rescue (W = 1152), the widest the engine makes (L = 1023: W = 1920)
    # and the first width past 1024
    wide = [
        ("mate_rescue_250bp", planted_batch(rng, 1024, 250, 1152)),
        ("widest_l1023", planted_batch(rng, 256, 1023, 1920)),
        ("edge_w1025", edge_batch(rng, 250, 1025)),
        ("padded_r1024", padded_batch(rng, 256, 250, 1024, 1152)),
    ]
    # the main path's shapes: deep DP at 100 bp (W = 192: 16 lanes x 12
    # rows at C = 4,096) and 150 bp (W = 256), mate rescue at 100 bp (W =
    # 1024: 32 x 32) and 80 bp (W = 896: rows past 896 are padding); an odd
    # C (the last pair's high half empty), C = 3 and C = 1; pairs whose two
    # halves differ in read and window length; ties for both passes'
    # orders; the contract's corners
    cases = [
        ("deep_dp", planted_batch(rng, 4096, 100, 192)),
        ("mate_rescue", planted_batch(rng, 1024, 100, 1024)),
        ("deep_dp_150bp", planted_batch(rng, 4096, 150, 256)),
        ("mate_rescue_80bp", planted_batch(rng, 1024, 80, 896)),
        ("ragged_c", planted_batch(rng, 1001, 100, 192)),
        ("odd_c3", planted_batch(rng, 3, 100, 192)),
        ("one_c", planted_batch(rng, 1, 100, 1024)),
        ("pair_lens_w192", pair_lens_batch(rng, 100, 192)),
        ("pair_lens_w1152", pair_lens_batch(rng, 250, 1152)),
        ("ties_w192", tie_batch(rng, 100, 192)),
        ("ties_w1024", tie_batch(rng, 100, 1024)),
        ("ties_w1920", tie_batch(rng, 1000, 1920, C=33)),
        ("edge_w192", edge_batch(rng, 100, 192)),
        ("edge_w1024", edge_batch(rng, 100, 1024)),
    ] + wide
    # every instantiation the library holds, through both kernels: 8 lanes
    # a pair take C >= 4,224 on 132 SMs (pairs x 8 / 32 >= 4 warps an SM),
    # 16 lanes C >= 2,112, 32 lanes the rest and every W > 512
    coverage = [(8192, 40, w) for w in (32, 48, 64, 96, 128, 192, 256)] + [
        (3000, 60, w) for w in (64, 96, 128, 192, 256, 384, 512)] + [
        (256, 120, w) for w in (128, 192, 256, 384, 512, 768, 1024, 1152, 1280,
                                1536, 1792, 2048)]
    # the plain version's repetitions for each timed case (its widest
    # call is ~2,000 column steps of small ops)
    timed = {"deep_dp": 10, "mate_rescue": 10, "deep_dp_150bp": 10,
             "mate_rescue_80bp": 10, "mate_rescue_250bp": 10, "widest_l1023": 3}
    full = {"max_abs_err": 0, "library_ms": None}
    for tag, batch in cases:
        t = [torch.from_numpy(a).to(dev) for a in batch]
        got = dp_cuda.sw_align_full_cuda(*t, params)
        want = sw_align_full(*t, params)
        full["max_abs_err"] = max(full["max_abs_err"], _hold(
            f"dp_full {tag}", got, want, FIELDS))
        C, R = batch[0].shape
        W = batch[1].shape[1]
        line = f"[kernels] dp_full {tag} C={C} R={R} W={W}: 5/5 outputs equal (tolerance 0)"
        if tag in timed:
            ms = _median_ms(lambda: dp_cuda.sw_align_full_cuda(*t, params))
            plain_ms = _median_ms(lambda: sw_align_full(*t, params), reps=timed[tag])
            cells, nbytes = dp_work(batch[2], batch[3], R, W, got._replace(
                **{f: getattr(got, f).cpu() for f in FIELDS}))
            bound_ms, by = bound(cells, nbytes)
            if "ms" not in full:
                full.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
            line += (f"; median: kernel {ms:.4f} ms (of 10), plain {plain_ms:.4f} ms "
                     f"(of {timed[tag]}); {cells} cells, {_share(ms, bound_ms)} "
                     f"({by}) [{smi}]")
        print(line)
    for C, R, W in coverage:
        t = [torch.from_numpy(a).to(dev) for a in planted_batch(rng, C, R, W)]
        full["max_abs_err"] = max(full["max_abs_err"], _hold(
            f"dp_full C={C} R={R} W={W}", dp_cuda.sw_align_full_cuda(*t, params),
            sw_align_full(*t, params), FIELDS))
        _hold(f"dp_fwd C={C} R={R} W={W}", dp_cuda.sw_align_cuda(*t, params),
              sw_align(*t, params), FWD_FIELDS)
    print(f"[kernels] dp_full and dp_fwd at every (lanes, rows) instantiation: "
          f"{len(coverage)} batches, C x R x W = "
          + ", ".join(f"{C}x{R}x{W}" for C, R, W in coverage) + ": outputs equal (tolerance 0)")
    t = [torch.from_numpy(a).to(dev) for a in planted_batch(rng, 8, 100, dp_cuda.MAX_WIDTH + 1)]
    try:
        dp_cuda.sw_align_full_cuda(*t, params)
    except ValueError as e:
        print(f"[kernels] dp_full refuses W = {dp_cuda.MAX_WIDTH + 1}: {e}")
    else:
        raise AssertionError(f"[kernels] dp_full took W = {dp_cuda.MAX_WIDTH + 1}")
    # the forward-only kernel: the graft entry's shape, the deep DP's,
    # and the contract's corners
    ref, reads, lens, starts = graft_inputs(dev)[0]
    wins = tdev.gather_windows(ref, starts, 256)
    graft = (reads, wins, lens, torch.full_like(lens, 256))
    on_dev = lambda b: [torch.from_numpy(a).to(dev) for a in b]  # noqa: E731
    fwd_cases = [
        ("graft", graft),
        ("deep_dp", on_dev(planted_batch(rng, 4096, 100, 192))),
        ("mate_rescue", on_dev(planted_batch(rng, 1024, 100, 1024))),
        ("odd_c3", on_dev(planted_batch(rng, 3, 100, 192))),
        ("pair_lens_w1152", on_dev(pair_lens_batch(rng, 250, 1152))),
        ("ties_w192", on_dev(tie_batch(rng, 100, 192))),
        ("edge_w192", on_dev(edge_batch(rng, 100, 192))),
    ] + [(tag, on_dev(batch)) for tag, batch in wide]
    fwd = {"max_abs_err": 0, "library_ms": None}
    for tag, t in fwd_cases:
        fwd["max_abs_err"] = max(fwd["max_abs_err"], _hold(
            f"dp_fwd {tag}", dp_cuda.sw_align_cuda(*t, params), sw_align(*t, params),
            FWD_FIELDS))
        C, R = t[0].shape
        W = t[1].shape[1]
        line = f"[kernels] dp_fwd {tag} C={C} R={R} W={W}: 3/3 outputs equal (tolerance 0)"
        if not tag.startswith(("edge", "odd", "pair", "ties", "padded")):
            reps = timed.get(tag, 10)
            ms = _median_ms(lambda: dp_cuda.sw_align_cuda(*t, params))
            plain_ms = _median_ms(lambda: sw_align(*t, params), reps=reps)
            cells, nbytes = dp_work(t[2].cpu().numpy(), t[3].cpu().numpy(), R, W)
            bound_ms, by = bound(cells, nbytes)
            if "ms" not in fwd:
                fwd.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
            line += (f"; median: kernel {ms:.4f} ms (of 10), plain {plain_ms:.4f} ms "
                     f"(of {reps}); {cells} cells, {_share(ms, bound_ms)} ({by}) [{smi}]")
        print(line)
    reads, refs, rl, wl = planted_batch(rng, 8, 1024, 1152)
    rl[3], wl[3] = 1024, 1152  # one candidate can score 1024
    t = [torch.from_numpy(a).to(dev) for a in (reads, refs, rl, wl)]
    try:
        dp_cuda.sw_align_cuda(*t, params)
    except ValueError as e:
        print(f"[kernels] dp_fwd refuses a 1,024 bp read in a 1,152-row window: {e}")
    else:
        raise AssertionError("[kernels] dp_fwd took min(read_len, win_len) * match = 1024")
    return {"dp_full": full, "dp_fwd": fwd}


def long_read_walkers(dev: torch.device, ref_codes: np.ndarray, n: int, L: int, seed: int):
    """Walkers of ``n`` read ends of length ``L`` drawn from a shard's text
    with Poisson(L / 100) substitutions each: (walkers, lens) on ``dev``."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, len(ref_codes) - L))
        reads[i] = ref_codes[p : p + L]
        for _ in range(int(rng.poisson(L / 100))):
            q = int(rng.integers(0, L))
            reads[i, q] = (reads[i, q] + 1 + rng.integers(0, 3)) % 4
    lens = torch.full((n,), L, dtype=torch.int32, device=dev)
    return seeding_dev.build_walkers(torch.from_numpy(reads).to(dev), lens)


def kernels_seeding(dev: torch.device, smi: str, toy) -> dict:
    """mmp_seed and locate against their plain versions: the walk on 2 x
    4,096 read ends of the toy workload (the engine's walker layout) under
    the default and the exact dials, the exact rescue's shape (1,024
    walkers, exact dials), an odd walker count, and 250 bp and 1,023 bp
    walkers; the locate on every SA row the default walk's seeds expand
    to. The walk's time is also given per iteration of its longest
    walker."""
    ref, fm, reads1, lens1, reads2, lens2 = toy
    dfm = seeding_dev.DeviceFM.from_host(fm, dev)
    reads = np.concatenate([reads1[:2048], reads2[:2048]])
    lens = np.concatenate([lens1[:2048], lens2[:2048]])
    walkers, wlens = seeding_dev.build_walkers(
        torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)
    )
    base = AlignParams().mmp
    exact = dataclasses.replace(base, kill_ratio=0.0, sibling_kill_steps=0)
    # the rescue walks the needy pairs' read ends: 512 of them here
    rw = torch.cat([walkers[:512], walkers[4096 : 4096 + 512]])
    rl = torch.cat([wlens[:512], wlens[4096 : 4096 + 512]])
    w250 = long_read_walkers(dev, ref.codes, 512, 250, seed=250)
    w1023 = long_read_walkers(dev, ref.codes, 128, 1023, seed=1023)
    cases = [  # (tag, walkers, lens, dials, timed)
        ("toy default dials", walkers, wlens, base, True),
        ("toy exact dials", walkers, wlens, exact, True),
        ("rescue exact dials", rw, rl, exact, True),
        ("odd walker count", walkers[:1023], wlens[:1023], base, False),
        ("L=250 default dials", *w250, base, False),
        ("L=1023 default dials", *w1023, base, False),
    ]
    out = {"mmp_seed": {"max_abs_err": 0, "library_ms": None}}
    for tag, wk, wl, mmp, is_timed in cases:
        L = wk.shape[1]
        max_seeds, chg = int(min(16, max(4, L // 16 + 2))), 3 * L + 64
        args = (dfm, wk, wl, mmp, max_seeds, chg, chg)
        got = seed_cuda.mmp_seed_cuda(*args)
        stats = {}
        want = seeding_dev.mmp_seed_device_plain(*args, stats=stats)
        err = _hold(f"mmp_seed {tag}", got, want, SEED_FIELDS)
        out["mmp_seed"]["max_abs_err"] = max(out["mmp_seed"]["max_abs_err"], err)
        line = (f"[kernels] mmp_seed {tag}: {wk.shape[0]} walkers x {L}, "
                f"{int(got.n_seeds.sum())} seeds, 5/5 outputs equal (tolerance 0), "
                f"{stats['iterations']} iterations")
        if is_timed:
            ms = _median_ms(lambda: seed_cuda.mmp_seed_cuda(*args))
            plain_ms = _median_ms(lambda: seeding_dev.mmp_seed_device_plain(*args), reps=3)
            bound_ms, by = bound(0, walk_bytes(wk.shape[0], L, max_seeds, stats))
            line += (f"; median: kernel {ms:.4f} ms (of 10) = "
                     f"{1e3 * ms / stats['iterations']:.3f} us an iteration, plain "
                     f"{plain_ms:.4f} ms (of 3); {_share(ms, bound_ms)} ({by}) [{smi}]")
            if "ms" not in out["mmp_seed"]:
                out["mmp_seed"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=by, iterations=stats["iterations"])
                flat = seeding_dev.flatten_seeds(got)
                rows = seeding_dev.expand_rows(flat.sa_lo, flat.sa_count)
        print(line)
    try:
        seed_cuda.mmp_seed_cuda(dfm, walkers, wlens, base, seed_cuda.MAX_SEEDS + 1)
    except ValueError as e:
        print(f"[kernels] mmp_seed refuses max_seeds = {seed_cuda.MAX_SEEDS + 1}: {e}")
    else:
        raise AssertionError(f"[kernels] mmp_seed took max_seeds = {seed_cuda.MAX_SEEDS + 1}")
    got = seed_cuda.locate_cuda(dfm, rows)
    stats = {}
    want = seeding_dev.locate_device_plain(dfm, rows, stats=stats)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or bool((got < 0).any()):
        raise AssertionError(f"[kernels] locate: kernel != plain (max |err| {err}) or unresolved rows")
    ms = _median_ms(lambda: seed_cuda.locate_cuda(dfm, rows))
    plain_ms = _median_ms(lambda: seeding_dev.locate_device_plain(dfm, rows))
    bound_ms, by = bound(0, locate_bytes(len(rows), stats))
    print(f"[kernels] locate: {len(rows)} SA rows of those seeds, positions equal "
          f"(tolerance 0); median of 10: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{stats['lf_steps']} LF steps, {_share(ms, bound_ms)} ({by}) [{smi}]")
    out["locate"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                     "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    return out


def phase_golden(dev: torch.device) -> None:
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=dev)
    for device_seeding in (False, True):
        engine = AlignEngine(ref, fm, AlignParams(), device=dev,
                             device_seeding=device_seeding)
        bad, n = golden_mismatches(engine)
        path = "device" if device_seeding else "host"
        print(f"[golden] soap4 fixture on {dev}, {path} seeding: "
              f"{len(bad)}/{n} read-end mismatches")
        if bad:
            raise AssertionError(f"[golden] {path} seeding mismatches vs soap4: {bad[:5]}")


def zero_counts() -> None:
    dp_cuda.launches = dp_cuda.fwd_launches = 0
    seed_cuda.walk_launches = seed_cuda.locate_launches = 0


def read_counts() -> dict:
    return {
        "dp_full": dp_cuda.launches, "dp_fwd": dp_cuda.fwd_launches,
        "mmp_seed": seed_cuda.walk_launches, "locate": seed_cuda.locate_launches,
    }


def phase_step(dev: torch.device) -> int:
    """align_step and pair_align_step on the graft entry's inputs."""
    (ref, reads, lens, starts), W = graft_inputs(dev)
    C = reads.shape[0] // 2
    zero_counts()
    step = tdev.align_step(ref, reads, lens, starts, W)
    pair, keep = tdev.pair_align_step(
        ref, reads[:C], lens[:C], starts[:C], reads[C:], lens[C:], starts[C:], W
    )
    torch.cuda.synchronize()
    launches = read_counts()["dp_fwd"]
    cpu = [t.cpu() for t in (ref, reads, lens, starts)]
    want = tdev.align_step(*cpu, W)
    want_pair, want_keep = tdev.pair_align_step(
        cpu[0], cpu[1][:C], cpu[2][:C], cpu[3][:C], cpu[1][C:], cpu[2][C:],
        cpu[3][C:], W,
    )
    for tag, got, ref_out in (("align_step", step, want), ("pair_align_step", pair, want_pair)):
        for f in STEP_FIELDS:
            if not torch.equal(getattr(got, f).cpu(), getattr(ref_out, f)):
                raise AssertionError(f"[step] {tag}.{f} differs from the plain version on the CPU")
    if not torch.equal(keep.cpu(), want_keep):
        raise AssertionError("[step] pair_align_step keep mask differs from the CPU's")
    n_pass = int(step.passed.sum())
    print(f"[step] align_step + pair_align_step at C={reads.shape[0]} L={reads.shape[1]} "
          f"W={W}: equal to the plain version on the CPU; {n_pass} candidates pass, "
          f"{int(keep.sum())} pairs kept; forward kernel launches {launches}")
    if launches <= 0 or n_pass < C // 2:
        raise AssertionError("[step] the step did not go through the forward kernel "
                             "or its planted matches did not pass")
    return launches


class Split:
    """Host-clock time per named stage of a pass, each timed call
    bracketed by torch.cuda.synchronize() so its device work is its own."""

    def __init__(self):
        self.t = collections.defaultdict(float)

    def wrap(self, name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.t[name] += time.perf_counter() - t0
        return run


def _timed_passes(engine, batch, n_timed: int, smi: str, tag: str):
    """1 warm-up and ``n_timed`` passes of align_pairs, each split into
    walk / locate / DP / rest. Returns (hits of the last pass, launch
    counts over all passes, median s/pass)."""
    split = Split()
    orig = (seeding_dev.mmp_seed_device, seeding_dev.locate_device)
    seeding_dev.mmp_seed_device = split.wrap("walk", orig[0])
    seeding_dev.locate_device = split.wrap("locate", orig[1])
    for name in ("_deep_dp_walk_call", "_device_align_rows",
                 "_deep_dp_fused_call", "_device_align"):
        setattr(engine, name, split.wrap("dp", getattr(engine, name)))
    n_reads = 2 * len(batch[1])
    try:
        zero_counts()
        engine.align_pairs(*batch)  # warm-up
        passes = []
        for _ in range(n_timed):
            split.t.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            hits = engine.align_pairs(*batch)
            torch.cuda.synchronize()
            passes.append((time.perf_counter() - t, dict(split.t)))
        counts = read_counts()
    finally:
        seeding_dev.mmp_seed_device, seeding_dev.locate_device = orig
    for dt, sp in passes:
        rest = dt - sum(sp.values())
        print(f"[{tag}] pass {dt:.3f} s = {n_reads / dt:.0f} reads/s; walk "
              f"{sp.get('walk', 0.0):.3f} s, locate {sp.get('locate', 0.0):.3f} s, "
              f"DP {sp.get('dp', 0.0):.3f} s, rest {rest:.3f} s")
    med = statistics.median(dt for dt, _ in passes)
    print(f"[{tag}] median of {n_timed}: {n_reads / med:.0f} reads/s ({med:.3f} s/pass), "
          f"hits={len(hits)} [{smi}]")
    print(f"[{tag}] kernel launches over the {n_timed + 1} passes: {counts}")
    return hits, counts, med


def _check_digest(tag: str, hits, want: dict) -> None:
    got = hits_digest(hits)
    if len(hits) != want["n_hits"] or got != want["hits_sha256"]:
        raise AssertionError(
            f"[{tag}] hits differ from the JAX engine's: {len(hits)} hits, "
            f"digest {got[:16]} vs {want['n_hits']} hits, {want['hits_sha256'][:16]}"
        )
    print(f"[{tag}] hits digest equals the JAX engine's ({got[:16]}, {len(hits)} hits)")


def make_toy(dev: torch.device):
    want = json.loads((FIX / "torch_toy_hits.json").read_text())
    t0 = time.perf_counter()
    toy = toy_workload(dev)
    ref, fm, reads1, lens1, reads2, lens2 = toy
    print(f"[toy] workload ready in {time.perf_counter() - t0:.1f} s: "
          f"{ref.total_len} bp, {len(lens1)} pairs x {reads1.shape[1]} bp")
    got_in = workload_digest(ref.codes, reads1, lens1, reads2, lens2)
    if got_in != want["input_sha256"]:
        raise AssertionError(
            f"[toy] the workload's inputs differ from the fixture's "
            f"({got_in[:16]} vs {want['input_sha256'][:16]}): numpy's "
            f"generator drifted, this is not a port fault"
        )
    return toy


def phase_slice(dev: torch.device, smi: str, toy) -> None:
    ref, fm, *batch = toy
    engine = AlignEngine(ref, fm, AlignParams(), device=dev, device_seeding=True)
    hits, counts, _ = _timed_passes(engine, batch, 3, smi, "slice")
    for k in ("dp_full", "mmp_seed", "locate"):
        if counts[k] <= 0:
            raise AssertionError(f"[slice] the main path never launched {k}")
    _check_digest("slice", hits, json.loads((FIX / "torch_toy_hits_devseed.json").read_text()))
    host = AlignEngine(ref, fm, AlignParams(), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hits = host.align_pairs(*batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    print(f"[slice] host seeding, one pass: {dt:.3f} s = {2 * len(batch[1]) / dt:.0f} "
          f"reads/s [{smi}]")
    _check_digest("slice host", hits, json.loads((FIX / "torch_toy_hits.json").read_text()))


def phase_large(dev: torch.device, smi: str):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref, fm, *batch = large_workload(dev)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[large] {ref.total_len} bp shard, {len(batch[1])} pairs: drawn and indexed "
          f"in {build_s:.1f} s (suffix array and tables on the card), card peak "
          f"{peak:.2f} GiB [{smi}]")
    engine = AlignEngine(ref, fm, AlignParams(), device=dev, device_seeding=True)
    hits, counts, _ = _timed_passes(engine, batch, 3, smi, "large")
    print(f"[large] hits {len(hits)} (the JAX engine logged {LARGE_JAX_HITS} on this "
          f"workload, BENCH_r05.json)")
    sub = [a[:LARGE_GATE_PAIRS] for a in batch]
    want = AlignEngine(ref, fm, AlignParams(), device=dev).align_pairs(*sub)
    got = engine.align_pairs(*sub)
    if not np.array_equal(canonical_hits(got), canonical_hits(want)):
        raise AssertionError(
            f"[large] the first {LARGE_GATE_PAIRS} pairs' hits differ between device "
            f"and host seeding: {len(got)} vs {len(want)} hits"
        )
    print(f"[large] the first {LARGE_GATE_PAIRS} pairs: device-seeding hits equal the "
          f"host-seeding engine's ({len(got)} hits)")
    return ref, fm, batch


def _pipeline_records() -> dict:
    return json.loads((FIX / "torch_pipeline_reports.json").read_text())


def _require_launches(tag: str, counts: dict, names) -> None:
    for k in names:
        if counts[k] <= 0:
            raise AssertionError(f"[{tag}] the pipeline never launched {k}: {counts}")


def phase_pipeline_cascade(dev: torch.device) -> None:
    """The real-soap4 cascade golden through the port's pipeline on the
    card, on device and on host seeding: the report byte-identical, the
    per-read records equal."""
    golden = (CASCADE / "cascade.report").read_text()
    golden_id = lsam_id_table(open(CASCADE / "cascade.lsam.id"))
    recs1, recs2 = cascade_reads()
    for device_seeding in (True, False):
        path = "device" if device_seeding else "host"
        pipe = cascade_pipeline(dev, device_seeding)
        zero_counts()
        res = pipe.run_records(recs1, recs2)
        torch.cuda.synchronize()
        counts = read_counts()
        _require_launches("cascade", counts, ("dp_full", "mmp_seed", "locate")
                          if device_seeding else ("dp_full",))
        ours = lsam_id_table(r.to_line() for r in res.lsam_id)
        bad = [k for k in golden_id if golden_id[k] != ours.get(k)]
        if res.report != golden or set(ours) != set(golden_id) or bad:
            raise AssertionError(
                f"[cascade] {path} seeding: report equal {res.report == golden}, "
                f"{len(bad)} per-read records differ: {bad[:5]}")
        print(f"[cascade] {path} seeding on {dev}: report byte-identical to "
              f"cascade/cascade.report, {len(ours)} per-read records equal "
              f"cascade.lsam.id; launches {counts}")


def phase_pipeline_world(dev: torch.device, smi: str) -> None:
    """Every stage at 2 x 250 bp (bbduk with adapters, hg, ribo, two NT
    shards, mate rescue at W = 1152) against the JAX pipeline's records,
    on device seeding and on host seeding."""
    want = _pipeline_records()["world"]
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if pairs_digest(world["pairs"]) != want["input_sha256"]:
        raise AssertionError("[world] the workload's inputs differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    recs = fastq_records(world["pairs"])
    for device_seeding, key in ((True, "device_seeding"), (False, "host_seeding")):
        pipe = world_pipeline(world, dev, device_seeding)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.run_records(*recs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = read_counts()
        _require_launches("world", counts, ("dp_full", "mmp_seed", "locate")
                          if device_seeding else ("dp_full",))
        got = pipeline_record(res)
        bad = record_diff(got, want[key])
        if bad:
            raise AssertionError(f"[world] {key}: differs from the JAX pipeline's record: {bad}")
        print(f"[world] {key}: {len(recs[0])} pairs x 250 bp in {dt:.3f} s: report, "
              f"ra_report, both LSAM.id digests and the counters equal the JAX "
              f"pipeline's ({got['counters']}); launches {counts} [{smi}]")


def phase_pipeline_large(dev: torch.device, smi: str, large, n_timed: int = 3) -> dict:
    """The realistic run: the 512 Mbp shard as the human filter, the e2e
    community (22 species + 3 decoys x 400 kbp) as the NT shard, its
    50,000 pairs plus the large workload's 20,000 as human reads; bbduk
    on. Gates: the human filter keeps exactly the LARGE_HG_KEPT pairs;
    the reports and LSAM.id equal the JAX pipeline's over the community
    followed by those pairs, and every taxon row equals the JAX e2e
    reports'. 1 warm-up and ``n_timed`` timed ``run_records`` calls.
    Returns the warm-up's kernel launch counts."""
    import tempfile

    want = _pipeline_records()["e2e"]
    hg_ref, hg_fm, (reads1, lens1, reads2, lens2) = large
    t0 = time.perf_counter()
    genomes, pairs = e2e_workload()
    if pairs_digest(pairs) != want["input_sha256"]:
        raise AssertionError("[pipeline] the community's reads differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    nt_ref = pack_fasta(FastqRecord(name, _text(g)) for name, g in genomes)
    nt_fm = build_fm_index(nt_ref.codes, sa_interval=8, lut_k=8, device=dev)
    with tempfile.TemporaryDirectory() as d:
        write_e2e_taxonomy(Path(d), len(genomes))
        db = TaxDB(size=4096)
        db.read_nodes(Path(d) / "nodes.dmp")
        db.read_names(Path(d) / "names.dmp")
        db.read_acc2tid(Path(d) / "acc2tid.map")
    human = human_pairs(reads1, lens1, reads2, lens2)
    recs = fastq_records(pairs + human)
    n_in = len(recs[0])
    print(f"[pipeline] {len(pairs)} community pairs + {len(human)} human pairs, NT shard "
          f"{nt_ref.total_len} bp, hg shard {hg_ref.total_len} bp: ready in "
          f"{time.perf_counter() - t0:.1f} s")
    timer = StageTimer(out=open(os.devnull, "w"))
    cfg = PipelineConfig(read_len=100, device_seeding=True, max_read_len=100)
    pipe = MegaPathPipeline([(nt_ref, nt_fm)], db, hg_shard=(hg_ref, hg_fm),
                            config=cfg, device=dev, timer=timer)
    runs = []
    for i in range(1 + n_timed):
        timer.records.clear()
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.run_records(*recs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = read_counts()
        if i == 0:
            launches = counts
            _require_launches("pipeline", counts, ("dp_full", "mmp_seed", "locate"))
        check_e2e(res, want, recs, first=i == 0)
        split = timer.summary()
        split["other"] = dt - sum(split.values())
        runs.append(dt)
        print(f"[pipeline] {'warm-up' if i == 0 else f'run {i}'}: {dt:.3f} s = "
              f"{2 * n_in / dt:.0f} reads/s; " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in split.items())
              + f"; launches {counts}")
    med = statistics.median(runs[1:])
    print(f"[pipeline] median of {n_timed}: {2 * n_in / med:.0f} reads/s ({med:.3f} s a "
          f"run of {n_in} pairs); {res.n_after_human} pairs after the human filter: the "
          f"community's {want['counters']['n_after_preprocess']} and the human pairs "
          f"{want['hg_kept']}; report, ra_report and LSAM.id equal the JAX pipeline's on "
          f"that input, every taxon row equal to the JAX e2e reports' [{smi}]")
    return launches


def taxon_rows(report: str) -> list:
    """A Kraken report's rows without the percentage column and without
    the unclassified row: the classification's counts."""
    return [ln.split("\t", 1)[1] for ln in report.splitlines()[2:]]


def check_e2e(res, want: dict, recs, first: bool) -> None:
    """The large pipeline's gates; on a failure, prints what breaks them.
    ``want`` is the JAX e2e record: the community alone, and under
    ``with_hg_kept`` followed by the LARGE_HG_KEPT human pairs."""
    kept = want["with_hg_kept"]
    bad = [(k, *text_diff(getattr(res, k), kept[k])) for k in ("report", "ra_report")
           if getattr(res, k) != kept[k]]
    # the community's own classification: every taxon row equals the
    # JAX e2e run's (only the unclassified row and the percentages move)
    bad += [f"{k}: taxon rows differ from the JAX e2e run's" for k in ("report", "ra_report")
            if taxon_rows(getattr(res, k)) != taxon_rows(want[k])]
    n_hg = want["counters"]["n_after_preprocess"] + len(want["hg_kept"])
    if res.n_after_human != n_hg:
        bad.append(f"n_after_human {res.n_after_human} != {n_hg}")
    names = []
    if first or bad:
        names = [r.name for r in res.lsam_id][::2]
        if [n for n in names if n.startswith("hg")] != want["hg_kept"]:
            bad.append("the human pairs kept are not LARGE_HG_KEPT")
        if pipeline_record(res)["lsam_sha256"] != kept["lsam_sha256"]:
            bad.append("LSAM.id differs from the JAX record's")
    if not bad:
        return
    kept_hg = [n for n in names if n.startswith("hg")]
    lost = sorted({r.name for r in recs[0] if r.name.startswith("rd")} - set(names))
    print(f"[pipeline] gate failed; human pairs kept {len(kept_hg)} {kept_hg[:10]}, "
          f"community pairs lost {len(lost)} {lost[:10]}")
    raise AssertionError(f"[pipeline] the large pipeline differs from the JAX e2e run: {bad}")


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    toy = make_toy(dev)
    timing = kernels_dp(dev, smi)
    timing.update(kernels_seeding(dev, smi, toy))
    phase_golden(dev)
    launches = {"dp_fwd": phase_step(dev)}
    phase_slice(dev, smi, toy)
    large = phase_large(dev, smi)
    phase_pipeline_cascade(dev)
    phase_pipeline_world(dev, smi)
    counts = phase_pipeline_large(dev, smi, large)
    launches.update({k: counts[k] for k in ("dp_full", "mmp_seed", "locate")})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{k: timing[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
