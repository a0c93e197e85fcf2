#!/usr/bin/env python3
"""Drive the PyTorch port's alignment paths and its MegaPath pipeline once
on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the script
exits non-zero and prints no result line):

1. device   -- CUDA must be present; prints torch/CUDA versions and the
               card's name and power limit as nvidia-smi gives them.
2. build    -- compiles ``megapath_tpu_torch/csrc/*.cu`` (the kernels and
               the index build's CUB pair sort) with nvcc into
               ``build/kernels/`` (one nvcc per source, all at once) and
               prints the seconds it took and ptxas' register and spill
               counts (``locate_kernel`` must have a 0-byte stack frame);
               compiles the host C++ (``csrc/host/*.cpp``: bbduk,
               SPIKE and the FASTQ reader) with g++ into ``build/host/``;
               measures the card's dependent-load latency from L2 and
               from device memory (a pointer chase), the round trip each
               step of the locate's chain costs.
   The toy workload (4 x 2 Mbp, 20,000 pairs x 100 bp, made here as
   ``bench.py`` makes it, its FM index built on the card) is made next;
   phases 3 and 5 use it. Its FM index, that of a 1 Mbp tandem repeat
   (many doubling rounds) and that of phase 14's realistic contigs (the
   JAX record's, at the contig index's sa_interval 4) built on the card
   equal the ones built on the CPU (``torch.sort``), key by key.
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
               to, beside its chain floor (its longest chain of dependent
               loads at the L2 latency); ``sw_subst`` (the protein path's
               substitution-matrix DP) at a 10 kbp contig's blastx batch
               (3,072 x 3,334 x 320, timed beside its bound) and on the
               corners: lengths 0 and 1, R or W of 1, ties, codes past the
               table, another table, gap_open > gap_extend, odd B, W across
               every stripe and 512-row tile boundary and W = 5,000;
               ``sw_dna`` (the amplicon path's DNA DP, ``sw_align_dna``:
               the same kernel under ``dna_table(SSW_PARAMS)``) against the
               plain ``sw_align`` at the amplicon realign batch (6,912 x
               150 x 260, timed beside its bound) and on the corners:
               spans of 255-300 (``sw_align_auto``'s int16 kernel refuses
               them), W of 513-1,040, lengths 0 and 1, OFF_TEXT_CODE in
               windows, odd B, B = 1, and a code of 5 refused.
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
               full hit count printed beside the JAX engine's 40,044;
               ``locate`` against its plain version on the SA rows of
               20,480 read ends' seeds, timed beside its chain floor at the
               device-memory latency.
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
11. cli     -- the command line (``megapath_tpu_torch.cli.main``) on the
               card: the world's FASTAs through ``build-index`` and its
               gzip FASTQ through ``run -b`` on both seeding paths, the
               reports, LSAM.id files and BAM content equal to the JAX
               CLI's records (``tests/fixtures/torch_cli_records.json``);
               phase 7's 512 Mbp genome as FASTA through ``build-index``
               (split, pack, build, save times, peak card memory, file
               sizes); the realistic cell from files: the community
               through ``build-index``, its pairs and the human pairs as
               gzip FASTQ through ``run -L 100`` with both indexes loaded
               from disk (reports and LSAM.id equal the JAX CLI's record of
               the same NT input, taxon rows equal phase 10's), then ``run
               -b`` (the "bam" stage, the traceback's seconds, a sorted
               merged BAM with one primary line per read end with a hit).
12. shard   -- the 2.0 Gbp default shard (``index/shard.DEFAULT_SHARD_BP``)
               on the card: a random text drawn there, ``check_shard_fits``
               passes, ``build_fm_index`` (sa_interval 8, 8-mer table) with
               each stage's seconds and peak card memory, at most
               ``BUILD_BYTES_PER_CHAR`` a character; a lazy engine's first
               commit (``DeviceFM.from_host`` and the text) split into host
               packing and upload, its peak and the bytes it holds, then
               one evict -> commit round as the rotation makes it each
               batch (upload alone), and the rotation's cost a batch
               derived for 125 such shards; 2,048 exact 100 bp read ends
               planted at known positions through
               ``device_seed_pipeline_loc`` (walk and locate launched, each
               read end's positions hold its own); ``locate`` against its
               plain version on those rows, timed beside its chain floor.
               No file is written.
13. db      -- ``build-db`` on the card: the world's NT FASTA (less the
               taxon ``DB_EXCLUDE``, which filterDB drops), a small UniVec
               FASTA and the world's human FASTA, curated against the mini
               taxonomy of ``tests/fixtures`` and split at ``DB_SHARD_BP``
               into two shards whose indexes are built on the card (curate,
               split, pack, build and save seconds); every member of every
               shard file and the curated FASTA equal the JAX ``build-db``'s
               record; then the world's gzip FASTQ through ``run`` on those
               shards on device seeding (its seconds and launches), the
               reports and both LSAM.id files equal the JAX CLI's record
               (``tests/fixtures/torch_db_records.json``).
14. asm     -- the assembly stage, ``run -A`` (bbnorm and the multi-k
               assembler on the host, the contigs indexed at sa_interval 4
               and the reads aligned back on the card). The world part: the
               world's indexes by ``build-index``, its pairs plus a dense
               SARS-CoV-2 tiling through ``run -A`` on device and on host
               seeding. The realistic part: the world's 88 pairs plus
               9,000 pairs of two random viruses no index holds (29,903 bp
               at ~40x, 5,000 bp at ~300x; 2 x 150 bp, insert 400, 0.2%
               substitutions) through ``run`` and then ``run -A`` on the
               same prefix, so the second run is the assembly stage alone:
               its seconds split into extract, bbnorm, assemble, contig
               index and align back, the pairs bbnorm keeps, the contigs,
               N50, total length and each virus's recovery, and the contig
               engine's launches (the DP, the walk and the locate). Every
               contigs FASTA, r2c LSAM, report and LSAM.id equals the JAX
               CLI's record (``tests/fixtures/torch_asm_records.json``).
               The realistic ``run -A`` takes ``--protein-db`` with 300
               random proteins of 100-300 aa, four of them homologs of the
               viruses' frame translations: the protein remap's seeding,
               DP (its launches and batch shape), host tracebacks and tail
               timed, its three files equal to the JAX CLI's record
               (``tests/fixtures/torch_protein_records.json``).
15. protein -- the protein path (stage 4.1): the ac-diamond fixture
               (``tests/fixtures/protein``) through ``blastx_m8`` on the
               card, its m8 lines equal to the JAX record and passing
               ``tests/test_protein.py``'s golden checks; the world part
               (phase 14's world files, a protein DB of SARS-CoV-2 and
               HCoV-229E homologs and a decoy) through ``run -A
               --protein-db`` on device seeding, every output equal to the
               JAX CLI's record; ``run --protein-db`` without ``-A``
               writes exactly the files ``run`` writes.
16. amplicon -- the amplicon pipeline (``amplicon``): the world part
               (``tests/test_amplicon_pipeline.py``'s planted-truth world:
               6,000 bp TB, a human decoy and a taxon index through
               ``build-index``, 500 pairs through ``amplicon``; the VCF
               equals ``tests/fixtures/amplicon_planted.vcf``) and the
               realistic part (a 4,411,532 bp target with 16 amplicons of
               1,000 bp and 24 planted variants, a 32 Mbp decoy, 16,000 +
               2,000 pairs of 2 x 150 bp): the run's seconds split into
               bbduk, the decoy and target engines, the pileup and calling,
               ``realign_windows_batched`` (its batch and DP) and
               ``_hap_variants``, recall and false positives against the
               planted truth. Every VCF, ``.done`` and stderr line equals
               the JAX CLI's record (``tests/fixtures/
               torch_amplicon_records.json``); both runs launch dp_full and
               sw_subst.
17. rotation -- shard placement and wave rotation (``MegaPathPipeline(
               devices=)``, ``run --devices N``) on the one card: phase 9's
               world through ``devices=[cuda:0]`` (the two NT shards rotate
               in waves of one: peak NT residency 1, counted through
               ``commit``, none resident after) and ``devices=[cuda:0,
               cuda:0]`` (both resident, aligned from the pool), both equal
               to the JAX pipeline's record with equal launch counts;
               phase 13's build-db shards through ``run --devices 1``
               (== ``torch_db_records.json``); phase 10's community through
               ``build-index --shard-bp`` into 4 NT shards, its 50,000
               pairs and phase 7's 20,000 as gzip FASTQ through ``run
               --batch-size 20000 --devices 1`` (4 batches x 4 shards = 16
               commits) and ``run --batch-size 20000`` (resident): reports
               and LSAM.id files byte-equal, launch counts equal; the
               rotating run's per-batch split (commit, align, evict), its
               commits' host packing and upload, both runs' card peaks.
18. spmd    -- the one-program backend (``PipelineConfig(spmd=True)``,
               ``run --spmd``; ``parallel/spmd_full.py``) on the one card.
               (a), right after phase 7: its 512 Mbp shard and 20,000 pairs
               through a 1 x 1 grid under the pipeline's ladder, the hits
               equal to phase 7's device-seeding engine's and
               ``LARGE_JAX_HITS``; the step's and the backend's median of 3
               beside the engine's pass, the ladder level, the stage split
               by CUDA events, the synchronizing calls of one step
               (``torch.cuda.set_sync_debug_mode``), its launches, ``dp_fwd``
               at the step's deep-DP shape against its plain version and
               bound, the card peak, the payload and the bytes the shard
               holds on the card. (b) phase 9's world on a 2 x 2 grid of
               the card (``devices=[cuda:0] * 4``) == the JAX pipeline's
               record, each NT shard placed once. (c) phase 17's files and
               4 shards on a 2 x 4 grid (``devices=[cuda:0] * 8``) through
               ``run_files`` at batch 20,000, byte-equal to phase 17's
               resident run, each batch's level and seconds, the card peak.
               (d) ``run --spmd`` over one of those shards byte-equal to
               ``run``, and ``run --spmd`` over the 4 shards refused on one
               card before any index is read.
19. reduced -- the reduced one-program step (``parallel/spmd.py``) and the
               candidate-position step (``parallel/dist.py``) on the one
               card. (a), right after phase 18 (a): phase 7's 512 Mbp shard
               and 20,000 pairs through the reduced step on a 1 x 1 grid,
               on 18 (a)'s tables (a warm-up with its launches of the walk,
               the locate and ``dp_fwd``, then the median of 3); the first
               1,000 pairs' rows equal the same step on a CPU grid of those
               tables copied back (the plain walk, locate and DP); the
               pairs with a hit beside phase 7's engine's paired pairs;
               ``dp_fwd`` at the step's DP shape (80,000, 100, 150) beside
               its plain version and bound; then ``dist`` over the 20,000
               r1 reads at phase 7's hits (width 192), its first 4,096 rows
               equal a CPU grid's. (b) the small worlds
               (``tests/test_spmd.py``'s and ``tests/test_parallel.py``'s,
               with edge rows) on 2 x 2 grids of the card, every output
               field and ``spmd_report``'s bytes equal to the JAX record
               (``tests/fixtures/torch_spmd_records.json``).

Each pipeline phase zeroes the kernels' launch counts before its run and
fails unless its engines launched the DP (and, on device seeding, the
walk and the locate). The line before the last lists the kernels as JSON,
one entry for each TPU kernel the port replaces (``mp_dp_full`` serves
both layouts of the full DP, so ``dp_full_rows`` carries ``dp_full``'s
launches and times; ``sw_subst``'s launches are phases 14 and 15's,
``sw_dna``'s, the same kernel under the DNA table, phase 16's;
``dp_fwd``'s, phase 5's, 18's and 19's; ``mmp_seed``'s and ``locate``'s,
phase 10's and 19's); the
last line is ``{"ok": true, "device": {...}}``. The script imports torch, numpy and
``megapath_tpu_torch``, and nothing of jax or ``megapath_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
from megapath_tpu_torch.classify.protein import (  # noqa: E402
    AA,
    BLOSUM62,
    ProteinDB,
    blastx_m8,
    translate_frames,
)
from megapath_tpu_torch.index.fm import build_fm_index  # noqa: E402
from megapath_tpu_torch.index.pack import (  # noqa: E402
    PackedReference,
    encode_seq,
    pack_fasta,
    pack_fasta_file,
    pack_reads,
)
from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx, trim_readno  # noqa: E402
from megapath_tpu_torch import native  # noqa: E402
from megapath_tpu_torch.ops import _build, dp_cuda, protein_cuda, seed_cuda  # noqa: E402
from megapath_tpu_torch.parallel import spmd_full as sfull  # noqa: E402
from megapath_tpu_torch.ops.dp import (  # noqa: E402
    OFF_TEXT_CODE,
    PROTEIN_PARAMS,
    DPParams,
    sw_align,
    sw_align_full,
    sw_align_substmat,
)
from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline, PipelineConfig  # noqa: E402
from megapath_tpu_torch.pipeline.multik import genome_recovery, n50  # noqa: E402
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
    "dp_full_rows": ("megapath_tpu_torch/csrc/dp_full.cu",
                     "megapath_tpu/ops/dp_pallas.py:111"),
    "sw_subst": ("megapath_tpu_torch/csrc/sw_subst.cu",
                 "megapath_tpu/ops/dp.py:146"),
    "sw_dna": ("megapath_tpu_torch/csrc/sw_subst.cu",
               "megapath_tpu/ops/dp.py:49"),
}
# a TPU kernel whose contract another port kernel serves, with that
# kernel's launches and times: the row-major _dp_full_kernel has the
# transposed kernel's contract, and mp_dp_full serves both layouts
SERVED_BY = {"dp_full_rows": "dp_full"}
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
# the substitution DP's cell rate: the same lanes over the 8 int32
# lane-instructions a cell needs at least (F an add and an add-max, the
# table load, H without E an add-max-relu, H a max, E an add and an
# add-max, the running best a max). sw_dna's match/mismatch cells, whose
# scores int16 holds, are bounded at DP_CELLS_PER_S.
SUBST_CELLS_PER_S = 64 * 132 * 1.98e9 / 8
# what a rank reads of an occ row (4 checkpoints | 8 BWT words; the walk
# never loads the 4 mark words), and what a locate's mark test needs of it
OCC_ROW_BYTES = 48
MARK_WORDS_BYTES = 16
MARK_ROW_BYTES = 8  # one mark row: bitmap word, rank checkpoint
# the locate's dependent loads beyond its LF steps: the row index, the
# hit's occ row, its mark row and sa_sampled
CHAIN_EXTRA_LOADS = 4


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


def protein_batch(rng: np.random.Generator, C: int, R: int, W: int, hi: int = 20,
                  per_query: int = 64):
    """A blastx-shaped batch: queries of ``per_query`` candidates each share
    one frame (codes below ``hi``, stops and X among them, its length
    drawn from [R/2, R]); each candidate's window (length drawn from [W/4,
    W], the rest padded with X) holds random residues and, in every other
    candidate, a homolog of a stretch of the frame with ~10% substitutions,
    an insertion and a deletion."""
    reads = rng.integers(0, hi, (C, R)).astype(np.uint8)
    refs = np.full((C, W), 22, np.uint8)
    rl = np.zeros(C, np.int32)
    wl = rng.integers(max(W // 4, 1), W + 1, C).astype(np.int32)
    for q0 in range(0, C, per_query):
        n = int(rng.integers(max(R // 2, 1), R + 1))
        frame = rng.integers(0, hi, R).astype(np.uint8)
        frame[rng.random(R) < 0.03] = 23  # stops
        reads[q0 : q0 + per_query] = frame
        rl[q0 : q0 + per_query] = n
    for b in range(C):
        w = int(wl[b])
        refs[b, :w] = rng.integers(0, min(hi, 20), w)
        if b % 2 == 0 and w >= 24 and rl[b] >= 24:
            k = min(w - 6, int(rl[b]) - 6)
            at = int(rng.integers(0, int(rl[b]) - k + 1))
            homolog = reads[b, at : at + k].copy()
            sub = rng.random(k) < 0.1
            homolog[sub] = rng.integers(0, 20, int(sub.sum()))
            cut = k // 3
            homolog = np.concatenate([homolog[:cut], rng.integers(0, 20, 3).astype(np.uint8),
                                      homolog[cut : 2 * cut], homolog[2 * cut + 3 :]])
            refs[b, 3 : 3 + len(homolog)] = homolog[: w - 3]
    return reads, refs, rl, wl


def dna_batch(rng: np.random.Generator, B: int, R: int, W: int, span=(250, 300),
              off_text: bool = True):
    """B DNA reads of ``span`` bp (clamped to R) planted in windows of up
    to W rows (a few substitutions, at most one indel of 1-7 bp), random
    lengths; every fourth window from the second carries OFF_TEXT_CODE past
    its text (with ``off_text``), every 11th read from the fourth has
    length 0 and every 13th window from the sixth length 1. Returns numpy (reads u8 [B, R],
    refs u8 [B, W], read_lens i32 [B], ref_lens i32 [B])."""
    reads = np.zeros((B, R), np.uint8)
    refs = rng.integers(0, 4, (B, W)).astype(np.uint8)
    rl = rng.integers(min(span[0], R), min(span[1], R) + 1, B).astype(np.int32)
    wl = rng.integers(min(W, span[0]), W + 1, B).astype(np.int32)
    for b in range(B):
        read = rng.integers(0, 4, rl[b]).astype(np.uint8)
        reads[b, : rl[b]] = read
        seg = read.copy()
        for q in rng.integers(0, rl[b], rng.integers(0, 6)):
            seg[q] = (seg[q] + 1) % 4
        if rng.random() < 0.5 and rl[b] > 12:
            q = int(rng.integers(1, rl[b] - 10))
            n = int(rng.integers(1, 8))
            seg = (np.delete(seg, range(q, q + n)) if rng.random() < 0.5
                   else np.insert(seg, q, rng.integers(0, 4, n)))
        seg = seg[: wl[b]]
        at = int(rng.integers(0, wl[b] - len(seg) + 1))
        refs[b, at : at + len(seg)] = seg
        if off_text and b % 4 == 1:
            refs[b, wl[b]:] = OFF_TEXT_CODE
    rl[3::11], wl[5::13] = 0, 1
    return reads, refs, rl, wl


# the amplicon realign batch of phase 3: 24 windows x 96 reads x 3
# haplotypes, as realign_windows_batched lays out a panel's windows
AMP_DP_WINDOWS, AMP_DP_READS, AMP_DP_HAPS = 24, 96, 3


def amplicon_dp_batch(rng: np.random.Generator, R: int = 150, W: int = 260):
    """``realign_windows_batched``'s batch at full size: every window's 96
    reads (100-R bp) against each of its 3 haplotypes (100-W bp), padded
    with 0 as ``amplicon.realign._pad_batch`` pads; the reads of even index
    are true reads of a haplotype (0.5% substitutions), the others random.
    Rows run read-major, haplotype-minor. numpy (reads, refs, lens)."""
    rows_r, rows_h = [], []
    for _ in range(AMP_DP_WINDOWS):
        haps = [rng.integers(0, 4, int(rng.integers(100, W + 1))).astype(np.uint8)
                for _ in range(AMP_DP_HAPS)]
        for i in range(AMP_DP_READS):
            n = int(rng.integers(100, R + 1))
            h = haps[i % AMP_DP_HAPS]
            if i % 2 == 0 and len(h) >= n:
                at = int(rng.integers(0, len(h) - n + 1))
                read = h[at : at + n].copy()
                err = rng.random(n) < AMP_ERR
                read[err] = (read[err] + 1) % 4
            else:
                read = rng.integers(0, 4, n).astype(np.uint8)
            rows_r += [read] * AMP_DP_HAPS
            rows_h += haps
    B = len(rows_r)
    reads, refs = np.zeros((B, R), np.uint8), np.zeros((B, W), np.uint8)
    for b, (r, h) in enumerate(zip(rows_r, rows_h)):
        reads[b, : len(r)], refs[b, : len(h)] = r, h
    return (reads, refs, np.array([len(r) for r in rows_r], np.int32),
            np.array([len(h) for h in rows_h], np.int32))


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
    out and one sampled position, the mark words of every block a mark is
    tested in, the checkpoints and BWT words of every block an LF step
    ranks in, and every mark row it ranks a mark in (the plain locate's
    ``stats``)."""
    return (n_rows * 12 + stats["mark_words"] * MARK_WORDS_BYTES
            + stats["occ_rows"] * OCC_ROW_BYTES + stats["mark_rows"] * MARK_ROW_BYTES)


def chain_floor(stats: dict, latency_ns: float) -> tuple:
    """(dependent loads on the locate's longest chain, the least time
    they take in ms at ``latency_ns`` a round trip)."""
    loads = stats["longest"] + CHAIN_EXTRA_LOADS
    return loads, loads * latency_ns * 1e-6


def bound(cells: int, nbytes: int, cells_per_s: float = DP_CELLS_PER_S) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes at the memory rate
    and the DP cells at the cell rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = cells / cells_per_s * 1e3
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


def cascade_pipeline(dev: torch.device, device_seeding: bool,
                     devices=None) -> MegaPathPipeline:
    """The port's pipeline over the real-soap4 cascade fixture's two shards
    (``tests/test_cascade_parity.py``'s configuration), placed over
    ``devices`` when given."""
    def shard(path):
        ref = pack_fasta_file(path)
        return ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=dev)

    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True,
                         device_seeding=device_seeding)
    return MegaPathPipeline([shard(CASCADE / "shard0.fa"), shard(CASCADE / "shard1.fa")],
                            mini_taxdb(), config=cfg, devices=devices, device=dev)


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


def world_config(device_seeding: bool, spmd: bool = False) -> PipelineConfig:
    return PipelineConfig(read_len=250, max_read_len=250, device_seeding=device_seeding,
                          spmd=spmd)


def world_pipeline(world, dev: torch.device, device_seeding: bool,
                   devices=None, spmd: bool = False) -> MegaPathPipeline:
    """The port's pipeline over ``world_workload``'s shards: bbduk with the
    TruSeq table, the hg and ribo filters and two NT shards, placed over
    ``devices`` when given; with ``spmd``, the one-program backend over
    them."""
    def shard(seqs):
        ref = pack_fasta([FastqRecord(name, _text(codes), "", desc)
                          for name, desc, codes in seqs])
        return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=dev)

    return MegaPathPipeline(
        [shard(s) for s in world["nt"]], mini_taxdb(), hg_shard=shard(world["hg"]),
        adapters=build_kmer_ref([TRUSEQ], k=27, hdist=1),
        config=world_config(device_seeding, spmd), ribo_shard=shard(world["ribo"]),
        devices=devices, device=dev,
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
# the command line's files (phase 11; the CPU tests and
# tests/fixtures/make_torch_cli_records.py use them with either CLI)
# ----------------------------------------------------------------------
# the world's index flags (world_pipeline's sa_interval and lut_k); the NT
# FASTA splits into world_workload's two shards at 15,000 bp
WORLD_INDEX_ARGS = ("--sa-interval", "4", "--lut-k", "6")
WORLD_SHARD_BP = 15_000


def write_fasta(path: Path, entries) -> None:
    """(name, description, codes) entries as FASTA, one line a sequence."""
    with open(path, "w") as f:
        for name, desc, codes in entries:
            f.write(f">{name} {desc}\n" if desc else f">{name}\n")
            f.write(_text(codes))
            f.write("\n")


def write_fastq_pairs(pairs, p1: Path, p2: Path) -> None:
    """(name, seq1, qual1, seq2, qual2) pairs as two gzip FASTQ files,
    the names with /1 and /2."""
    with gzip.open(p1, "wt", compresslevel=1) as f1, gzip.open(p2, "wt", compresslevel=1) as f2:
        for name, s1, q1, s2, q2 in pairs:
            f1.write(f"@{name}/1\n{s1}\n+\n{q1}\n")
            f2.write(f"@{name}/2\n{s2}\n+\n{q2}\n")


def write_world_files(world, d: Path) -> None:
    """``world_workload``'s inputs as the CLI reads them, under ``d``: the
    NT, hg and ribo FASTAs, the TruSeq adapter FASTA and the pairs as
    gzip FASTQ; and the directories the indexes go to."""
    for k in ("nt", "hg", "ribo"):
        (d / k).mkdir(parents=True, exist_ok=True)
    write_fasta(d / "nt.fa", world["nt"][0] + world["nt"][1])
    write_fasta(d / "hg.fa", world["hg"])
    write_fasta(d / "ribo.fa", world["ribo"])
    (d / "adapters.fa").write_text(f">truseq\n{TRUSEQ}\n")
    write_fastq_pairs(world["pairs"], d / "r1.fq.gz", d / "r2.fq.gz")


def world_build_argvs(d: Path) -> list:
    """``build-index`` of the world's NT (two shards), hg and ribo
    references, each into its own directory under ``d``."""
    return [["build-index", str(d / f"{k}.fa"), str(d / k / k), *extra, *WORLD_INDEX_ARGS]
            for k, extra in (("nt", ("--shard-bp", str(WORLD_SHARD_BP))), ("hg", ()),
                             ("ribo", ()))]


def world_run_argv(d: Path, prefix: str, device_seeding: bool, bam: bool = True,
                   reads: Optional[Path] = None) -> list:
    """``run`` over the world's files and indexes (bbduk with the TruSeq
    table, the hg and ribo filters, two NT shards, 2 x 250 bp); the pairs
    are ``reads`` (default ``d``)'s ``r1.fq.gz`` and ``r2.fq.gz``."""
    reads = d if reads is None else reads
    return [
        "run", "-1", str(reads / "r1.fq.gz"), "-2", str(reads / "r2.fq.gz"), "-p", prefix,
        "--nt-index", str(d / "nt" / "shard0"), str(d / "nt" / "shard1"),
        "--hg-index", str(d / "hg" / "shard0"), "--ribo-index", str(d / "ribo" / "shard0"),
        "--adapters", str(d / "adapters.fa"), "--nodes", str(FIX / "nodes.dmp"),
        "--names", str(FIX / "names.dmp"), "--acc2tid", str(FIX / "acc2tid.map"),
        "-L", "250",
    ] + (["-b"] if bam else []) + ([] if device_seeding else ["--no-device-seeding"])


def bam_content(path) -> tuple:
    """(header text, SAM lines) of a BAM: what two BAMs are compared by
    (BGZF bytes depend on the zlib build)."""
    from megapath_tpu_torch.io.bam import read_bam

    with open(path, "rb") as f:
        return read_bam(f)


def cli_record(prefix: str, n_shards: int = 0) -> dict:
    """What the CLI gates compare (either package's ``run``): both reports,
    the sha256 of both LSAM.id files and, with ``n_shards``, of the merged
    and each shard's BAM content."""
    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    rec = {"report": Path(prefix + ".nt.report").read_text(),
           "ra_report": Path(prefix + ".nt.ra.report").read_text(),
           "lsam_sha256": sha(Path(prefix + ".nt.lsam.id").read_bytes()),
           "ra_lsam_sha256": sha(Path(prefix + ".nt.ra.lsam.id").read_bytes())}
    if n_shards:
        rec["bam_sha256"] = {}
        for suf in [".nt.bam"] + [f".nt.bam.{i}" for i in range(n_shards)]:
            header, lines = bam_content(prefix + suf)
            rec["bam_sha256"][suf] = sha("".join([header, *(l + "\n" for l in lines)]).encode())
    return rec


def write_e2e_files(d: Path, genomes, pairs) -> None:
    """The community as the CLI reads it, under ``d``: its FASTA, its
    taxonomy and the pairs as gzip FASTQ; and the index's directory."""
    (d / "nt").mkdir(parents=True, exist_ok=True)
    write_fasta(d / "community.fa", [(name, "", g) for name, g in genomes])
    write_e2e_taxonomy(d, len(genomes))
    write_fastq_pairs(pairs, d / "r1.fq.gz", d / "r2.fq.gz")


def e2e_run_argv(d: Path, prefix: str, hg_index=None) -> list:
    """``run`` of the realistic cell from files: the community as the NT
    shard, bbduk on with no adapters, device seeding, ``-L 100``."""
    argv = ["run", "-1", str(d / "r1.fq.gz"), "-2", str(d / "r2.fq.gz"), "-p", prefix,
            "--nt-index", str(d / "nt" / "shard0"), "--nodes", str(d / "nodes.dmp"),
            "--names", str(d / "names.dmp"), "--acc2tid", str(d / "acc2tid.map"),
            "-L", "100"]
    return argv + (["--hg-index", str(hg_index)] if hg_index else [])


# the community's index flags (phase 10's sa_interval and lut_k)
E2E_INDEX_ARGS = ("--sa-interval", "8", "--lut-k", "8")


# ----------------------------------------------------------------------
# build-db's files (phase 13; tests/test_torch_cli_db.py and
# tests/fixtures/make_torch_db_records.py use them with either CLI)
# ----------------------------------------------------------------------
# the curated world splits at 15,000 bp into two shards: E. coli and
# Salmonella; SARS-CoV-2, the UniVec segments and the human sequence
DB_SHARD_BP = 15_000
# filterDB drops the world's HCoV-229E genome by its species' name
DB_EXCLUDE = "Human coronavirus 229E"
DB_SHARDS = 2


def univec_entries(seed: int = 321) -> list:
    """A small UniVec FASTA's (name, description, codes): the TruSeq
    adapter with a random tail and a random vector segment, in UniVec's
    ``gnl|uv|ACC:range`` headers (accessions createDB keeps without a
    taxonomy row)."""
    rng = np.random.default_rng(seed)
    adapter = np.frombuffer(TRUSEQ.encode(), np.uint8)
    adapter = np.searchsorted(_ACGT, adapter).astype(np.uint8)
    tail = rng.integers(0, 4, 40).astype(np.uint8)
    return [("gnl|uv|UV000001.1:1-73", "TruSeq adapter", np.concatenate([adapter, tail])),
            ("gnl|uv|UV000002.1:1-200", "cloning vector segment",
             rng.integers(0, 4, 200).astype(np.uint8))]


def write_db_files(world, d: Path) -> None:
    """``build-db``'s inputs under ``d``: the world's raw NT FASTA (its two
    shards' genomes), a UniVec FASTA, the world's human FASTA, the TruSeq
    adapter FASTA and the pairs as gzip FASTQ; and the database's
    directory."""
    (d / "db").mkdir(parents=True, exist_ok=True)
    write_fasta(d / "nt.fa", world["nt"][0] + world["nt"][1])
    write_fasta(d / "univec.fa", univec_entries())
    write_fasta(d / "hg.fa", world["hg"])
    (d / "adapters.fa").write_text(f">truseq\n{TRUSEQ}\n")
    write_fastq_pairs(world["pairs"], d / "r1.fq.gz", d / "r2.fq.gz")


def db_build_argv(d: Path) -> list:
    """``build-db`` of ``write_db_files``' inputs against the mini
    taxonomy, the default sa_interval and lut_k, two shards."""
    return ["build-db", "--nt", str(d / "nt.fa"), "--univec", str(d / "univec.fa"),
            "--human", str(d / "hg.fa"), "--nodes", str(FIX / "nodes.dmp"),
            "--names", str(FIX / "names.dmp"), "--acc2tid", str(FIX / "acc2tid.map"),
            "--exclude-taxa", DB_EXCLUDE, "--out-prefix", str(d / "db" / "nt"),
            "--shard-bp", str(DB_SHARD_BP)]


def db_run_argv(d: Path, prefix: str) -> list:
    """``run`` of the world's pairs on build-db's shards: bbduk with the
    TruSeq table, no human index (the human sequence is in the database),
    device seeding, 2 x 250 bp."""
    return ["run", "-1", str(d / "r1.fq.gz"), "-2", str(d / "r2.fq.gz"), "-p", prefix,
            "--nt-index", *(str(d / "db" / f"shard{i}") for i in range(DB_SHARDS)),
            "--adapters", str(d / "adapters.fa"), "--nodes", str(FIX / "nodes.dmp"),
            "--names", str(FIX / "names.dmp"), "--acc2tid", str(FIX / "acc2tid.map"),
            "-L", "250"]


def npz_digest(path) -> dict:
    """{member: sha256 of its dtype, shape and contents} of an .npz file:
    what two index files are compared by."""
    out = {}
    with np.load(path, allow_pickle=True) as z:
        for k in sorted(z.files):
            a = z[k]
            body = repr(a.tolist()).encode() if a.dtype == object else a.tobytes()
            h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() + body)
            out[k] = h.hexdigest()
    return out


def db_records(main, extra=()) -> dict:
    """The db phase's inputs through ``main`` (either package's CLI, with
    ``extra`` appended to each argv): ``build-db`` and then ``run`` in a
    temporary directory; ``db_record`` beside the workload's digest."""
    import tempfile

    world = world_workload(WORLD_PAIRS_PER_KIND)
    out = {"workload": f"chip_smoke.world_workload({WORLD_PAIRS_PER_KIND}) through "
                       "write_db_files, build-db (db_build_argv) then run (db_run_argv)",
           "input_sha256": pairs_digest(world["pairs"])}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_db_files(world, d)
        for argv in (db_build_argv(d), db_run_argv(d, str(d / "run"))):
            if main([*argv, *extra]) != 0:
                raise AssertionError(f"[db] {argv[0]} exited non-zero")
        out.update(db_record(d, str(d / "run")))
    return out


def db_record(d: Path, prefix: str) -> dict:
    """What the build-db gates compare (either package's build-db and
    run): the curated FASTA's sha256, every shard file's members, and the
    run's ``cli_record``."""
    db = d / "db"
    return {
        "curated_sha256": hashlib.sha256((db / "nt.curated.fa").read_bytes()).hexdigest(),
        "shards": {f"shard{i}{suf}": npz_digest(db / f"shard{i}{suf}")
                   for i in range(DB_SHARDS) for suf in (".ref.npz", ".fm.npz")},
        "run": cli_record(prefix),
    }


# ----------------------------------------------------------------------
# the assembly stage's files (phase 14; tests/test_torch_cli_asm.py and
# tests/fixtures/make_torch_asm_records.py use them with either CLI)
# ----------------------------------------------------------------------
# start positions of the dense SARS-CoV-2 tiling added to the world's
# pairs (tests/test_pipeline.py:216-237's, at 2 x 250 bp, insert 600)
ASM_TILE = range(1000, 1600, 10)
# the realistic part: two "novel" viruses that no index holds, (name,
# genome length, pairs): SARS-CoV-2's length at ~40x, and 5 kbp at ~300x,
# deep enough that bbnorm's target of 70 tosses pairs
ASM_VIRUSES = (("novel_virus_A", 29_903, 4_000), ("novel_virus_B", 5_000, 5_000))
ASM_READ_LEN, ASM_INSERT, ASM_ERR, ASM_SEED = 150, 400, 0.002, 29


def asm_world_pairs(world) -> list:
    """The world's pairs plus a dense tiling of its SARS-CoV-2 genome
    (error-free, 2 x 250 bp, insert 600): viral pairs enough for the
    assembler to build a contig."""
    g = next(c for shard in world["nt"] for n, _, c in shard if n == "NC_045512.1")
    good = "I" * 250
    return list(world["pairs"]) + [
        (f"tile{i}", _text(g[p : p + 250]), good, _text(_COMP[g[p + 350 : p + 600][::-1]]), good)
        for i, p in enumerate(ASM_TILE)]


def asm_realistic_workload():
    """A sample's viral leftovers at the sizes the assembler gets from
    runMegaPath.sh:274-283: ``ASM_VIRUSES``' random genomes, 2 x
    ``ASM_READ_LEN`` bp pairs at insert ``ASM_INSERT`` from uniform
    positions, ``ASM_ERR`` substitutions a base, in a shuffled order.
    Returns ({name: genome text}, pairs as (name, seq1, qual1, seq2,
    qual2))."""
    rng = np.random.default_rng(ASM_SEED)
    L, ins = ASM_READ_LEN, ASM_INSERT
    genomes, pairs = {}, []
    for name, n, n_pairs in ASM_VIRUSES:
        g = rng.integers(0, 4, n).astype(np.uint8)
        genomes[name] = _text(g)
        for i, p in enumerate(rng.integers(0, n - ins + 1, n_pairs)):
            ends = [g[p : p + L].copy(), _COMP[g[p + ins - L : p + ins][::-1]]]
            for arr in ends:
                hit = np.flatnonzero(rng.random(L) < ASM_ERR)
                arr[hit] = (arr[hit] + rng.integers(1, 4, len(hit))) % 4
            pairs.append((f"{name}_{i}", _text(ends[0]), "I" * L, _text(ends[1]), "I" * L))
    return genomes, [pairs[i] for i in rng.permutation(len(pairs))]


def asm_run_argv(d: Path, prefix: str, device_seeding: bool, reads: Optional[Path] = None,
                 assembly: bool = True) -> list:
    """``run -A`` over the world's indexes (``world_run_argv`` without
    ``-b``) on ``reads``' pairs."""
    return world_run_argv(d, prefix, device_seeding, bam=False, reads=reads) + (
        ["-A"] if assembly else [])


def asm_record(prefix: str) -> dict:
    """What the assembly gates compare (either package's ``run -A``): the
    contigs' FASTA, the r2c LSAM's sha256 and line count, and the run's
    ``cli_record``."""
    r2c = Path(prefix + ".r2c.lsam").read_bytes()
    return {"contigs_fa": Path(prefix + ".contigs.fa").read_text(),
            "r2c_sha256": hashlib.sha256(r2c).hexdigest(), "r2c_lines": r2c.count(b"\n"),
            **cli_record(prefix)}


def asm_stats(contigs_fa: str, genomes: dict, extracted: int, kept: int) -> dict:
    """The assembly's measures: the pairs bbnorm got and kept, the
    contigs, their N50 and total length, each genome's recovery (the
    share of its 31-mers that the contigs hold on either strand)."""
    contigs = contigs_fa.splitlines()[1::2]
    return {"extracted_pairs": extracted, "kept_pairs": kept, "contigs": len(contigs),
            "n50": n50(contigs), "total_bp": sum(map(len, contigs)),
            "recovery": {name: genome_recovery(contigs, g) for name, g in genomes.items()}}


@contextlib.contextmanager
def _bbnorm_probe(assembly_module, seen: dict):
    """Record into ``seen`` the pairs ``normalize_pairs`` gets and keeps
    while ``assembly_module`` (either package's ``pipeline.assembly``)
    runs its assembly path."""
    fn = assembly_module.normalize_pairs

    def run(seqs1, *a, **k):
        keep = fn(seqs1, *a, **k)
        seen["extracted"] = seen.get("extracted", 0) + len(seqs1)
        seen["kept"] = seen.get("kept", 0) + int(np.sum(keep))
        return keep

    assembly_module.normalize_pairs = run
    try:
        yield
    finally:
        assembly_module.normalize_pairs = fn


def write_asm_files(world, d: Path) -> None:
    """The assembly phase's inputs under ``d``: the world's files with
    ``asm_world_pairs`` as its gzip FASTQ, and under ``d / "real"`` the
    realistic part's pairs (``asm_realistic_workload`` after the world's
    own pairs)."""
    write_world_files(world, d)
    write_fastq_pairs(asm_world_pairs(world), d / "r1.fq.gz", d / "r2.fq.gz")
    (d / "real").mkdir(exist_ok=True)
    _, pairs = asm_realistic_workload()
    write_fastq_pairs(list(world["pairs"]) + pairs, d / "real" / "r1.fq.gz",
                      d / "real" / "r2.fq.gz")


def asm_world_records(main, d: Path, extra=()) -> dict:
    """The world part through ``main`` (either package's CLI, ``extra``
    appended to each argv) in ``d``: ``build-index`` of the world, then
    ``run -A`` on device and on host seeding; ``asm_record`` of each."""
    out = {}
    for argv in world_build_argvs(d):
        if main([*argv, *extra]) != 0:
            raise AssertionError(f"[asm] {argv[0]} exited non-zero")
    for device_seeding, key in ((True, "device_seeding"), (False, "host_seeding")):
        if main([*asm_run_argv(d, str(d / key), device_seeding), *extra]) != 0:
            raise AssertionError("[asm] run -A exited non-zero")
        out[key] = asm_record(str(d / key))
    return out


def asm_realistic_record(main, assembly_module, d: Path, extra=(), protein: bool = False
                         ) -> dict:
    """The realistic part through ``main`` in ``d`` (the world's indexes
    built): ``run`` on device seeding, then ``run -A`` on the same prefix,
    which the journal reduces to the assembly stage; ``asm_record`` and
    ``asm_stats``. With ``protein``, the ``run -A`` takes ``--protein-db``
    with the realistic protein DB (``write_protein_files``) and the record
    gains ``protein_record``."""
    prefix = str(d / "real" / "run")
    seen: dict = {}
    for assembly in (False, True):
        with _bbnorm_probe(assembly_module, seen):
            argv = asm_run_argv(d, prefix, True, reads=d / "real", assembly=assembly)
            if assembly and protein:
                argv += ["--protein-db", str(d / "real" / "prot.fa")]
            if main([*argv, *extra]) != 0:
                raise AssertionError("[asm] realistic run exited non-zero")
    rec = asm_record(prefix)
    genomes, _ = asm_realistic_workload()
    rec["stats"] = asm_stats(rec["contigs_fa"], genomes, seen["extracted"], seen["kept"])
    return {**rec, **(protein_record(prefix) if protein else {})}


def asm_digests(world) -> dict:
    """The sha256 of the world part's and the realistic part's pairs."""
    return {"world_input_sha256": pairs_digest(asm_world_pairs(world)),
            "realistic_input_sha256": pairs_digest(asm_realistic_workload()[1])}


# ----------------------------------------------------------------------
# the protein path's files (phases 14 and 15; tests/test_torch_cli_protein.py
# and tests/fixtures/make_torch_protein_records.py use them with either CLI)
# ----------------------------------------------------------------------
AA20 = AA[:20]  # the standard residues
# the realistic protein DB: 300 proteins of 100-300 aa, four of them planted
# from the novel viruses' frame translations (tiles of 250 aa: aa start,
# frame), named by accessions of tests/fixtures/acc2tid.map
PROT_REAL_SEED = 31
PROT_REAL_DECOYS = 296
PROT_REAL_PLANTS = (("NC_045512", "novel_virus_A", 1000, 1),
                    ("NC_002645", "novel_virus_A", 6000, -2),
                    ("NC_0009130x1NC_003197", "novel_virus_B", 200, 3),
                    ("AE005174", "novel_virus_B", 900, -1))
PROT_PLANT_AA = 250
PROT_WORLD_SEED = 37
# the ac-diamond fixture of tests/test_protein.py
PROT_ACD = FIX / "protein"


def plant_protein(rng: np.random.Generator, codes: np.ndarray, start: int, frame: int,
                  n_aa: int, deletion: bool = True) -> str:
    """``n_aa`` residues of ``codes``' frame ``frame`` translation from aa
    ``start``, stops replaced by random standard residues, ~5% of the
    residues substituted and, with ``deletion``, 3 residues deleted from
    its middle half: a homolog the contigs' or reads' frame must find."""
    aa = np.array([AA[c] for c in dict(translate_frames(codes))[frame][start:start + n_aa]])
    fresh = lambda k: rng.choice(list(AA20), k)  # noqa: E731
    stop = aa == "*"
    aa[stop] = fresh(int(stop.sum()))
    hit = np.flatnonzero(rng.random(len(aa)) < 0.05)
    aa[hit] = fresh(len(hit))
    if deletion:
        at = int(rng.integers(len(aa) // 4, 3 * len(aa) // 4))
        aa = np.concatenate([aa[:at], aa[at + 3:]])
    return "".join(aa)


def random_protein(rng: np.random.Generator, n: int) -> str:
    return "".join(rng.choice(list(AA20), n))


def protein_realistic_db(genomes: dict) -> list:
    """The realistic part's protein FASTA as (name, residues): decoys of
    100-300 random standard residues and, among them, ``PROT_REAL_PLANTS``
    drawn from ``genomes`` (``asm_realistic_workload``'s)."""
    rng = np.random.default_rng(PROT_REAL_SEED)
    out = [(f"decoy{i:03d}", random_protein(rng, int(rng.integers(100, 301))))
           for i in range(PROT_REAL_DECOYS)]
    for k, (name, virus, start, frame) in enumerate(PROT_REAL_PLANTS):
        codes = encode_seq(genomes[virus])
        out.insert(37 + 73 * k, (name, plant_protein(rng, codes, start, frame, PROT_PLANT_AA)))
    return out


def protein_world_db(world) -> list:
    """The world part's protein FASTA as (name, residues): a 150 aa
    homolog of the SARS-CoV-2 region the tiling covers (``ASM_TILE``), a
    100 aa homolog of the HCoV-229E region its first pair's first read
    covers, and a random decoy whose name joins two accessions by 0x1."""
    rng = np.random.default_rng(PROT_WORLD_SEED)
    genome = {n: c for shard in world["nt"] for n, _, c in shard}
    sars, hcov = genome["NC_045512.1"], genome["NC_002645.1"]
    read = encode_seq(next(p[1] for p in world["pairs"] if p[0] == "NC_002645.1_0"))
    L = len(read)
    at = int(np.argmax([(hcov[p : p + L] == read).sum() for p in range(len(hcov) - L + 1)]))
    return [("NC_045512", plant_protein(rng, sars, ASM_TILE.start // 3 + 20, 1, 150)),
            ("NC_002645", plant_protein(rng, hcov, -(-at // 3), 1, 80, deletion=False)),
            ("NC_0009130x1NC_003197", random_protein(rng, 120))]


def write_protein_fasta(path: Path, db) -> None:
    with open(path, "w") as f:
        for name, seq in db:
            f.write(f">{name}\n{seq}\n")


def write_protein_files(world, d: Path) -> None:
    """The protein DBs under ``d`` (``write_asm_files``' directory): the
    world part's as ``prot.fa``, the realistic part's as ``real/prot.fa``."""
    write_protein_fasta(d / "prot.fa", protein_world_db(world))
    write_protein_fasta(d / "real" / "prot.fa",
                        protein_realistic_db(asm_realistic_workload()[0]))


PROTEIN_FILES = (".nr.lsam.id", ".nt.unmap.r2g.lsam.id", ".nr.report")


def protein_record(prefix: str) -> dict:
    """What the protein gates compare (either package's ``run -A
    --protein-db``): the NR LSAM.id and the NR report as text, the r2g
    LSAM.id's sha256 and line count."""
    r2g = Path(prefix + ".nt.unmap.r2g.lsam.id").read_bytes()
    return {"nr_lsam_id": Path(prefix + ".nr.lsam.id").read_text(),
            "r2g_sha256": hashlib.sha256(r2g).hexdigest(), "r2g_lines": r2g.count(b"\n"),
            "nr_report": Path(prefix + ".nr.report").read_text()}


def protein_world_argv(d: Path, prefix: str, assembly: bool = True) -> list:
    """``run -A --protein-db`` of the world part (``asm_run_argv`` on device
    seeding, the world protein DB); without ``assembly``, the same run
    without ``-A``."""
    return asm_run_argv(d, prefix, True, assembly=assembly) + ["--protein-db",
                                                                str(d / "prot.fa")]


def protein_world_record(main, d: Path, extra=()) -> dict:
    """The world part through ``main`` (either package's CLI) in ``d``
    (``write_asm_files`` and ``write_protein_files`` written, the world's
    indexes built): ``run -A --protein-db`` on device seeding;
    ``asm_record`` and ``protein_record`` of it."""
    prefix = str(d / "protein_world")
    if main([*protein_world_argv(d, prefix), *extra]) != 0:
        raise AssertionError("[protein] run -A --protein-db exited non-zero")
    return {**asm_record(prefix), **protein_record(prefix)}


def protein_digests(world) -> dict:
    """The sha256 of the protein DBs' FASTA text and of the ac-diamond
    fixture's files."""
    def sha(db) -> str:
        return hashlib.sha256("".join(f">{n}\n{s}\n" for n, s in db).encode()).hexdigest()

    return {"world_db_sha256": sha(protein_world_db(world)),
            "realistic_db_sha256": sha(protein_realistic_db(asm_realistic_workload()[0])),
            "acd_sha256": {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                           for p in sorted(PROT_ACD.glob("*"))}}


def read_fasta_pairs(path) -> list:
    """(first word of the name, sequence) of each record of a FASTA, as
    ``tests/test_protein.py`` reads the ac-diamond fixture."""
    out, name, seq = [], None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if name:
                out.append((name, "".join(seq)))
            name, seq = line[1:].split()[0], []
        else:
            seq.append(line)
    if name:
        out.append((name, "".join(seq)))
    return out


def acd_inputs():
    """The ac-diamond fixture: (protein DB entries, DNA queries as codes)."""
    prots = read_fasta_pairs(PROT_ACD / "prot.fa")
    contigs = read_fasta_pairs(PROT_ACD / "contigs.fa")
    return prots, [(n, encode_seq(s)) for n, s in contigs]


# ----------------------------------------------------------------------
# the amplicon pipeline's inputs (phase 16; tests/test_torch_cli_amplicon.py
# and tests/fixtures/make_torch_amplicon_records.py use them with either CLI)
# ----------------------------------------------------------------------
# the world part: tests/test_amplicon_pipeline.py's planted-truth world
# (6,000 bp TB and 6,000 bp human decoy from seed 77, the reads from seed
# 21), run with that test's final_as and min_depth
AMP_WORLD_ARGS = ("--final-as", "80", "--min-depth", "4")
# the realistic part: a TB amplicon panel at full width. H37Rv's length
# (NC_000962.3) as a random text (no genome is in the repo), 16 amplicons
# of 1,000 bp, 24 planted variants, 16,000 pairs of 2 x 150 bp inside the
# amplicons (~300x each), 0.5% substitutions, and 2,000 pairs of a 32 Mbp
# random human decoy shard (a human decoy is 3.1 Gbp)
AMP_SEED = 41
AMP_TARGET_NAME = "NC_000962.3"
AMP_TARGET_BP = 4_411_532
AMP_AMPLICONS = 16
AMP_AMPLICON_BP = 1000
AMP_VARIANTS = 24
AMP_PAIRS = 16_000
AMP_DECOY_BP = 32_000_000
AMP_DECOY_PAIRS = 2_000
AMP_READ_LEN = 150
AMP_FRAGMENT = (300, 500)
AMP_ERR = 0.005
# the offsets of an amplicon's first and second planted variant
AMP_VARIANT_AT = (330, 670)


def amp_world():
    """``tests/test_amplicon_pipeline.py``'s ``amp_world`` codes: (TB,
    human), 6,000 bp each from seed 77."""
    rng = np.random.default_rng(77)
    return (rng.integers(0, 4, 6000).astype(np.uint8),
            rng.integers(0, 4, 6000).astype(np.uint8))


def amp_planted_pairs(tb: np.ndarray) -> list:
    """The reads of ``test_variant_caller_planted_truth_recall_precision``
    (seed 21; its ``_pairs``: 2 x 100 bp, insert 300, no errors) as (name,
    seq1, qual1, seq2, qual2): 250 pairs of an allele with a hom SNP at
    1,000, a 3 bp deletion at 2,500 and a 2 bp insertion after 4,000, and
    250 of that allele with a het SNP at 4,800."""
    rng = np.random.default_rng(21)
    snp_hom, del_at, ins_at, snp_het = 1000, 2500, 4000, 4800
    codes = tb.copy()
    codes[snp_hom] = (codes[snp_hom] + 1) % 4
    ins = np.array([(codes[ins_at] + 2) % 4, (codes[ins_at + 1] + 2) % 4], np.uint8)
    allele_a = np.concatenate([codes[:del_at], codes[del_at + 3: ins_at + 1], ins,
                               codes[ins_at + 1:]])
    allele_b = allele_a.copy()
    allele_b[snp_het - 1] = (allele_b[snp_het - 1] + 1) % 4  # shifted by -3 + 2
    pairs = []
    for tag, src in (("a", allele_a), ("b", allele_b)):
        for i in range(250):
            p = int(rng.integers(0, len(src) - 300))
            pairs.append((f"{tag}{i}", _text(src[p: p + 100]), "I" * 100,
                          _text(_COMP[src[p + 200: p + 300][::-1]]), "I" * 100))
    return pairs


def write_amp_world_files(d: Path) -> None:
    """The world part's files under ``d``: ``tb.fa`` (TB), ``human.fa``
    (chr1), ``taxon.fa`` (both), the pairs as gzip FASTQ, and the
    directories of their indexes."""
    tb, human = amp_world()
    for k in ("tb", "human", "taxon"):
        (d / k).mkdir(parents=True, exist_ok=True)
    write_fasta(d / "tb.fa", [("TB", "", tb)])
    write_fasta(d / "human.fa", [("chr1", "", human)])
    write_fasta(d / "taxon.fa", [("TB", "", tb), ("chr1", "", human)])
    write_fastq_pairs(amp_planted_pairs(tb), d / "r1.fq.gz", d / "r2.fq.gz")


def amp_world_build_argvs(d: Path) -> list:
    """``build-index`` of the world part's three FASTAs (sa_interval 4)."""
    return [["build-index", str(d / f"{k}.fa"), str(d / k / k), *WORLD_INDEX_ARGS]
            for k in ("tb", "human", "taxon")]


def amp_world_argv(d: Path, prefix: str) -> list:
    """``amplicon`` of the world part: the TB target, the human decoy and
    the taxon index (loaded; the taxon filter runs only with target
    sequence ids, which the CLI never passes)."""
    return ["amplicon", "-1", str(d / "r1.fq.gz"), "-2", str(d / "r2.fq.gz"), "-p", prefix,
            "--target-index", str(d / "tb" / "shard0"),
            "--decoy-index", str(d / "human" / "shard0"),
            "--taxon-index", str(d / "taxon" / "shard0"), *AMP_WORLD_ARGS]


def _amp_reads(rng: np.random.Generator, src: np.ndarray, starts: np.ndarray,
               frags: np.ndarray) -> tuple:
    """2 x AMP_READ_LEN bp pairs of the fragments src[start : start + frag]
    (read 2 the reverse complement of the fragment's end), each base
    substituted with probability AMP_ERR: (codes1, codes2) uint8 [n, L]."""
    L = AMP_READ_LEN
    idx = np.arange(L)
    r1 = src[starts[:, None] + idx]
    r2 = _COMP[src[(starts + frags - 1)[:, None] - idx]]
    for r in (r1, r2):
        hit = rng.random(r.shape) < AMP_ERR
        r[hit] = (r[hit] + 1 + rng.integers(0, 3, int(hit.sum()))) % 4
    return r1, r2


def amp_realistic_workload() -> dict:
    """The realistic part, drawn from AMP_SEED: ``target`` and ``decoy``
    codes, the amplicons' starts, the planted ``truth`` as (0-based
    position, ref, alt, het) in VCF form (an indel anchored on the base
    before it), and ``pairs`` (name, seq1, qual1, seq2, qual2): the
    amplicon pairs (even ones from the allele with every variant, odd ones
    from the allele with the hom variants only) then the decoy pairs."""
    rng = np.random.default_rng(AMP_SEED)
    target = rng.integers(0, 4, AMP_TARGET_BP).astype(np.uint8)
    decoy = rng.integers(0, 4, AMP_DECOY_BP).astype(np.uint8)
    starts = np.linspace(60_000, AMP_TARGET_BP - 60_000 - AMP_AMPLICON_BP,
                         AMP_AMPLICONS).astype(np.int64)
    kinds = ["snp", "snp", "del", "ins"] * (AMP_VARIANTS // 4)
    specs = []  # (position, kind, size, het)
    for k in range(AMP_VARIANTS):
        pos = int(starts[k % AMP_AMPLICONS]) + AMP_VARIANT_AT[k // AMP_AMPLICONS]
        size = 1 if kinds[k] == "snp" else int(rng.integers(1, 11))
        specs.append((pos, kinds[k], size, (k // 4) % 2 == 1))
    truth = []
    for p, kind, size, het in specs:
        if kind == "snp":
            truth.append((p, _text(target[p: p + 1]), _text((target[p: p + 1] + 1) % 4), het))
        elif kind == "del":
            truth.append((p - 1, _text(target[p - 1: p + size]), _text(target[p - 1: p]), het))
        else:
            ins = (target[p] + 1 + np.arange(size)) % 4
            truth.append((p, _text(target[p: p + 1]), _text(target[p: p + 1]) + _text(ins),
                          het))

    def allele(amp: int, with_het: bool) -> np.ndarray:
        a0 = int(starts[amp])
        out = list(target[a0: a0 + AMP_AMPLICON_BP])
        for p, kind, size, het in sorted(specs, key=lambda s: -s[0]):
            if not a0 <= p < a0 + AMP_AMPLICON_BP or (het and not with_het):
                continue
            q = p - a0
            if kind == "snp":
                out[q] = (out[q] + 1) % 4
            elif kind == "del":
                del out[q: q + size]
            else:
                out[q + 1: q + 1] = list((target[p] + 1 + np.arange(size)) % 4)
        return np.array(out, np.uint8)

    pairs = []
    per_amp = AMP_PAIRS // AMP_AMPLICONS
    for amp in range(AMP_AMPLICONS):
        for h, src in enumerate((allele(amp, True), allele(amp, False))):
            n = per_amp // 2
            frags = rng.integers(*AMP_FRAGMENT, n, endpoint=True)
            frag_starts = (rng.random(n) * (len(src) - frags + 1)).astype(np.int64)
            r1, r2 = _amp_reads(rng, src, frag_starts, frags)
            pairs += [(f"amp{amp}_{2 * i + h}", _text(a), "I" * AMP_READ_LEN, _text(b),
                       "I" * AMP_READ_LEN) for i, (a, b) in enumerate(zip(r1, r2))]
    frags = rng.integers(*AMP_FRAGMENT, AMP_DECOY_PAIRS, endpoint=True)
    frag_starts = (rng.random(AMP_DECOY_PAIRS) * (AMP_DECOY_BP - frags + 1)).astype(np.int64)
    r1, r2 = _amp_reads(rng, decoy, frag_starts, frags)
    pairs += [(f"hum{i}", _text(a), "I" * AMP_READ_LEN, _text(b), "I" * AMP_READ_LEN)
              for i, (a, b) in enumerate(zip(r1, r2))]
    return {"target": target, "decoy": decoy, "starts": starts, "truth": truth,
            "pairs": pairs}


def write_amp_realistic_files(work: dict, d: Path) -> None:
    """The realistic part's files under ``d``: ``target.fa``
    (NC_000962.3), ``decoy.fa`` (a human shard), the pairs as gzip FASTQ,
    and the directories of their indexes."""
    for k in ("target", "decoy"):
        (d / k).mkdir(parents=True, exist_ok=True)
    write_fasta(d / "target.fa", [(AMP_TARGET_NAME, "random text of H37Rv's length",
                                   work["target"])])
    write_fasta(d / "decoy.fa", [("chr1_shard", "random human decoy shard", work["decoy"])])
    write_fastq_pairs(work["pairs"], d / "r1.fq.gz", d / "r2.fq.gz")


def amp_realistic_build_argvs(d: Path) -> list:
    """``build-index`` of the realistic target and decoy (the defaults)."""
    return [["build-index", str(d / f"{k}.fa"), str(d / k / k)] for k in ("target", "decoy")]


def amp_realistic_argv(d: Path, prefix: str) -> list:
    """``amplicon`` of the realistic part: the target and the decoy, the
    final alignment filter at 120 (80% of a 150 bp read, as the JAX tests
    take 80 for 100 bp reads: at the default 150 only an end without a
    sequencing error or a variant would pass)."""
    return ["amplicon", "-1", str(d / "r1.fq.gz"), "-2", str(d / "r2.fq.gz"), "-p", prefix,
            "--target-index", str(d / "target" / "shard0"),
            "--decoy-index", str(d / "decoy" / "shard0"), "--final-as", "120"]


def amp_record(prefix: str, stderr: str) -> dict:
    """What the amplicon gates compare (either package's ``amplicon``): the
    VCF's text, the ``.done`` marker and the ``[amplicon]`` stderr line."""
    return {"vcf": Path(prefix + ".vcf").read_text(),
            "done": Path(prefix + ".done").read_text(),
            "stderr": [l for l in stderr.splitlines() if l.startswith("[amplicon]")]}


def amp_digests(work: dict) -> dict:
    """sha256 of the world part's pairs and of the realistic part's
    (``work``, from ``amp_realistic_workload``): the records' inputs; a
    numpy generator that drifted changes them."""
    return {"world_input_sha256": pairs_digest(amp_planted_pairs(amp_world()[0])),
            "realistic_input_sha256": pairs_digest(work["pairs"])}


def amp_truth_score(vcf: str, truth: list, target: np.ndarray) -> dict:
    """Recall and false positives of a VCF's calls against the planted
    ``truth`` ((position, ref, alt, het)) on ``target``: a call matches a
    truth variant when both, applied to the target, give the same local
    haplotype (an indel may be called at a shifted but equivalent place), as
    ``tests/test_amplicon_pipeline.py``'s realistic-error test matches."""
    def local(v, w0, w1):
        p, ref, alt = v
        window = _text(target[w0:w1])
        return window[: p - w0] + alt + window[p - w0 + len(ref):]

    def same(a, b):
        if abs(a[0] - b[0]) > 15:
            return False
        w0 = max(0, min(a[0], b[0]) - 30)
        w1 = min(len(target), max(a[0] + len(a[1]), b[0] + len(b[1])) + 30)
        return local(a, w0, w1) == local(b, w0, w1)

    calls = [(int(c[1]) - 1, c[3], c[4]) for c in
             (line.split("\t") for line in vcf.splitlines() if line and line[0] != "#")]
    found = {i for i, t in enumerate(truth) if any(same(c, t[:3]) for c in calls)}
    false = [c for c in calls if not any(same(c, t[:3]) for t in truth)]
    return {"recall": len(found) / len(truth), "found": len(found), "truth": len(truth),
            "false_positives": len(false), "missing": [truth[i][:3] for i in
                                                       range(len(truth)) if i not in found]}


# ----------------------------------------------------------------------
# the reduced grid steps' small worlds (phase 19; tests/test_torch_spmd.py,
# tests/test_torch_dist.py and tests/fixtures/make_torch_spmd_records.py
# use them with either package)
# ----------------------------------------------------------------------
# tests/test_spmd.py's step parameters, species taxids and read length
SPMD_PARAMS = dict(insert_high=400, insert_low=50)
SPMD_TIDS = [694009, 562, 28901, 11137, 9606, 693996]
SPMD_L = 80
SPMD_SA_INTERVAL = 8
# the reference's mesh for the small worlds: 4 data rows (conftest's eight
# virtual devices); a batch is padded to a multiple of it
SPMD_JAX_ROWS = 4


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def small_spmd_world() -> dict:
    """``tests/test_spmd.py``'s world: 2 shards of 3 random 3,000 bp
    sequences (seed 11), species 0-5, shard 1 cut by 500 bp so that the
    pad path runs. The codes before padding."""
    rng = np.random.default_rng(11)
    S, M, seq_len = 2, 3, 3000
    codes, offsets, species = [], [], []
    for s in range(S):
        codes.append(np.concatenate([rng.integers(0, 4, seq_len).astype(np.uint8)
                                     for _ in range(M)]))
        offsets.append(np.arange(M + 1) * seq_len)
        species.append(np.arange(s * M, (s + 1) * M))
    codes[1] = codes[1][:-500]
    return {"codes": codes, "seq_offsets": np.stack(offsets).astype(np.int32),
            "seq_species": np.stack(species).astype(np.int32), "n_species": S * M}


def _pad_rows(reads1, reads2, lens, rows: int = SPMD_JAX_ROWS):
    """Zero pairs of length 0 up to a multiple of ``rows``."""
    pad = (-len(lens)) % rows
    z = np.zeros((pad, reads1.shape[1]), np.uint8)
    return (np.vstack([reads1, z]), np.vstack([reads2, z]),
            np.concatenate([lens, np.zeros(pad, np.int32)]))


def small_spmd_planted(world: dict, B: int = 16, insert: int = 200):
    """``tests/test_spmd.py``'s report batch: B planted proper pairs (seed
    3; pair b on shard b % 2, species cycling), 2 junk pairs (seed 13) and
    the pad rows. Returns (reads1, reads2, lens)."""
    rng = np.random.default_rng(3)
    L = SPMD_L
    reads1 = np.zeros((B, L), np.uint8)
    reads2 = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = b % 2
        text = world["codes"][s]
        offs = world["seq_offsets"][s]
        m = (b // 2) % (len(offs) - 1)
        p = int(rng.integers(int(offs[m]), int(offs[m + 1]) - insert))
        reads1[b] = text[p : p + L]
        reads2[b] = _revcomp(text[p + insert - L : p + insert])
    junk = np.random.default_rng(13)
    reads1 = np.vstack([reads1, junk.integers(0, 4, (2, L), np.uint8).astype(np.uint8)])
    reads2 = np.vstack([reads2, junk.integers(0, 4, (2, L), np.uint8).astype(np.uint8)])
    return _pad_rows(reads1, reads2, np.full(B + 2, L, np.int32))


# the edge pairs' right legs in shard 1: the number of leading bases
# mutated (a leg of L - k; 9 -> pair 151, one below the float32 threshold
# of a best of 160, 152 = int(float32(0.95) * float32(160)); 8 -> 152,
# kept) and an exact copy (a tie at 160, the lowest shard wins)
SPMD_EDGE_MUTATED = (9, 8, 0)


def _mutate(codes: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """``codes`` with its first k bases changed to another base."""
    out = codes.copy()
    out[:k] = (out[:k] + 1 + rng.integers(0, 3, k)) % 4
    return out


def small_spmd_edge(world: dict, insert: int = 200):
    """The world with three 200 bp fragments of shard 0 copied into shard
    1, each copy's right leg mutated at its first ``SPMD_EDGE_MUTATED[k]``
    bases, and the batch of the 8 random pairs of ``tests/test_spmd.py``
    (seed 9), the three fragments' exact pairs and the pad rows. Returns
    (world, (reads1, reads2, lens))."""
    rng = np.random.default_rng(17)
    L = SPMD_L
    codes = [c.copy() for c in world["codes"]]
    junk = np.random.default_rng(9)
    r1 = [junk.integers(0, 4, (8, L)).astype(np.uint8)]
    r2 = [junk.integers(0, 4, (8, L)).astype(np.uint8)]
    for k, n_mut in enumerate(SPMD_EDGE_MUTATED):
        p = 500 + 1000 * k + int(rng.integers(0, 300))
        q = 1000 + 2500 * k + int(rng.integers(0, 300))
        frag = codes[0][p : p + insert].copy()
        copy = frag.copy()
        copy[insert - L :] = _mutate(frag[insert - L :], n_mut, rng)
        codes[1][q : q + insert] = copy
        r1.append(frag[None, :L])
        r2.append(_revcomp(frag[insert - L :])[None])
    reads1, reads2 = np.vstack(r1), np.vstack(r2)
    return dict(world, codes=codes), _pad_rows(reads1, reads2, np.full(len(reads1), L, np.int32))


# the dist world's edge rows: a read with no hit, a tie across both shards,
# and a best of 60 (four leading bases mutated) against 56 (eight: one
# below the float32 threshold 57 = int(float32(0.95) * float32(60))) and
# against 57 (seven: kept); the leading bases each shard's copy mutates
DIST_EDGE_MUTATED = ((0, 0), (4, 8), (4, 7))


def _free_slots(busy: list, n: int, width: int, count: int) -> list:
    """``count`` starts x whose windows [x - 8, x - 8 + width) hold none of
    the ``busy`` reads [p, p + 64) and none of each other."""
    spans = [(p, p + 64) for p in busy]
    out, x = [], 8
    while len(out) < count:
        a, b = x - 8, x - 8 + width
        if b > n:
            raise ValueError("no room for the edge rows")
        clash = [e for lo, e in spans if lo < b and a < e]
        if clash:
            x = max(clash) + 8
            continue
        out.append(x)
        spans.append((a, b))
        x = b + 8
    return out


def small_dist_world() -> dict:
    """``tests/test_parallel.py``'s world on its 4 x 2 mesh (seed 3: 2
    shards of N 2,048, 4 sequences each, 11 species, 16 reads of 64 bp
    planted at their home shard, W 128), then four edge rows (seed 4,
    ``DIST_EDGE_MUTATED``) written into both shards clear of the planted
    reads. Returns the step's inputs and the planted reads' home shard."""
    S, D = 2, 4
    rng = np.random.default_rng(3)
    N, B, L, W, M = 2048, 4 * D, 64, 128, 4
    n_species = 11
    ref = rng.integers(0, 4, (S, N)).astype(np.uint8)
    bounds = np.linspace(0, N, M + 1).astype(np.int32)
    seq_offsets = np.tile(bounds, (S, 1))
    seq_species = rng.integers(0, n_species, (S, M)).astype(np.int32)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    cand = rng.integers(0, N - W, (B, S)).astype(np.int32)
    home = np.zeros(B, np.int32)
    busy = [[] for _ in range(S)]
    for b in range(B):
        s = (b * 7) % S
        home[b] = s
        seq = int(rng.integers(0, M))
        lo, hi = int(bounds[seq]), int(bounds[seq + 1])
        p = int(rng.integers(lo + 16, hi - L - 16))
        reads[b] = ref[s, p : p + L]
        cand[b, s] = p - 8
        busy[s].append(p)
    edge = np.random.default_rng(4)
    slots = [_free_slots(busy[s], N, W, len(DIST_EDGE_MUTATED)) for s in range(S)]
    e_reads = [edge.integers(0, 4, L).astype(np.uint8)]
    e_cand = [edge.integers(0, N - W, S).astype(np.int32)]
    for k, muts in enumerate(DIST_EDGE_MUTATED):
        read = edge.integers(0, 4, L).astype(np.uint8)
        for s, n_mut in enumerate(muts):
            ref[s, slots[s][k] : slots[s][k] + L] = _mutate(read, n_mut, edge)
        e_reads.append(read)
        e_cand.append(np.asarray([slots[s][k] - 8 for s in range(S)], np.int32))
    reads = np.vstack([reads, np.stack(e_reads)])
    return {"ref_shards": ref, "seq_offsets": seq_offsets, "seq_species": seq_species,
            "reads": reads, "read_lens": np.full(len(reads), L, np.int32),
            "cand_pos": np.vstack([cand, np.stack(e_cand)]), "home": home,
            "width": W, "n_species": n_species}


def small_worlds_digest() -> str:
    """sha256 of every array of the small worlds and their batches."""
    world = small_spmd_world()
    edge_world, edge_batch = small_spmd_edge(world)
    arrays = [*world["codes"], world["seq_offsets"], world["seq_species"],
              *small_spmd_planted(world), *edge_world["codes"], *edge_batch,
              *(v for v in small_dist_world().values() if isinstance(v, np.ndarray))]
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def out_record(out) -> dict:
    """An ``SpmdAlignOut`` or ``DistAlignOut`` of either package as lists."""
    return {k: np.asarray(v).tolist() for k, v in out._asdict().items()}


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
    libs = [native.build(name, force=True).name for name in ("bbduk", "spike", "fastq")]
    print(f"[build] g++ built the host libraries {', '.join(libs)} in "
          f"{time.perf_counter() - t:.1f} s")
    # ptxas -v: an entry function's mangled name (dp_wave_kernel<G, CH,
    # bwd> is "dp_wave_kernelILi<G>ELi<CH>ELb<bwd>EE"), then its stack
    # frame and register lines; CUB's sort kernels are not listed
    name, stack = "?", {}
    for ln in _build.LOG_PATH.read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z][a-z_]*_kernel)(I(?:L[a-z]\d+E)+E)?", ln)
            name = m and m.group(1) + (
                f"<{','.join(re.findall(r'L[a-z](\d+)E', m.group(2)))}>" if m.group(2) else "")
        elif name is None:
            continue
        elif "bytes stack frame" in ln:
            stack[name] = ln.strip()
        if name and ("registers" in ln or "spill stores" in ln and " 0 bytes spill" not in ln):
            print(f"[build] ptxas {name}: {ln.split('ptxas info    :')[-1].strip()}")
    frame = stack.get("locate_kernel", "no ptxas line")
    print(f"[build] ptxas locate_kernel: {frame}")
    if not frame.startswith("0 bytes stack frame"):
        raise AssertionError(f"[build] locate_kernel keeps a stack frame: {frame}")


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


_chase = None


def chase_lib():
    """The pointer-chase probe (``PROBE_SRC``), built with nvcc into
    ``build/probe/`` at first use: ``mp_chase(next, hops, out, stream)``."""
    global _chase
    if _chase is None:
        import ctypes

        d = HERE / "build" / "probe"
        d.mkdir(parents=True, exist_ok=True)
        src, lib_path = d / "chase.cu", d / "libchase.so"
        src.write_text(PROBE_SRC)
        subprocess.run([_build._nvcc(), *_build.ARCH, "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True)
        _chase = ctypes.CDLL(str(lib_path))
        _chase.mp_chase.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_void_p]
        _chase.mp_chase.restype = ctypes.c_int
    return _chase


def chase_table(dev: torch.device, nbytes: int) -> torch.Tensor:
    """One random cycle over ``nbytes`` of 64-byte-apart uint32 entries
    (int32 [nbytes / 4]) for ``mp_chase``."""
    n = nbytes // 64
    g = torch.Generator(device=dev).manual_seed(7)
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.zeros(n * 16, dtype=torch.int64, device=dev)
    nxt[perm * 16] = torch.roll(perm, -1) * 16  # one cycle over all entries
    return nxt.to(torch.int32)


def chase_ms(dev: torch.device, nxt: torch.Tensor, hops: int, reps: int = 10) -> float:
    """Median ms of one thread's ``hops`` dependent loads through ``nxt``
    (``_median_ms``; 0 hops: an empty launch timed the same way)."""
    lib = chase_lib()
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        if lib.mp_chase(nxt.data_ptr(), hops, out.data_ptr(), stream):
            raise RuntimeError("mp_chase launch failed")

    return _median_ms(run, reps=reps)


def load_latency(dev: torch.device, smi: str) -> dict:
    """ns a dependent load, one thread, through an 8 MB (L2) and a 4 GB
    (device memory) random cycle of 64-byte-apart entries: the round trip
    each step of a locate's chain costs. The 4 GB chase visits 2,000,000
    entries (128 MB of lines) a launch, more than the L2 holds, so the
    timed launches do not find the warm-up's lines. Returns {"L2": ns,
    "HBM": ns}."""
    out_ns = {}
    for key, name, nbytes, hops in (("L2", "8 MB (L2)", 8 << 20, 200_000),
                                    ("HBM", "4 GB (HBM)", 4 << 30, 2_000_000)):
        nxt = chase_table(dev, nbytes)
        out_ns[key] = 1e6 * chase_ms(dev, nxt, hops, reps=3) / hops
        print(f"[build] dependent load, {name}: {out_ns[key]:.1f} ns a hop "
              f"({hops} hops, median of 3) [{smi}]")
        del nxt
    torch.cuda.empty_cache()
    return out_ns


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
    if fields is None:  # one output tensor
        return {"out": int((got.long() - want.long()).abs().max()) if got.numel() else 0}
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


def subst_work(read_lens, ref_lens, R: int, W: int, n_codes: int) -> tuple:
    """(cells, bytes) the substitution DP must cover: the useful cells
    sum(read_len * ref_len) (lengths clamped to R and W), each input read
    once (the reads' and windows' codes up to their lengths, both lengths
    and the table) and each output written once (3 int32)."""
    rl = np.clip(np.asarray(read_lens, np.int64), 0, R)
    wl = np.clip(np.asarray(ref_lens, np.int64), 0, W)
    return int((rl * wl).sum()), int(rl.sum() + wl.sum()) + 20 * len(rl) + 4 * n_codes**2


def long_batch(rng: np.random.Generator, C: int, R: int, W: int):
    """A protein batch whose first 64 candidates share a long frame and
    whose others' queries are cut to 50 aa: a blastx batch padded to one
    long contig's frame."""
    batch = protein_batch(rng, C, R, W)
    batch[2][64:] = np.minimum(batch[2][64:], 50)
    return batch


def move_long(batch, where: str):
    """``batch`` (``long_batch``'s) with its 64 long candidates moved to
    the end ("last") or to every C / 64-th index ("interleaved")."""
    C = len(batch[2])
    if where == "last":
        return [np.roll(a, -64, axis=0) for a in batch]
    slots = np.arange(0, C, C // 64)[:64]
    src = np.empty(C, np.int64)  # the candidate each slot takes
    src[slots] = np.arange(64)
    src[np.setdiff1d(np.arange(C), slots)] = np.arange(64, C)
    return [a[src] for a in batch]


def full_windows(batch, W: int):
    """``batch`` with every window ``W`` rows long."""
    reads, refs, rl, wl = batch
    return reads, refs, rl, np.full_like(wl, W)


# the schedules every sw_subst case runs under: no candidate long (one
# warp each), every candidate long (a block each), and the wrapper's rule
SUBST_SCHEDULES = (("one warp each", None), ("all long", 0),
                   ("default", protein_cuda.LONG_FACTOR))


def kernels_subst(dev: torch.device, smi: str) -> dict:
    """sw_subst (``csrc/sw_subst.cu``) against the plain
    ``sw_align_substmat`` on the card, every output equal (tolerance 0),
    each case under three schedules (SUBST_SCHEDULES): at the main shape,
    a 10 kbp contig's 48 frames x 64 candidates, timed beside its bound;
    and on the contract's corners: zero and one lengths, R or W of 1, ties
    of both orders, codes >= n_codes, another table of fewer codes and gap
    costs with gap_open > gap_extend, an odd B, W across every stripe and
    tile boundary and one W of several thousand; and on the schedule's:
    long candidates last and interleaved with short ones, every candidate
    long, one long candidate, windows at each warp-stripe boundary of the
    long path (128 x rows a lane, +-1) and a wide one, B below the
    persistent grid, and two launches back to back (the item counter
    starts over). Prints what a launch gets: registers, shared memory,
    resident blocks."""
    rng = np.random.default_rng(20261017)
    lib = _build.load()
    if lib.mp_sw_subst_tile_rows() != protein_cuda.TILE_ROWS:
        raise AssertionError(f"[kernels] the library's tile is {lib.mp_sw_subst_tile_rows()} "
                             f"rows, protein_cuda.TILE_ROWS is {protein_cuda.TILE_ROWS}")
    occ = protein_cuda.occupancy(dev)
    resident_warps = occ["blocks_per_sm"] * occ["sms"] * occ["warps"]
    print(f"[kernels] sw_subst launch: {occ['registers']} registers a thread, "
          f"{occ['local_bytes']} bytes of local memory, {occ['shared_bytes']} bytes of shared "
          f"memory a block of {occ['warps']} warps, {occ['blocks_per_sm']} resident blocks an "
          f"SM x {occ['sms']} SMs = {resident_warps} warps [{smi}]")
    if occ["local_bytes"]:
        raise AssertionError(f"[kernels] sw_subst spills: {occ['local_bytes']} bytes a thread")
    blosum = torch.from_numpy(BLOSUM62).to(dev)
    other = np.random.default_rng(3).integers(-6, 7, (7, 7)).astype(np.int32)
    other = torch.from_numpy((other + other.T) // 2).to(dev)
    prot = PROTEIN_PARAMS
    lens01 = protein_batch(rng, 64, 96, 120)
    lens01[2][0::4], lens01[2][1::4] = 0, 1  # read lengths 0 and 1
    lens01[3][2::8], lens01[3][3::8] = 0, 1  # window lengths 0 and 1
    cases = [
        ("main", protein_batch(rng, 3072, 3334, 320), blosum, prot),
        ("lens_0_1", lens01, blosum, prot),
        ("edges", edge_batch(rng, 40, 96, C=32), blosum, prot),
        ("r1", protein_batch(rng, 64, 1, 96), blosum, prot),
        ("w1", protein_batch(rng, 64, 96, 1), blosum, prot),
        ("ties", tie_batch(rng, 120, 200), blosum, prot),
        ("codes_past_24", protein_batch(rng, 128, 150, 200, hi=256), blosum, prot),
        ("other_table", protein_batch(rng, 128, 150, 200, hi=9), other, prot),
        ("go_above_ge", protein_batch(rng, 128, 150, 200), blosum, DPParams(0, 0, -1, -3)),
        ("odd_b", protein_batch(rng, 1001, 300, 250), blosum, prot),
        ("b1", protein_batch(rng, 1, 300, 250), blosum, prot),
    ] + [(f"w{w}", protein_batch(rng, 96, 120, w), blosum, prot)
         for w in (31, 32, 33, 64, 65, 511, 512, 513, 1024, 1025, 1537)] + [
        ("w5000", protein_batch(rng, 64, 300, 5000, per_query=8), blosum, prot),
        ("long_last", move_long(long_batch(rng, 1024, 2000, 300), "last"), blosum, prot),
        ("long_interleaved", move_long(long_batch(rng, 1024, 2000, 300), "interleaved"),
         blosum, prot),
        ("all_long", full_windows(protein_batch(rng, 64, 600, 400), 400), blosum, prot),
        ("one_long", full_windows(protein_batch(rng, 1, 2500, 700), 700), blosum, prot),
    ] + [(f"stripe_w{w}", full_windows(protein_batch(rng, 32, 200, w), w), blosum, prot)
         for p in (1, 2, 3, protein_cuda.TILE_ROWS // 32)
         for w in (128 * p - 1, 128 * p, 128 * p + 1)] + [
        ("wide_long", full_windows(protein_batch(rng, 8, 400, 6000, per_query=4), 6000),
         blosum, prot),
        ("b_below_grid", protein_batch(rng, 5, 300, 250), blosum, prot),
    ]
    out = {"max_abs_err": 0, "library_ms": None}
    for tag, batch, subst, params in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in batch]
        want = sw_align_substmat(*t, subst, params)
        C, R = batch[0].shape
        W = batch[1].shape[1]
        n_long = []
        for name, factor in SUBST_SCHEDULES:
            got = protein_cuda.sw_align_substmat_cuda(*t, subst, params, factor)
            out["max_abs_err"] = max(out["max_abs_err"], _hold(
                f"sw_subst {tag} ({name})", got, want, FWD_FIELDS))
            n_long.append(int(protein_cuda.schedule(t[2], t[3], R, W, resident_warps,
                                                    factor)[1][1]))
        line = (f"[kernels] sw_subst {tag} B={C} R={R} W={W} n_codes={subst.shape[0]} "
                f"go={params.gap_open} ge={params.gap_extend}: 3/3 outputs equal (tolerance 0) "
                f"with {' / '.join(map(str, n_long))} long candidates")
        if tag == "main":
            ms = _median_ms(lambda: protein_cuda.sw_align_substmat_cuda(*t, subst, params))
            plain_ms = _median_ms(lambda: sw_align_substmat(*t, subst, params), reps=3)
            cells, nbytes = subst_work(batch[2], batch[3], R, W, subst.shape[0])
            bound_ms, by = bound(cells, nbytes, SUBST_CELLS_PER_S)
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
            line += (f"; median: kernel {ms:.4f} ms (of 10), plain {plain_ms:.4f} ms (of 3); "
                     f"{cells} useful cells of {C * R * W} padded, {_share(ms, bound_ms)} "
                     f"({by}) [{smi}]")
        if tag == "long_last":
            # two launches back to back, nothing synchronised between them
            first = protein_cuda.sw_align_substmat_cuda(*t, subst, params)
            second = protein_cuda.sw_align_substmat_cuda(*t, subst, params)
            for k, got in enumerate((first, second)):
                _hold(f"sw_subst {tag}, launch {k + 1} of 2 back to back", got, want, FWD_FIELDS)
            line += "; two launches back to back equal it too"
        print(line)
    try:
        protein_cuda.sw_align_substmat_cuda(*t, torch.zeros((33, 33), dtype=torch.int32,
                                                            device=dev), prot)
    except ValueError as e:
        print(f"[kernels] sw_subst refuses a table of 33 codes: {e}")
    else:
        raise AssertionError("[kernels] sw_subst took a table of 33 codes")
    return {"sw_subst": out}


def kernels_dna(dev: torch.device, smi: str) -> dict:
    """sw_dna: ``sw_align_dna`` on the card (``csrc/sw_subst.cu`` under
    ``dna_table(SSW_PARAMS)``) against the plain ``sw_align``, every output
    equal (tolerance 0), each case through ``sw_align_dna`` and under the
    three schedules of SUBST_SCHEDULES: at the amplicon realign batch
    (``amplicon_dp_batch``, 6,912 x 150 x 260), timed beside its bound and
    the plain version; and on the corners: spans of 255-300 (best scores
    past 1,023, which ``sw_align_auto``'s int16 kernel refuses), windows of
    513-1,040 rows (across the 512-row tile), lengths 0 and 1,
    OFF_TEXT_CODE in windows, an odd B and B = 1; a code of 5 raises, in
    ``sw_align_dna``'s check of the tensors and in ``dna_dp``'s of its host
    arrays. The bound counts the useful cells at DP_CELLS_PER_S."""
    from megapath_tpu_torch.amplicon.realign import SSW_PARAMS, dna_dp
    from megapath_tpu_torch.ops.dp import dna_table, sw_align_auto, sw_align_dna

    rng = np.random.default_rng(20261018)
    table = dna_table(SSW_PARAMS).to(dev)
    lens01 = dna_batch(rng, 64, 150, 260, span=(100, 150))
    lens01[2][0::4], lens01[2][1::4] = 0, 1
    lens01[3][2::8], lens01[3][3::8] = 0, 1
    cases = [
        ("main", amplicon_dp_batch(rng)),
        ("spans_255_300", dna_batch(rng, 256, 300, 300, span=(255, 300))),
        ("w_513_1040", dna_batch(rng, 192, 150, 1040, span=(100, 150))),
        ("lens_0_1", lens01),
        ("off_text", dna_batch(rng, 128, 150, 260, span=(100, 150))),
        ("odd_b", dna_batch(rng, 999, 150, 260, span=(100, 150))),
        ("b1", dna_batch(rng, 1, 260, 260, span=(200, 260))),
    ]
    cases[2][1][3][:] = rng.integers(513, 1041, 192)  # every window across the tile
    out = {"max_abs_err": 0, "library_ms": None}
    for tag, batch in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in batch]
        want = sw_align(*t, SSW_PARAMS)
        got = sw_align_dna(*t, SSW_PARAMS)
        out["max_abs_err"] = max(out["max_abs_err"], _hold(f"sw_dna {tag}", got, want,
                                                           FWD_FIELDS))
        for name, factor in SUBST_SCHEDULES:
            got = protein_cuda.sw_align_substmat_cuda(*t, table, SSW_PARAMS, factor)
            out["max_abs_err"] = max(out["max_abs_err"], _hold(
                f"sw_dna {tag} ({name})", got, want, FWD_FIELDS))
        C, R = batch[0].shape
        W = batch[1].shape[1]
        line = (f"[kernels] sw_dna {tag} B={C} R={R} W={W}: 3/3 outputs equal (tolerance 0) "
                f"through sw_align_dna and under {len(SUBST_SCHEDULES)} schedules, best score "
                f"{int(want.score.max())}")
        if tag == "spans_255_300":
            try:
                sw_align_auto(*t, SSW_PARAMS)
            except ValueError as e:
                line += f"; sw_align_auto refuses it ({e})"
            else:
                raise AssertionError("[kernels] sw_align_auto took spans past the int16 range")
        if tag == "main":
            # sw_align_dna as the path calls it (amplicon.realign.dna_dp):
            # the largest code read on the host, the table cached on the card
            top = int(max(batch[0].max(), batch[1].max()))
            ms = _median_ms(lambda: sw_align_dna(*t, SSW_PARAMS, max_code=top))
            plain_ms = _median_ms(lambda: sw_align(*t, SSW_PARAMS), reps=3)
            cells, nbytes = subst_work(batch[2], batch[3], R, W, table.shape[0])
            # the match/mismatch recurrence at the DP's rate: this path's
            # scores stay within match x max_read_len (4 x 512), which int16
            # holds, so the card could run it in DPX 16x2 form whatever
            # type the kernel computes in
            bound_ms, by = bound(cells, nbytes, DP_CELLS_PER_S)
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
            line += (f"; median: sw_align_dna {ms:.4f} ms (of 10), plain {plain_ms:.4f} ms (of "
                     f"3); {cells} useful cells of {C * R * W} padded, {_share(ms, bound_ms)} "
                     f"({by}) [{smi}]")
        print(line)
    bad = torch.from_numpy(np.ascontiguousarray(cases[0][1][1][:4])).to(dev)
    bad[1, 7] = OFF_TEXT_CODE + 1
    t = [torch.from_numpy(np.ascontiguousarray(a[:4])).to(dev) for a in cases[0][1]]
    try:
        sw_align_dna(t[0], bad, t[2], t[3], SSW_PARAMS)
    except ValueError as e:
        print(f"[kernels] sw_dna refuses a window code of {OFF_TEXT_CODE + 1}: {e}")
    else:
        raise AssertionError(f"[kernels] sw_align_dna took a code of {OFF_TEXT_CODE + 1}")
    reads4, _, read_lens4, ref_lens4 = (a[:4] for a in cases[0][1])
    try:  # the check on the host arrays, as the amplicon path calls it
        dna_dp(reads4, bad.cpu().numpy(), read_lens4, ref_lens4, SSW_PARAMS, device=dev)
    except ValueError as e:
        print(f"[kernels] dna_dp refuses a window code of {OFF_TEXT_CODE + 1}: {e}")
    else:
        raise AssertionError(f"[kernels] dna_dp took a code of {OFF_TEXT_CODE + 1}")
    return {"sw_dna": out}


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


def kernels_seeding(dev: torch.device, smi: str, toy, lat: dict) -> dict:
    """mmp_seed and locate against their plain versions: the walk on 2 x
    4,096 read ends of the toy workload (the engine's walker layout) under
    the default and the exact dials, the exact rescue's shape (1,024
    walkers, exact dials), an odd walker count, and 250 bp and 1,023 bp
    walkers; the locate on every SA row the default walk's seeds expand
    to (``check_locate``, its chain at the L2 latency of ``lat``). The
    walk's time is also given per iteration of its longest walker."""
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
    out["locate"] = check_locate("kernels", dfm, rows, lat["L2"], "L2", smi)
    return out


def check_locate(tag: str, dfm, rows: torch.Tensor, latency_ns: float, level: str,
                 smi: str) -> dict:
    """The locate kernel against its plain version on ``rows`` (equal at
    tolerance 0, every row resolved), both timed, beside its bytes bound
    and its chain floor at ``latency_ns`` a dependent load. Returns the
    kernels line's entry."""
    got = seed_cuda.locate_cuda(dfm, rows)
    stats = {}
    want = seeding_dev.locate_device_plain(dfm, rows, stats=stats)
    err = _hold(f"locate {tag}", got, want, None)
    if bool((got < 0).any()):
        raise AssertionError(f"[{tag}] locate: unresolved rows")
    ms = _median_ms(lambda: seed_cuda.locate_cuda(dfm, rows))
    plain_ms = _median_ms(lambda: seeding_dev.locate_device_plain(dfm, rows))
    bound_ms, by = bound(0, locate_bytes(len(rows), stats))
    loads, floor_ms = chain_floor(stats, latency_ns)
    print(f"[{tag}] locate: {len(rows)} SA rows, positions equal (tolerance 0); median "
          f"of 10: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {stats['lf_steps']} LF "
          f"steps, {_share(ms, bound_ms)} ({by}); chain floor {floor_ms:.4f} ms "
          f"({loads} dependent loads x {latency_ns:.1f} ns, {level}), "
          f"{100 * floor_ms / ms:.1f}% of it [{smi}]")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None, "chain_floor_ms": floor_ms}


def repeat_text(n: int = 1_000_000, period: int = 1000, seed: int = 5) -> np.ndarray:
    """A tandem repeat of a random ``period``-long unit with one
    substitution every ~100 kbp: suffixes share prefixes of up to ~100
    kbp, so prefix doubling takes ~14 rounds."""
    rng = np.random.default_rng(seed)
    t = np.resize(rng.integers(0, 4, period).astype(np.uint8), n)
    q = rng.integers(0, n, max(1, n // 100_000))
    t[q] = (t[q] + 1) % 4
    return t


def fm_diff(got, want) -> list:
    """The FMIndex fields where ``got`` and ``want`` differ, dtypes
    included."""
    bad = []
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            if not isinstance(a, np.ndarray) or a.dtype != b.dtype or not np.array_equal(a, b):
                bad.append(f.name)
        elif a != b:
            bad.append(f.name)
    return bad


def contig_text() -> np.ndarray:
    """The realistic assembly's contigs (the JAX record of phase 14)
    packed as ``assembly_path`` packs them before it indexes them."""
    fa = _asm_records()["realistic"]["contigs_fa"].splitlines()
    return pack_fasta([FastqRecord(n[1:], c) for n, c in zip(fa[::2], fa[1::2])]).codes


def phase_index(dev: torch.device, toy) -> None:
    """The FM index built on the card (CUB's pair sort) equals the one
    built on the CPU (torch.sort), key by key with dtypes: the toy's text,
    a 1 Mbp tandem repeat, and the realistic assembly's contigs at the
    contig index's sa_interval 4."""
    from megapath_tpu_torch.ops import sort_cuda

    ref, toy_fm = toy[0], toy[1]
    for tag, codes, card_fm, sa_interval in (
            ("toy", ref.codes, toy_fm, 8), ("1 Mbp tandem repeat", repeat_text(), None, 8),
            ("assembly contigs", contig_text(), None, 4)):
        rounds = ""
        if card_fm is None:
            stages = {}
            sort_cuda.sort_launches = 0
            card_fm = build_fm_index(codes, sa_interval=sa_interval, lut_k=8, device=dev,
                                     stages=stages)
            n_rounds = sum(k.startswith("sort round") for k in stages)
            if sort_cuda.sort_launches != n_rounds:
                raise AssertionError(f"[index] {tag}: {sort_cuda.sort_launches} CUB sorts for "
                                     f"{n_rounds} doubling rounds")
            rounds = f", {n_rounds} doubling rounds ({sort_cuda.sort_launches} CUB sorts)"
        t = time.perf_counter()
        cpu_fm = build_fm_index(codes, sa_interval=sa_interval, lut_k=8,
                                device=torch.device("cpu"))
        cpu_s = time.perf_counter() - t
        bad = fm_diff(card_fm, cpu_fm)
        if bad:
            raise AssertionError(f"[index] {tag}: the card's FM index differs from the CPU's in {bad}")
        print(f"[index] {tag} ({len(codes)} bp, sa_interval {sa_interval}{rounds}): the FM "
              f"index built on the card equals the CPU's key by key, dtypes included (CPU "
              f"build {cpu_s:.1f} s)")


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
    protein_cuda.launches = 0


def read_counts() -> dict:
    return {
        "dp_full": dp_cuda.launches, "dp_fwd": dp_cuda.fwd_launches,
        "mmp_seed": seed_cuda.walk_launches, "locate": seed_cuda.locate_launches,
        "sw_subst": protein_cuda.launches,
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


def phase_large(dev: torch.device, smi: str, lat: dict):
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
    hits, counts, engine_s = _timed_passes(engine, batch, 3, smi, "large")
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
    check_locate("large", engine.dfm, seed_rows(engine.dfm, batch, 10240), lat["HBM"],
                 "HBM", smi)
    return (ref, fm, batch), hits, engine_s


def seed_rows(dfm, batch, n: int) -> torch.Tensor:
    """Every SA row the default walk's seeds of the first ``n`` pairs'
    read ends expand to (the engine's walker layout), on the card."""
    reads1, lens1, reads2, lens2 = batch
    dev = dfm.rows.device
    walkers, wlens = seeding_dev.build_walkers(
        torch.from_numpy(np.concatenate([reads1[:n], reads2[:n]])).to(dev),
        torch.from_numpy(np.concatenate([lens1[:n], lens2[:n]])).to(dev))
    L = walkers.shape[1]
    chg = 3 * L + 64
    seeds = seed_cuda.mmp_seed_cuda(dfm, walkers, wlens, AlignParams().mmp,
                                    int(min(16, max(4, L // 16 + 2))), chg, chg)
    flat = seeding_dev.flatten_seeds(seeds)
    return seeding_dev.expand_rows(flat.sa_lo, flat.sa_count)


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


class _Tee:
    """A text stream that writes through to another and keeps the text."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _cli(argv, dev: torch.device) -> tuple:
    """``megapath_tpu_torch.cli.main(argv --device dev)`` on the host
    clock: (seconds, the text it wrote to stderr)."""
    from megapath_tpu_torch import cli

    tee = _Tee(sys.stderr)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        rc = cli.main([*map(str, argv), "--device", str(dev)])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"[cli] {argv[0]} exited {rc}")
    return time.perf_counter() - t, tee.text()


def mask_clock(err: str) -> str:
    """A run's standard error less what the clock writes: the stage
    timestamps and seconds (the CPU tests compare the two CLIs' by it)."""
    err = re.sub(r"\[TIMESTAMP\] .*? (\S+\.\.\.)$", r"[TIMESTAMP] \1", err, flags=re.M)
    return re.sub(r"took [\d.]+ sec|done in [\d.]+s", "took", err)


def _stage_seconds(stderr: str) -> dict:
    """run_files' StageTimer lines ("[TIMER] <stage> took <s> sec.")."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"\[TIMER\] (\S+) took ([\d.]+) sec", stderr)}


@contextlib.contextmanager
def _host_timed(acc: dict, owner, name: str, key: str):
    """Time every call of ``owner.name`` into ``acc[key]`` (host clock, no
    card synchronisation: it runs on the pipeline's writer thread)."""
    fn = getattr(owner, name)

    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t

    setattr(owner, name, run)
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def _pipeline_stages(timer: StageTimer):
    """Record the pipeline's own stages (bbduk, hg, ribo) and its NT
    alignment ("nt") into ``timer`` while the CLI runs it."""
    stage, shards = MegaPathPipeline._stage, MegaPathPipeline._align_shards

    def align_shards(self, *a, **k):
        with timer.stage("nt"):
            return shards(self, *a, **k)

    MegaPathPipeline._stage = lambda self, name: timer.stage(name)
    MegaPathPipeline._align_shards = align_shards
    try:
        yield
    finally:
        MegaPathPipeline._stage, MegaPathPipeline._align_shards = stage, shards


def _cli_records() -> dict:
    return json.loads((FIX / "torch_cli_records.json").read_text())


def cli_world(dev: torch.device, smi: str, d: Path) -> None:
    """The world's FASTAs through ``build-index`` on the card and its gzip
    FASTQ through ``run -b`` on device and on host seeding: the reports,
    both LSAM.id files and the merged and per-shard BAM content equal the
    JAX command line's (``torch_cli_records.json``)."""
    want = _cli_records()["world"]
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if pairs_digest(world["pairs"]) != want["input_sha256"]:
        raise AssertionError("[cli] the world's inputs differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    write_world_files(world, d)
    build_s = sum(_cli(argv, dev)[0] for argv in world_build_argvs(d))
    for device_seeding, key in ((True, "device_seeding"), (False, "host_seeding")):
        zero_counts()
        dt, _ = _cli(world_run_argv(d, str(d / key), device_seeding), dev)
        counts = read_counts()
        _require_launches("cli world", counts, ("dp_full", "mmp_seed", "locate")
                          if device_seeding else ("dp_full",))
        got = cli_record(str(d / key), n_shards=2)
        bad = [(k, *text_diff(got[k], want[key][k])) for k in ("report", "ra_report")
               if got[k] != want[key][k]]
        bad += [k for k in ("lsam_sha256", "ra_lsam_sha256", "bam_sha256")
                if got[k] != want[key][k]]
        if bad:
            raise AssertionError(f"[cli] world {key}: differs from the JAX CLI's record: {bad}")
        print(f"[cli] world, {key}: build-index of nt (2 shards), hg, ribo on the card "
              f"{build_s:.3f} s; run -b {dt:.3f} s; reports, both LSAM.id files and the "
              f"merged and 2 shard BAMs' content equal the JAX CLI's; launches {counts} [{smi}]")


@contextlib.contextmanager
def _index_stages(split: Split):
    """Time the index build's stages into ``split`` while the CLI runs
    it: the FASTA split, the pack, the build and the save."""
    from megapath_tpu_torch.index import fm as fm_mod
    from megapath_tpu_torch.index import pack as pack_mod
    from megapath_tpu_torch.index import shard as shard_mod

    patches = [(shard_mod, "split_fasta", "split"), (pack_mod, "pack_fasta_file", "pack"),
               (fm_mod, "build_fm_index", "build"), (pack_mod.PackedReference, "save", "save"),
               (fm_mod.FMIndex, "save", "save")]
    orig = [getattr(o, n) for o, n, _ in patches]
    for o, n, k in patches:
        setattr(o, n, split.wrap(k, getattr(o, n)))
    try:
        yield
    finally:
        for (o, n, _), fn in zip(patches, orig):
            setattr(o, n, fn)


def cli_index_large(dev: torch.device, smi: str, ref: PackedReference, d: Path) -> str:
    """``large_workload``'s 512 Mbp genome as FASTA through ``build-index``
    on the card: the split, pack, build and save times, the build's peak
    card memory in bytes a character (which must not exceed
    ``shard.BUILD_BYTES_PER_CHAR``, the figure the refusal uses) and the
    file sizes. Returns the index prefix."""
    import gc

    from megapath_tpu_torch.index import shard as shard_mod

    (d / "hg").mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    write_fasta(d / "hg.fa", [(name, "", ref.codes[ref.offsets[i]:ref.offsets[i + 1]])
                              for i, name in enumerate(ref.names)])
    write_s = time.perf_counter() - t
    split = Split()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with _index_stages(split):
        dt, _ = _cli(["build-index", d / "hg.fa", d / "hg" / "hg", "--sa-interval", "4",
                      "--lut-k", "8"], dev)
    n = ref.total_len
    per_char = (torch.cuda.max_memory_allocated(dev) - base) / n
    total = torch.cuda.get_device_properties(dev).total_memory
    sizes = {p.name: p.stat().st_size for p in sorted((d / "hg").glob("shard0.*.npz"))}
    t = split.t
    print(f"[cli] build-index of the {n} bp shard on the card: {dt:.3f} s = FASTA split "
          f"{t['split']:.3f} s, pack {t['pack']:.3f} s, build {t['build']:.3f} s, save "
          f"{t['save']:.3f} s, rest {dt - sum(t.values()):.3f} s (the FASTA written in "
          f"{write_s:.3f} s); card peak {per_char * n / 2**30:.2f} GiB above "
          f"{base / 2**30:.2f} GiB = {per_char:.2f} bytes a character: {total} bytes of card "
          f"memory hold {int(total // per_char)} bp; files {sizes} [{smi}]")
    if per_char > shard_mod.BUILD_BYTES_PER_CHAR:
        raise AssertionError(
            f"[cli] the build took {per_char:.2f} bytes a character, more than the "
            f"{shard_mod.BUILD_BYTES_PER_CHAR} the refusal of a large shard assumes")
    return str(d / "hg" / "shard0")


def cli_realistic(dev: torch.device, smi: str, large_batch, hg_index: str, d: Path) -> dict:
    """The realistic cell from files: the community through ``build-index``
    on the card, its 50,000 pairs and the 512 Mbp workload's 20,000 as
    gzip FASTQ, ``run --hg-index --nt-index -L 100`` with both indexes
    loaded from disk, then once more with ``-b``. Gates: walks, locates and
    ``dp_full`` launched; the human pairs the filter keeps and the reports
    and LSAM.id equal the JAX CLI's record of the same NT input; the -b
    run's reports equal the first's, and its merged BAM round-trips, is
    sorted and has one primary line per read end with a hit. Returns the
    first run's launch counts."""
    from megapath_tpu_torch import cli
    from megapath_tpu_torch.io import sam as sam_mod
    from megapath_tpu_torch.io.bam import sort_sam_lines

    want = _cli_records()["e2e"]
    genomes, pairs = e2e_workload()
    if pairs_digest(pairs) != want["input_sha256"]:
        raise AssertionError("[cli] the community's reads differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    write_e2e_files(d, genomes, pairs + human_pairs(*large_batch))
    nt_s, _ = _cli(["build-index", d / "community.fa", d / "nt" / "nt", *E2E_INDEX_ARGS], dev)
    loads = Split()
    orig_load = cli.load_shard
    cli.load_shard = loads.wrap("load", orig_load)
    stages = StageTimer(out=open(os.devnull, "w"))
    try:
        zero_counts()
        with _pipeline_stages(stages):
            dt, err = _cli(e2e_run_argv(d, str(d / "run"), hg_index), dev)
        counts = read_counts()
        load_s = loads.t["load"]
        loads.t.clear()
        acc = {}
        with _host_timed(acc, sam_mod, "sw_traceback_batch", "traceback"), \
                _host_timed(acc, MegaPathPipeline, "_write_batch_sam", "sam"):
            dt_b, err_b = _cli(e2e_run_argv(d, str(d / "runb"), hg_index) + ["-b"], dev)
        load_b = loads.t["load"]
    finally:
        cli.load_shard = orig_load
    _require_launches("cli", counts, ("dp_full", "mmp_seed", "locate"))
    got = cli_record(str(d / "run"))
    lsam = (d / "run.nt.lsam.id").read_text().splitlines()
    kept = [ln.split("\t", 1)[0] for ln in lsam[::2] if ln.startswith("hg")]
    key = {(): "alone", tuple(want["hg_kept"]): "with_hg_kept"}.get(tuple(kept))
    bad = [] if key else [f"the human filter kept {kept[:10]}"]
    if key:
        bad += [(k, *text_diff(got[k], want[key][k])) for k in ("report", "ra_report")
                if got[k] != want[key][k]]
        bad += [k for k in ("lsam_sha256", "ra_lsam_sha256") if got[k] != want[key][k]]
    # the community's classification equals phase 10's JAX e2e record's
    e2e = _pipeline_records()["e2e"]
    bad += [f"{k}: taxon rows differ from the JAX e2e run's" for k in ("report", "ra_report")
            if taxon_rows(got[k]) != taxon_rows(e2e[k])]
    got_b = cli_record(str(d / "runb"))
    bad += [f"-b run: {k}" for k in got if got_b[k] != got[k]]
    header, lines = bam_content(str(d / "runb.nt.bam"))
    if sort_sam_lines(header, lines) != lines:
        bad.append("the merged BAM is not sorted")
    primary = collections.Counter(
        (c[0], 64 if int(c[1]) & 0x40 else 128)
        for c in (ln.split("\t", 2) for ln in lines) if not int(c[1]) & 0x100)
    with_hit = {(c[0], int(c[1])) for c in (
        ln.split("\t", 3) for ln in (d / "runb.nt.raw.lsam.id").read_text().splitlines())
        if int(c[2]) > 0}
    if set(primary) != with_hit or set(primary.values()) != {1}:
        bad.append(f"primary BAM lines: {len(primary)} read ends (at most "
                   f"{max(primary.values(), default=0)} each) vs {len(with_hit)} with a hit")
    if bad:
        raise AssertionError(f"[cli] the realistic run from files: {bad}")
    n_in = len(pairs) + len(large_batch[0])
    st, st_b = _stage_seconds(err), _stage_seconds(err_b)
    print(f"[cli] realistic run from files ({n_in} pairs x 100 bp, gzip FASTQ): "
          f"build-index of the community {nt_s:.3f} s; run {dt:.3f} s = index loads "
          f"{load_s:.3f} s + the rest {dt - load_s:.3f} s ({2 * n_in / (dt - load_s):.0f} "
          f"reads/s without the loads); StageTimer " + ", ".join(
              f"{k} {v:.2f} s" for k, v in st.items())
          + " (of align: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.summary().items())
          + f"); the human filter kept {kept}; reports and LSAM.id equal the JAX CLI's "
          f"record '{key}'; launches {counts} [{smi}]")
    print(f"[cli] run -b: {dt_b:.3f} s (loads {load_b:.3f} s); StageTimer " + ", ".join(
        f"{k} {v:.2f} s" for k, v in st_b.items())
          + f"; SAM lines in the writer thread {acc.get('sam', 0.0):.3f} s, of which "
          f"traceback {acc.get('traceback', 0.0):.3f} s; merged BAM {len(lines)} lines, "
          f"{len(primary)} primary, sorted, one primary a read end with a hit [{smi}]")
    return counts


def phase_cli(dev: torch.device, smi: str, large) -> dict:
    """The command line on the card (``megapath_tpu_torch.cli.main``):
    the world through build-index and run -b; the 512 Mbp shard through
    build-index; the realistic cell from files. Returns the realistic
    run's launch counts."""
    import tempfile

    ref, _, batch = large
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cli_world(dev, smi, d / "world")
        hg_index = cli_index_large(dev, smi, ref, d / "large")
        return cli_realistic(dev, smi, batch, hg_index, d / "e2e")


PLANTED_ENDS = 2048  # read ends planted in the default shard
PLANTED_LEN = 100
# the shards of a real NT database at the 2.0 Gbp cap
# (tests/test_shard_rotation.py:3-5): what the rotation's cost is derived for
NT_DB_SHARDS = 125


@contextlib.contextmanager
def _commit_stages(split: Split):
    """Time a commit's parts into ``split`` while an engine commits: the
    host packing of the FM tables (``HostFM.pack``) and of the text's
    words (``pack_ref_words``), the tables' upload (``HostFM.upload``);
    the rest of a commit is the text's and the words' upload."""
    from megapath_tpu_torch.align import engine as engine_mod

    host_fm = seeding_dev.HostFM
    pack, upload, words = vars(host_fm)["pack"], host_fm.upload, engine_mod.pack_ref_words
    host_fm.pack = staticmethod(split.wrap("pack tables", host_fm.pack))
    host_fm.upload = split.wrap("upload tables", upload)
    engine_mod.pack_ref_words = split.wrap("pack words", words)
    try:
        yield
    finally:
        host_fm.pack, host_fm.upload, engine_mod.pack_ref_words = pack, upload, words


def _commit(engine: AlignEngine) -> None:
    """What the rotation puts on the card for one shard and one batch: the
    engine's commit and its packed text words (the walk-state DP's)."""
    engine.commit()
    engine._ref_words()
    torch.cuda.synchronize()


def engine_card_bytes(engine: AlignEngine) -> int:
    """The bytes a committed engine holds on its card: the FM tables, the
    text codes and the packed text words."""
    return (engine.dfm.nbytes + engine._ref_dev.numel()
            + engine._ref_words_dev.numel() * engine._ref_words_dev.element_size())


def shard_commits(dev: torch.device, smi: str, codes: np.ndarray, fm) -> "seeding_dev.DeviceFM":
    """The default shard through a lazy engine's commits, as the rotation
    makes them: the first commit (``DeviceFM.from_host``'s packing and
    upload, the text and its packed words) split into host packing and
    upload beside its card peak, then one evict -> commit round, which
    uploads what the first packed and packs nothing. Prints both, the
    bytes on the card and kept on the host, and the rotation's cost a
    batch derived for NT_DB_SHARDS shards. Returns the engine's tables."""
    n = len(codes)
    ref = PackedReference(codes, ["shard2g"], [""], np.array([0, n], np.int64),
                          np.zeros((0, 2), np.int64))
    engine = AlignEngine(ref, fm, AlignParams(), device=dev, device_seeding=True,
                         lazy_device=True)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first, again = Split(), Split()
    with _commit_stages(first):
        first.wrap("commit", _commit)(engine)
    peak = torch.cuda.max_memory_allocated(dev) - base
    on_card = engine_card_bytes(engine)
    engine.evict()
    torch.cuda.synchronize()
    evicted = torch.cuda.memory_allocated(dev) - base
    with _commit_stages(again):
        again.wrap("commit", _commit)(engine)
    f, a = first.t, again.t
    first_s, again_s = first.t["commit"], again.t["commit"]
    if set(a) - {"commit", "upload tables"}:
        raise AssertionError(f"[shard] the re-commit packed on the host: {dict(a)}")
    host = engine._host_fm
    kept = (host.rows.nbytes + host.mark_rows.nbytes + host.sa_sampled.nbytes
            + engine._host_words.nbytes)
    pack_s = f["pack tables"] + f["pack words"]
    print(f"[shard] first commit of the {n} bp shard (DeviceFM.from_host and the text): "
          f"{first_s:.3f} s = host packing {pack_s:.3f} s (tables {f['pack tables']:.3f}, "
          f"text words {f['pack words']:.3f}) + upload {first_s - pack_s:.3f} s (tables "
          f"{f['upload tables']:.3f}, text and words {first_s - pack_s - f['upload tables']:.3f}"
          f"); card peak {peak / 2**30:.2f} GiB, {on_card} bytes held ({on_card / n:.3f} "
          f"a character); after evict {evicted} bytes [{smi}]")
    print(f"[shard] re-commit after evict, as the rotation makes it each batch: {again_s:.3f} s "
          f"= tables {a['upload tables']:.3f} s + text and words "
          f"{again_s - a['upload tables']:.3f} s, all upload, nothing packed; the engine keeps "
          f"{kept} bytes ({kept / 2**30:.2f} GiB, {kept / n:.3f} a character) packed on the "
          f"host for it. Derived, not measured: {NT_DB_SHARDS} such shards rotate through one "
          f"card in {NT_DB_SHARDS * again_s:.1f} s a batch ({NT_DB_SHARDS * first_s:.1f} s if "
          f"each re-commit packed again) [{smi}]")
    return engine.dfm


def host_available_gib() -> float:
    """The host's available memory (``MemAvailable``), GiB."""
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_shard(dev: torch.device, smi: str, lat: dict) -> float:
    """The 2.0 Gbp default shard on the card: a random text drawn there,
    the fit check, the index build with each stage's seconds and peak, the
    device tables, planted read ends through the device seeding leg, and
    the locate against its plain version on their rows. Returns the
    phase's seconds."""
    import gc

    from megapath_tpu_torch.index import shard as shard_mod
    from megapath_tpu_torch.ops import sort_cuda

    t_phase = time.perf_counter()
    n = shard_mod.DEFAULT_SHARD_BP
    print(f"[shard] host memory available {host_available_gib():.1f} GiB; card "
          f"{torch.cuda.get_device_properties(dev).total_memory} bytes")
    shard_mod.check_shard_fits(n, dev)
    print(f"[shard] check_shard_fits admits the {n} bp default shard at "
          f"{shard_mod.BUILD_BYTES_PER_CHAR} bytes a character")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(2_000_000_000)
    codes = torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev, generator=g).cpu().numpy()
    print(f"[shard] {n} random characters drawn on the card in {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stages = {}
    sort_cuda.sort_launches = 0
    t = time.perf_counter()
    fm = build_fm_index(codes, sa_interval=8, lut_k=8, device=dev, stages=stages)
    build_s = time.perf_counter() - t
    worst = 0.0
    for name, (sec, peak) in stages.items():
        per_char = (peak - base) / n
        worst = max(worst, per_char)
        print(f"[shard] build stage {name}: {sec:.3f} s, card peak {(peak - base) / 2**30:.2f} "
              f"GiB = {per_char:.2f} bytes a character")
    print(f"[shard] build_fm_index of {n} bp on the card: {build_s:.3f} s, "
          f"{sort_cuda.sort_launches} CUB sorts, peak {worst:.2f} bytes a character "
          f"(limit {shard_mod.BUILD_BYTES_PER_CHAR}); {len(fm.sa_sampled)} sampled positions "
          f"[{smi}]")
    if worst > shard_mod.BUILD_BYTES_PER_CHAR:
        raise AssertionError(f"[shard] the build took {worst:.2f} bytes a character, more than "
                             f"the {shard_mod.BUILD_BYTES_PER_CHAR} check_shard_fits assumes")
    gc.collect()
    torch.cuda.empty_cache()
    dfm = shard_commits(dev, smi, codes, fm)
    # exact read ends planted at known positions: each must be located there
    rng = np.random.default_rng(2048)
    at = rng.integers(0, n - PLANTED_LEN, PLANTED_ENDS)
    reads = codes[at[:, None] + np.arange(PLANTED_LEN)]
    lens = np.full(PLANTED_ENDS, PLANTED_LEN, np.int32)
    del fm, codes
    chg = 3 * PLANTED_LEN + 64
    zero_counts()
    flat, pos, _ = seeding_dev.device_seed_pipeline_loc(
        dfm, torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev),
        AlignParams().mmp, int(min(16, max(4, PLANTED_LEN // 16 + 2))), chg, chg)
    torch.cuda.synchronize()
    counts = read_counts()
    _require_launches("shard", counts, ("mmp_seed", "locate"))
    walker = torch.repeat_interleave(flat.walker.long(), flat.sa_count.long())
    offset = torch.repeat_interleave(flat.offset.long(), flat.sa_count.long())
    want = torch.from_numpy(at).to(dev)
    fwd = walker < PLANTED_ENDS
    at_planted = ((pos.long() - offset)[fwd] == want[walker[fwd]]).long()
    found = torch.zeros(PLANTED_ENDS, dtype=torch.int64, device=dev).index_add_(
        0, walker[fwd], at_planted) > 0
    if not bool(found.all()):
        miss = torch.nonzero(~found)[:, 0][:5].tolist()
        raise AssertionError(f"[shard] {int((~found).sum())} planted read ends not located at "
                             f"their positions, e.g. {miss}")
    print(f"[shard] {PLANTED_ENDS} exact {PLANTED_LEN} bp read ends through "
          f"device_seed_pipeline_loc: {len(flat.walker)} seeds, {len(pos)} SA rows, every "
          f"read end located at its planted position; launches {counts}")
    rows = seeding_dev.expand_rows(flat.sa_lo, flat.sa_count)
    check_locate("shard", dfm, rows, lat["HBM"], "HBM", smi)
    del dfm
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"[shard] the default-shard phase took {secs:.1f} s")
    return secs


def _db_records() -> dict:
    return json.loads((FIX / "torch_db_records.json").read_text())


def phase_db(dev: torch.device, smi: str) -> float:
    """``build-db`` on the card, then ``run`` on its shards on device
    seeding: the curated FASTA, every member of both shards' files, the
    reports and both LSAM.id files equal the JAX CLI's record. Returns
    the phase's seconds."""
    import tempfile

    t_phase = time.perf_counter()
    want = _db_records()
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if pairs_digest(world["pairs"]) != want["input_sha256"]:
        raise AssertionError("[db] the world's inputs differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_db_files(world, d)
        split = Split()
        with _index_stages(split):
            build_s, err = _cli(db_build_argv(d), dev)
        t = split.t
        print(f"[db] build-db on the card: {build_s:.3f} s = curate (taxonomy, createDB, "
              f"filterDB, curated FASTA) and the rest {build_s - sum(t.values()):.3f} s, "
              f"FASTA split {t['split']:.3f} s, pack {t['pack']:.3f} s, build "
              f"{t['build']:.3f} s, save {t['save']:.3f} s; "
              f"{' '.join(l for l in err.splitlines() if 'curated' in l or 'shard(s)' in l)} "
              f"[{smi}]")
        zero_counts()
        run_s, _ = _cli(db_run_argv(d, str(d / "run")), dev)
        counts = read_counts()
        _require_launches("db run", counts, ("dp_full", "mmp_seed", "locate"))
        got = db_record(d, str(d / "run"))
    bad = [k for k in ("curated_sha256", "shards") if got[k] != want[k]]
    bad += [(k, *text_diff(got["run"][k], want["run"][k])) for k in ("report", "ra_report")
            if got["run"][k] != want["run"][k]]
    bad += [k for k in ("lsam_sha256", "ra_lsam_sha256") if got["run"][k] != want["run"][k]]
    if bad:
        raise AssertionError(f"[db] differs from the JAX CLI's record: {bad}")
    secs = time.perf_counter() - t_phase
    print(f"[db] run on build-db's {DB_SHARDS} shards, device seeding: {run_s:.3f} s; the "
          f"curated FASTA, every shard file member, both reports and both LSAM.id files "
          f"equal the JAX CLI's; launches {counts}; the phase took {secs:.1f} s [{smi}]")
    return secs


def _asm_records() -> dict:
    return json.loads((FIX / "torch_asm_records.json").read_text())


def _asm_diff(got: dict, want: dict) -> list:
    """The fields of two ``asm_record``s that differ."""
    bad = [(k, *text_diff(got[k], want[k])) for k in ("contigs_fa", "report", "ra_report")
           if got[k] != want[k]]
    return bad + [(k, got[k], want[k]) for k in ("r2c_sha256", "r2c_lines", "lsam_sha256",
                                                "ra_lsam_sha256") if got[k] != want[k]]


def _protein_records() -> dict:
    return json.loads((FIX / "torch_protein_records.json").read_text())


def _protein_diff(got: dict, want: dict) -> list:
    """The fields of two ``protein_record``s that differ."""
    bad = [(k, *text_diff(got[k], want[k])) for k in ("nr_lsam_id", "nr_report")
           if got[k] != want[k]]
    return bad + [(k, got[k], want[k]) for k in ("r2g_sha256", "r2g_lines") if got[k] != want[k]]


@contextlib.contextmanager
def _protein_probe(acc: dict, batch: dict):
    """Time the protein remap into ``acc`` (host clock): "remap" the whole
    of ``protein_remap``, "blastx" its search, "dp" the DP call with the
    card synchronized after it, "traceback" the host tracebacks; record the
    DP batch's (B, R, W), useful cells and launches and the tracebacks'
    count and cells into ``batch``."""
    from megapath_tpu_torch.classify import protein as prot_mod
    from megapath_tpu_torch.pipeline import assembly as asm_mod
    from megapath_tpu_torch.pipeline import megapath as pipe_mod

    dp, tb = prot_mod.sw_align_protein, prot_mod._traceback
    batch.update(tracebacks=0, traceback_cells=0, launches=0, B=0, R=0, W=0, useful=0)

    def run_dp(reads, refs, read_lens, ref_lens, params):
        (B, R), W = reads.shape, refs.shape[1]
        useful = int((read_lens.long() * ref_lens.long()).sum())
        before = protein_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = dp(reads, refs, read_lens, ref_lens, params)
        torch.cuda.synchronize()
        acc["dp"] = acc.get("dp", 0.0) + time.perf_counter() - t
        batch.update(B=batch["B"] + B, R=max(batch["R"], R), W=max(batch["W"], W),
                     useful=batch["useful"] + useful,
                     launches=batch["launches"] + protein_cuda.launches - before)
        return res

    def run_tb(q, s, params):
        batch["tracebacks"] += 1
        batch["traceback_cells"] += len(q) * len(s)
        t = time.perf_counter()
        try:
            return tb(q, s, params)
        finally:
            acc["traceback"] = acc.get("traceback", 0.0) + time.perf_counter() - t

    prot_mod.sw_align_protein, prot_mod._traceback = run_dp, run_tb
    try:
        with _host_timed(acc, pipe_mod, "protein_remap", "remap"), \
                _host_timed(acc, asm_mod, "blastx_m8", "blastx"):
            yield
    finally:
        prot_mod.sw_align_protein, prot_mod._traceback = dp, tb
    for k in ("remap", "blastx", "dp", "traceback"):
        acc.setdefault(k, 0.0)


def phase_asm(dev: torch.device, smi: str) -> tuple:
    """The assembly stage (``run -A``) on the card. The world part: the
    world's indexes built with ``build-index``, its pairs plus a dense
    SARS-CoV-2 tiling through ``run -A`` on device and on host seeding.
    The realistic part: the world's pairs plus two novel viruses' 9,000
    pairs through ``run`` and then ``run -A --protein-db`` (the realistic
    protein DB) on the same prefix (the journal leaves the assembly stage
    and the protein remap alone), its host steps timed, the protein
    remap's seeding, DP, tracebacks and tail timed and its launches
    counted. Every contigs FASTA, r2c LSAM, report and LSAM.id equals the
    JAX CLI's record (``torch_asm_records.json``), the protein remap's
    outputs the JAX CLI's (``torch_protein_records.json``). Returns the
    phase's seconds and sw_subst's launches."""
    import tempfile

    from megapath_tpu_torch.pipeline import assembly as asm_mod
    from megapath_tpu_torch.pipeline import megapath as pipe_mod

    t_phase = time.perf_counter()
    want = _asm_records()
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if asm_digests(world) != {k: want[k] for k in ("world_input_sha256",
                                                     "realistic_input_sha256")}:
        raise AssertionError("[asm] the inputs differ from the fixture's: numpy's generator "
                             "drifted, this is not a port fault")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_asm_files(world, d)
        build_s = sum(_cli(argv, dev)[0] for argv in world_build_argvs(d))
        for device_seeding, key in ((True, "device_seeding"), (False, "host_seeding")):
            zero_counts()
            dt, err = _cli(asm_run_argv(d, str(d / key), device_seeding), dev)
            counts = read_counts()
            _require_launches("asm world", counts, ("dp_full", "mmp_seed", "locate")
                              if device_seeding else ("dp_full",))
            got = asm_record(str(d / key))
            bad = _asm_diff(got, want["world"][key])
            if bad:
                raise AssertionError(f"[asm] world {key}: differs from the JAX CLI's record: "
                                     f"{bad}")
            print(f"[asm] world + SARS-CoV-2 tiling, {key}: build-index {build_s:.3f} s; run -A "
                  f"{dt:.3f} s (assembly stage {_stage_seconds(err)['assembly']:.3f} s); "
                  f"{got['contigs_fa'].count('>')} contigs, {got['r2c_lines']} r2c lines; "
                  f"contigs, r2c, reports and both LSAM.id equal the JAX CLI's; launches "
                  f"{counts} [{smi}]")

        write_protein_files(world, d)
        prefix = str(d / "real" / "run")
        run_s, _ = _cli(asm_run_argv(d, prefix, True, reads=d / "real", assembly=False), dev)
        acc, seen, prot_acc, batch = {}, {}, {}, {}
        zero_counts()
        with contextlib.ExitStack() as st:
            st.enter_context(_bbnorm_probe(asm_mod, seen))
            for owner, name, key in (
                    (pipe_mod, "extract_viral_and_unmapped", "extract"),
                    (asm_mod, "normalize_pairs", "bbnorm"),
                    (asm_mod, "assemble_multik", "assemble"),
                    (asm_mod, "build_fm_index", "contig index"),
                    (AlignEngine, "align_pairs", "align back")):
                st.enter_context(_host_timed(acc, owner, name, key))
            st.enter_context(_protein_probe(prot_acc, batch))
            asm_s, err = _cli(asm_run_argv(d, prefix, True, reads=d / "real") + [
                "--protein-db", str(d / "real" / "prot.fa")], dev)
        counts = read_counts()
        _require_launches("asm realistic", counts, ("dp_full", "mmp_seed", "locate",
                                                     "sw_subst"))
        got = asm_record(prefix)
        got_prot = protein_record(prefix)
    genomes, _ = asm_realistic_workload()
    stats = asm_stats(got["contigs_fa"], genomes, seen["extracted"], seen["kept"])
    w = want["realistic"]
    bad = _asm_diff(got, w) + ([("stats", stats, w["stats"])] if stats != w["stats"] else [])
    bad += _protein_diff(got_prot, _protein_records()["realistic"])
    if bad:
        raise AssertionError(f"[asm] realistic: differs from the JAX CLI's record: {bad}")
    stage = _stage_seconds(err)["assembly"]
    split = ", ".join(f"{k} {v:.3f} s" for k, v in acc.items())
    print(f"[asm] realistic (the world's 88 pairs + {len(genomes)} novel viruses' "
          f"{sum(n for _, _, n in ASM_VIRUSES)} pairs, 2 x {ASM_READ_LEN} bp, device "
          f"seeding): run {run_s:.3f} s; run -A --protein-db {asm_s:.3f} s, the assembly "
          f"stage {stage:.3f} s = {split}, protein remap {prot_acc['remap']:.3f} s, the rest "
          f"(the FASTQ and LSAM re-read, the outputs) "
          f"{stage - sum(acc.values()) - prot_acc['remap']:.3f} s [{smi}]")
    rec = ", ".join(f"{k} {v:.4f}" for k, v in stats["recovery"].items())
    print(f"[asm] realistic: bbnorm kept {stats['kept_pairs']} of {stats['extracted_pairs']} "
          f"pairs; {stats['contigs']} contigs, N50 {stats['n50']}, {stats['total_bp']} bp; "
          f"recovery {rec}; {got['r2c_lines']} r2c lines; contigs, r2c, reports and both "
          f"LSAM.id equal the JAX CLI's; the contig engine's and blastx's launches {counts} "
          f"[{smi}]")
    print(f"[asm] realistic protein remap: {prot_acc['remap']:.3f} s = protein seeding "
          f"{prot_acc['blastx'] - prot_acc['dp'] - prot_acc['traceback']:.3f} s (translate, "
          f"k-mer join, bands, the padded batch), DP {prot_acc['dp']:.3f} s ({batch['launches']} "
          f"sw_subst launch, host clock around the synchronized call: B={batch['B']} "
          f"R={batch['R']} W={batch['W']}, {batch['useful']} useful cells of "
          f"{batch['B'] * batch['R'] * batch['W']} padded), traceback "
          f"{prot_acc['traceback']:.3f} s ({batch['tracebacks']} host tracebacks, "
          f"{batch['traceback_cells']} cells), the tail (m8 -> LSAM, taxid lookup, r2g, "
          f"report) {prot_acc['remap'] - prot_acc['blastx']:.3f} s; "
          f"{got_prot['nr_lsam_id'].count(chr(10))} NR LSAM.id lines, {got_prot['r2g_lines']} "
          f"r2g lines, equal to the JAX CLI's [{smi}]")
    secs = time.perf_counter() - t_phase
    print(f"[asm] the assembly phase took {secs:.1f} s")
    return secs, counts["sw_subst"]


def run_outputs(d: Path, prefix: str) -> dict:
    """Every file a run wrote under ``d / prefix``: text and markers as
    bytes, the align state's npz by member."""
    return {p.name[len(prefix):]: npz_digest(p) if p.suffix == ".npz" else p.read_bytes()
            for p in sorted(d.glob(prefix + ".*"))}


def acd_problems(lines: list) -> list:
    """``tests/test_protein.py:298-327``'s checks of blastx's m8 lines
    against the ac-diamond golden (``acd.m8``): every golden query's top
    hit has the golden subject, a bitscore within 10% of its, and on an
    exact-match contig the same length, identity, mismatches and subject
    span; no junk query hits. Returns what fails."""
    golden = {}
    for line in open(PROT_ACD / "acd.m8"):
        c = line.rstrip("\n").split("\t")
        golden[c[0]] = c
    ours: dict = {}
    for line in lines:
        c = line.split("\t")
        ours.setdefault(c[0], []).append(c)
    bad = [f"junk query {q} hit" for q in ours if q.endswith("_junk")]
    for q, g in golden.items():
        if q not in ours:
            bad.append(f"{q}: no hit, ac-diamond hit {g[1]}")
            continue
        top = max(ours[q], key=lambda c: float(c[11]))
        if top[1] != g[1] or abs(float(top[11]) - float(g[11])) > 0.10 * float(g[11]):
            bad.append(f"{q}: {top[1]} {top[11]} against ac-diamond's {g[1]} {g[11]}")
        if float(g[2]) == 100.0 and (float(top[2]) != 100.0 or top[3] != g[3] or top[4] != "0"
                                     or (top[8], top[9]) != (g[8], g[9])):
            bad.append(f"{q}: columns {top[2:10]} against {g[2:10]}")
    return bad


def phase_protein(dev: torch.device, smi: str) -> tuple:
    """The protein path (stage 4.1) on the card. (a) The ac-diamond fixture
    through ``blastx_m8`` on the card: the lines equal the JAX record and
    pass ``tests/test_protein.py``'s golden checks. (b) The world part
    (phase 14's world files and the world protein DB) through ``run -A
    --protein-db`` on device seeding: the three protein files non-empty,
    every output equal to the JAX CLI's record. (c) ``run --protein-db``
    without ``-A`` writes exactly the files ``run`` writes. Returns the
    phase's seconds and sw_subst's launches."""
    import tempfile

    t_phase = time.perf_counter()
    want = _protein_records()
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if protein_digests(world) != {k: want[k] for k in ("world_db_sha256", "realistic_db_sha256",
                                                        "acd_sha256")}:
        raise AssertionError("[protein] the inputs differ from the fixture's: numpy's generator "
                             "drifted, this is not a port fault")
    prots, queries = acd_inputs()
    zero_counts()
    t = time.perf_counter()
    lines = blastx_m8(queries, ProteinDB.build(prots), device=dev)
    acd_s = time.perf_counter() - t
    launched = read_counts()["sw_subst"]
    if lines != want["acd"] or acd_problems(lines) or not launched:
        raise AssertionError(
            f"[protein] ac-diamond fixture: m8 lines against the JAX record "
            f"{text_diff(chr(10).join(lines), chr(10).join(want['acd']))}, golden checks "
            f"{acd_problems(lines)}, sw_subst launches {launched}")
    print(f"[protein] ac-diamond fixture ({len(queries)} contigs against {len(prots)} proteins) "
          f"through blastx_m8 on the card: {len(lines)} m8 lines equal the JAX record, the "
          f"golden checks hold; {acd_s:.3f} s, sw_subst launches {launched} [{smi}]")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_asm_files(world, d)
        write_protein_files(world, d)
        for argv in world_build_argvs(d):
            _cli(argv, dev)
        prefix = str(d / "protein_world")
        zero_counts()
        dt, _ = _cli(protein_world_argv(d, prefix), dev)
        counts = read_counts()
        _require_launches("protein world", counts, ("dp_full", "mmp_seed", "locate", "sw_subst"))
        got = {**asm_record(prefix), **protein_record(prefix)}
        bad = _asm_diff(got, want["world"]) + _protein_diff(got, want["world"])
        empty = [suf for suf in PROTEIN_FILES if not Path(prefix + suf).read_bytes()]
        if bad or empty:
            raise AssertionError(f"[protein] world: differs from the JAX CLI's record {bad}, "
                                 f"empty {empty}")
        launched += counts["sw_subst"]
        print(f"[protein] world + SARS-CoV-2 tiling, run -A --protein-db, device seeding: "
              f"{dt:.3f} s; {got['nr_lsam_id'].count(chr(10))} NR LSAM.id lines, "
              f"{got['r2g_lines']} r2g lines, the NR report, the contigs, r2c, reports and "
              f"LSAM.id equal the JAX CLI's; launches {counts} [{smi}]")
        outs = {}
        for tag, argv in (("plain", asm_run_argv(d, str(d / "plain"), True, assembly=False)),
                          ("protein_db", protein_world_argv(d, str(d / "protein_db"),
                                                            assembly=False))):
            _cli(argv, dev)
            outs[tag] = run_outputs(d, tag)
        if outs["plain"] != outs["protein_db"]:
            raise AssertionError(f"[protein] run --protein-db without -A wrote "
                                 f"{sorted(outs['protein_db'])}, run wrote {sorted(outs['plain'])}")
        print(f"[protein] run --protein-db without -A writes the files run writes "
              f"({', '.join(sorted(outs['plain']))}), byte for byte")
    secs = time.perf_counter() - t_phase
    print(f"[protein] the protein phase took {secs:.1f} s")
    return secs, launched


def _amp_records() -> dict:
    return json.loads((FIX / "torch_amplicon_records.json").read_text())


@contextlib.contextmanager
def _amp_probe(acc: dict, batch: dict):
    """Split an ``amplicon`` run into ``acc`` (host clock, the card
    synchronized around each engine call and DP): "bbduk" (``bbduk_pair``),
    "decoy engine" and "target engine" (``AlignEngine.align_pairs`` by the
    engine's reference), "call" (``_call_and_realign``: the pileup, the
    windows and the calling), within it "realign" (``realign_windows_batched``)
    and "hap variants" (``_hap_variants``); record into ``batch`` the realign
    batch's (B, R, W), useful cells and DP seconds, and the ``_hap_variants``
    calls and their launches."""
    from megapath_tpu_torch.amplicon import realign as realign_mod
    from megapath_tpu_torch.pipeline import amplicon as amp_mod

    align, dp = AlignEngine.align_pairs, realign_mod.dna_dp
    realign, hap = realign_mod.realign_windows_batched, amp_mod._hap_variants
    batch.update(B=0, R=0, W=0, useful=0, dp_s=0.0, hap_calls=0, hap_launches=0)
    dp_calls = []

    def timed(key, fn, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t

    def run_align(self, *a, **k):
        key = ("target engine" if self.ref.names[0].split()[0] == AMP_TARGET_NAME
               else "decoy engine")
        return timed(key, align, self, *a, **k)

    def run_dp(reads, refs, read_lens, ref_lens, params, *, device):
        t = time.perf_counter()
        res = dp(reads, refs, read_lens, ref_lens, params, device=device)  # reads back
        dp_calls.append((reads.shape[0], reads.shape[1], refs.shape[1],
                         int((read_lens.astype(np.int64) * ref_lens).sum()),
                         time.perf_counter() - t))
        return res

    def run_realign(*a, **k):
        n = len(dp_calls)
        try:
            return timed("realign", realign, *a, **k)
        finally:
            for B, R, W, useful, secs in dp_calls[n:]:
                batch.update(B=batch["B"] + B, R=max(batch["R"], R), W=max(batch["W"], W),
                             useful=batch["useful"] + useful, dp_s=batch["dp_s"] + secs)

    def run_hap(*a, **k):
        before = protein_cuda.launches
        try:
            return timed("hap variants", hap, *a, **k)
        finally:
            batch["hap_calls"] += 1
            batch["hap_launches"] += protein_cuda.launches - before

    AlignEngine.align_pairs, realign_mod.dna_dp = run_align, run_dp
    realign_mod.realign_windows_batched, amp_mod._hap_variants = run_realign, run_hap
    try:
        with _host_timed(acc, amp_mod, "bbduk_pair", "bbduk"), \
                _host_timed(acc, amp_mod.AmpliconPipeline, "_call_and_realign", "call"):
            yield
    finally:
        AlignEngine.align_pairs, realign_mod.dna_dp = align, dp
        realign_mod.realign_windows_batched, amp_mod._hap_variants = realign, hap


def _amp_diff(got: dict, want: dict) -> list:
    return [(k, *text_diff("\n".join(got[k]) if k == "stderr" else got[k],
                           "\n".join(want[k]) if k == "stderr" else want[k]))
            for k in ("vcf", "done", "stderr") if got[k] != want[k]]


def phase_amplicon(dev: torch.device, smi: str) -> tuple:
    """The amplicon pipeline (``amplicon``) on the card. The world part:
    ``tests/test_amplicon_pipeline.py``'s planted-truth world through
    ``build-index`` and ``amplicon`` with a decoy and a taxon index; the VCF
    equals ``amplicon_planted.vcf``. The realistic part: a TB amplicon panel
    at full width (``amp_realistic_workload``) through ``build-index`` of
    its target and its 32 Mbp decoy and ``amplicon``, the run split by
    ``_amp_probe``, recall and false positives against the planted truth.
    Each VCF, ``.done`` and stderr line equals the JAX CLI's record
    (``torch_amplicon_records.json``), and each run launched dp_full and
    sw_subst. Returns the phase's seconds and sw_subst's launches (the DNA
    DP's) over both runs."""
    import tempfile

    t_phase = time.perf_counter()
    want = _amp_records()
    work = amp_realistic_workload()
    digests = amp_digests(work)
    if digests != {k: want[k] for k in digests}:
        raise AssertionError("[amplicon] the inputs differ from the fixture's: numpy's generator "
                             "drifted, this is not a port fault")
    launched = 0
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        write_amp_world_files(d)
        build_s = sum(_cli(argv, dev)[0] for argv in amp_world_build_argvs(d))
        zero_counts()
        dt, err = _cli(amp_world_argv(d, str(d / "world")), dev)
        counts = read_counts()
        _require_launches("amplicon world", counts, ("dp_full", "sw_subst"))
        got = amp_record(str(d / "world"), err)
        bad = _amp_diff(got, want["world"])
        if bad or got["vcf"] != (FIX / "amplicon_planted.vcf").read_text():
            raise AssertionError(f"[amplicon] world: differs from the JAX CLI's record or the "
                                 f"golden: {bad}")
        launched += counts["sw_subst"]
        print(f"[amplicon] world (planted truth, 500 pairs of 2 x 100 bp, TB + human decoy + "
              f"taxon index): build-index {build_s:.3f} s; amplicon {dt:.3f} s; "
              f"{got['stderr'][0]}; the VCF equals amplicon_planted.vcf and the JAX CLI's, "
              f"the stderr line the JAX CLI's; launches {counts} [{smi}]")

        write_amp_realistic_files(work, d)
        index_s = [_cli(argv, dev)[0] for argv in amp_realistic_build_argvs(d)]
        acc, batch = {}, {}
        zero_counts()
        with _amp_probe(acc, batch):
            run_s, err = _cli(amp_realistic_argv(d, str(d / "real")), dev)
        counts = read_counts()
        _require_launches("amplicon realistic", counts, ("dp_full", "sw_subst"))
        got = amp_record(str(d / "real"), err)
    score = amp_truth_score(got["vcf"], work["truth"], work["target"])
    bad = _amp_diff(got, want["realistic"])
    if bad or json.loads(json.dumps(score)) != want["realistic"]["truth"]:
        raise AssertionError(f"[amplicon] realistic: differs from the JAX CLI's record: {bad}, "
                             f"truth {score} against {want['realistic']['truth']}")
    launched += counts["sw_subst"]
    call = acc.get("call", 0.0)
    pileup = call - acc.get("realign", 0.0) - acc.get("hap variants", 0.0)
    parts = {k: acc.get(k, 0.0) for k in ("bbduk", "decoy engine", "target engine")}
    rest = run_s - sum(parts.values()) - call
    print(f"[amplicon] realistic ({AMP_TARGET_BP} bp target, {AMP_AMPLICONS} amplicons of "
          f"{AMP_AMPLICON_BP} bp, {AMP_VARIANTS} planted variants, {AMP_PAIRS} pairs of 2 x "
          f"{AMP_READ_LEN} bp + {AMP_DECOY_PAIRS} pairs of a {AMP_DECOY_BP} bp decoy): "
          f"build-index target {index_s[0]:.3f} s, decoy {index_s[1]:.3f} s; amplicon "
          f"{run_s:.3f} s = " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f", pileup and calling {pileup:.3f} s, realign_windows_batched "
          f"{acc.get('realign', 0.0):.3f} s (one batch B={batch['B']} R={batch['R']} "
          f"W={batch['W']}, {batch['useful']} useful cells of "
          f"{batch['B'] * batch['R'] * batch['W']} padded, DP {batch['dp_s']:.3f} s on the host "
          f"clock around the synchronized call), _hap_variants {acc.get('hap variants', 0.0):.3f} "
          f"s ({batch['hap_calls']} calls, {batch['hap_launches']} sw_subst launches of B = 1), "
          f"the rest (FASTQ read, index loads, engines' set-up, VCF) {rest:.3f} s [{smi}]")
    print(f"[amplicon] realistic: {got['stderr'][0]}; recall {score['recall']:.4f} "
          f"({score['found']} of {score['truth']}), {score['false_positives']} false positives, "
          f"missing {score['missing']}; the VCF and stderr line equal the JAX CLI's; launches "
          f"{counts} [{smi}]")
    secs = time.perf_counter() - t_phase
    print(f"[amplicon] the amplicon phase took {secs:.1f} s")
    return secs, launched


# ----------------------------------------------------------------------
# phase 17: shard placement and wave rotation (MegaPathPipeline(devices=),
# run --devices N) on one card
# ----------------------------------------------------------------------
# the community's NT shard cap in the rotation's realistic part: 7 of its
# 25 genomes of 400 kbp a shard, 4 shards
ROTATION_SHARD_BP = 2_800_000
ROTATION_SHARDS = 4
ROTATION_BATCH = 20_000


def _count_residency(pipe: MegaPathPipeline) -> dict:
    """After every NT commit, how many NT engines are resident, as
    ``tests/test_shard_rotation.py`` counts them. Returns the dict that
    holds the peak and the number of commits."""
    peak = {"peak": 0, "commits": 0}
    for eng in pipe.nt_engines:
        def counting(eng=eng, orig=eng.commit):
            orig()
            peak["commits"] += 1
            peak["peak"] = max(peak["peak"], sum(e.committed for e in pipe.nt_engines))
        eng.commit = counting
    return peak


def rotation_world(dev: torch.device, smi: str) -> None:
    """Phase 9's world through ``MegaPathPipeline(devices=[dev])``, device
    seeding: the two NT shards rotate in waves of one (peak residency 1,
    counted through commit; nothing resident after), then through
    ``devices=[dev, dev]``: both resident and aligned from the pool. Both
    equal the JAX pipeline's record, with the same launch counts."""
    want = _pipeline_records()["world"]["device_seeding"]
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if pairs_digest(world["pairs"]) != _pipeline_records()["world"]["input_sha256"]:
        raise AssertionError("[rotation] the world's inputs differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    recs = fastq_records(world["pairs"])
    counts_of = {}
    for devices, tag in (([dev], "waves of one"), ([dev, dev], "resident, from the pool")):
        pipe = world_pipeline(world, dev, True, devices=devices)
        waved = len(devices) < len(pipe.nt_engines)
        if pipe._wave_shards != waved or pipe._pool is None:
            raise AssertionError(f"[rotation] world, {tag}: not placed as asked")
        residency = _count_residency(pipe)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.run_records(*recs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        pipe.close()
        counts = counts_of[tag] = read_counts()
        _require_launches("rotation world", counts, ("dp_full", "mmp_seed", "locate"))
        bad = record_diff(pipeline_record(res), want)
        resident = sum(e.committed for e in pipe.nt_engines)
        if waved:
            if residency != {"peak": 1, "commits": 2} or resident:
                bad.append(f"residency {residency}, {resident} resident after the run")
        elif resident != len(pipe.nt_engines):
            bad.append(f"{resident} NT shards resident")
        if bad:
            raise AssertionError(f"[rotation] world, {tag}: {bad}")
        print(f"[rotation] world, devices={[str(d) for d in devices]} ({tag}): "
              f"{len(recs[0])} pairs in {dt:.3f} s; NT residency {residency}, {resident} "
              f"resident after; reports, both LSAM.id digests and the counters equal the JAX "
              f"pipeline's; launches {counts} [{smi}]")
    if len(set(map(str, counts_of.values()))) != 1:
        raise AssertionError(f"[rotation] world: the launch counts differ: {counts_of}")


def rotation_db(dev: torch.device, smi: str, d: Path) -> None:
    """Phase 13's ``build-db`` shards through ``run --devices 1`` from
    gzip FASTQ: the two shards rotate through the card; the reports and
    both LSAM.id files equal the JAX CLI's record."""
    want = _db_records()
    world = world_workload(WORLD_PAIRS_PER_KIND)
    write_db_files(world, d)
    _cli(db_build_argv(d), dev)
    zero_counts()
    run_s, _ = _cli(db_run_argv(d, str(d / "run")) + ["--devices", "1"], dev)
    counts = read_counts()
    _require_launches("rotation db", counts, ("dp_full", "mmp_seed", "locate"))
    got = db_record(d, str(d / "run"))
    bad = [k for k in ("curated_sha256", "shards") if got[k] != want[k]]
    bad += [(k, *text_diff(got["run"][k], want["run"][k])) for k in ("report", "ra_report")
            if got["run"][k] != want["run"][k]]
    bad += [k for k in ("lsam_sha256", "ra_lsam_sha256") if got["run"][k] != want["run"][k]]
    if bad:
        raise AssertionError(f"[rotation] run --devices 1 on build-db's shards: {bad}")
    print(f"[rotation] run --devices 1 on build-db's {DB_SHARDS} shards: {run_s:.3f} s; "
          f"both reports and LSAM.id files equal the JAX CLI's record; launches {counts} "
          f"[{smi}]")


class _RotationProbe:
    """Every NT engine call of a run, timed (each bracketed by
    torch.cuda.synchronize): commit (split into host packing and upload),
    align_pairs, evict; and the card's reserved memory after each evict."""

    def __init__(self):
        self.calls = []  # (kind, seconds) in call order
        self.split = Split()
        self.reserved = []

    @contextlib.contextmanager
    def timing(self):
        orig = {k: getattr(AlignEngine, k) for k in ("commit", "align_pairs", "evict")}

        def timed(kind):
            def run(eng, *a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    return orig[kind](eng, *a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.calls.append((kind, time.perf_counter() - t))
                    if kind == "evict":
                        self.reserved.append(torch.cuda.memory_reserved())
            return run

        for k in orig:
            setattr(AlignEngine, k, timed(k))
        try:
            with _commit_stages(self.split):
                yield
        finally:
            for k, fn in orig.items():
                setattr(AlignEngine, k, fn)

    def batches(self, n_shards: int) -> list:
        """{commit, align, evict} seconds of each batch: a batch commits,
        aligns and evicts every shard once."""
        out, cur, n_ev = [], collections.Counter(), 0
        for kind, sec in self.calls:
            cur[kind] += sec
            if kind == "evict":
                n_ev += 1
                if n_ev % n_shards == 0:
                    out.append(dict(cur))
                    cur = collections.Counter()
        return out


def rotation_realistic(dev: torch.device, smi: str, human, d: Path) -> float:
    """Phase 10's community through ``build-index --shard-bp`` into
    ROTATION_SHARDS NT shards, its 50,000 pairs and phase 7's 20,000 as
    gzip FASTQ; ``run --batch-size 20000 --devices 1`` (4 batches x 4
    shards = 16 commits through one card) and ``run --batch-size 20000``
    (every shard resident) on the same files, no human index. Both runs'
    reports and LSAM.id files must be byte-equal, and their launch counts
    equal. Prints the rotating run's per-batch split (commit, align,
    evict), the commit's host packing and upload, and both runs' card
    peaks (allocated and reserved)."""
    want = _cli_records()["e2e"]
    genomes, pairs = e2e_workload()
    if pairs_digest(pairs) != want["input_sha256"]:
        raise AssertionError("[rotation] the community's reads differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    write_e2e_files(d, genomes, pairs + human)
    build_s, _ = _cli(["build-index", d / "community.fa", d / "nt" / "nt", *E2E_INDEX_ARGS,
                       "--shard-bp", ROTATION_SHARD_BP], dev)
    shards = [d / "nt" / f"shard{i}" for i in range(ROTATION_SHARDS)]
    if sorted((d / "nt").glob("shard*.fm.npz")) != [Path(f"{p}.fm.npz") for p in shards]:
        raise AssertionError(f"[rotation] build-index wrote {sorted((d / 'nt').glob('*'))}")
    n_in = len(pairs) + len(human)
    base = ["run", "-1", d / "r1.fq.gz", "-2", d / "r2.fq.gz", "--nt-index", *shards,
            "--nodes", d / "nodes.dmp", "--names", d / "names.dmp", "--acc2tid",
            d / "acc2tid.map", "-L", "100", "--batch-size", ROTATION_BATCH]
    runs = {}
    for tag, extra in (("rotating", ["--devices", "1"]), ("resident", [])):
        probe = _RotationProbe()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        with probe.timing():
            dt, err = _cli(base + ["-p", d / tag] + extra, dev)
        counts = read_counts()
        _require_launches(f"rotation {tag}", counts, ("dp_full", "mmp_seed", "locate"))
        runs[tag] = dict(s=dt, counts=counts, probe=probe, stages=_stage_seconds(err),
                         peak=torch.cuda.max_memory_allocated(dev),
                         reserved=torch.cuda.max_memory_reserved(dev))
    bad = [suf for suf in (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")
           if (d / f"rotating{suf}").read_bytes() != (d / f"resident{suf}").read_bytes()]
    if runs["rotating"]["counts"] != runs["resident"]["counts"]:
        bad.append(f"launch counts {runs['rotating']['counts']} vs {runs['resident']['counts']}")
    probe = runs["rotating"]["probe"]
    batches = probe.batches(ROTATION_SHARDS)
    n_batches = -(-n_in // ROTATION_BATCH)
    kinds = collections.Counter(k for k, _ in probe.calls)
    if len(batches) != n_batches or kinds["commit"] != n_batches * ROTATION_SHARDS:
        bad.append(f"{len(batches)} batches, calls {dict(kinds)}")
    if bad:
        raise AssertionError(f"[rotation] the rotating and resident runs differ: {bad}")
    sp = probe.split.t
    print(f"[rotation] realistic: build-index of the community into {ROTATION_SHARDS} shards "
          f"(--shard-bp {ROTATION_SHARD_BP}) {build_s:.3f} s; {n_in} pairs x 100 bp as gzip "
          f"FASTQ in {n_batches} batches of up to {ROTATION_BATCH} [{smi}]")
    for tag in ("rotating", "resident"):
        r = runs[tag]
        print(f"[rotation] realistic, run --batch-size {ROTATION_BATCH}"
              f"{' --devices 1' if tag == 'rotating' else ''} ({tag}): {r['s']:.3f} s, "
              f"StageTimer " + ", ".join(f"{k} {v:.2f} s" for k, v in r["stages"].items())
              + f"; NT calls {dict(collections.Counter(k for k, _ in r['probe'].calls))}; "
              f"card peak allocated {r['peak'] / 2**20:.1f} MiB, reserved "
              f"{r['reserved'] / 2**20:.1f} MiB; launches {r['counts']}")
    for i, b in enumerate(batches):
        print(f"[rotation] rotating batch {i}: commit {b.get('commit', 0.0):.3f} s, align "
              f"{b.get('align_pairs', 0.0):.3f} s, evict {b.get('evict', 0.0):.4f} s "
              f"({ROTATION_SHARDS} shards)")
    res = probe.reserved
    print(f"[rotation] the rotating run's {kinds['commit']} commits: host packing "
          f"{sp['pack tables'] + sp['pack words']:.3f} s (tables {sp['pack tables']:.3f}, words "
          f"{sp['pack words']:.3f}; the first batch's only), tables' upload "
          f"{sp['upload tables']:.3f} s; card memory reserved after each evict (MiB) "
          f"{[round(r / 2**20, 1) for r in res]}: after the first batch it "
          f"{'climbs' if max(res) > res[ROTATION_SHARDS - 1] else 'stays flat'}; both runs' "
          f"reports and LSAM.id files byte-equal, launch counts equal [{smi}]")
    return runs["resident"]["s"]


def phase_rotation(dev: torch.device, smi: str, human, d: Path) -> tuple:
    """Shard placement and wave rotation on the card: the world through
    ``devices=`` in waves of one and resident from the pool, build-db's
    shards through ``run --devices 1``, and the realistic rotation of 4
    community shards through one card against the resident run, its files
    under ``d / "e2e"`` (phase 18 reads them). Returns the phase's seconds
    and the resident run's."""
    t_phase = time.perf_counter()
    rotation_world(dev, smi)
    rotation_db(dev, smi, d / "db")
    resident_s = rotation_realistic(dev, smi, human, d / "e2e")
    secs = time.perf_counter() - t_phase
    print(f"[rotation] the rotation phase took {secs:.1f} s [{smi}]")
    return secs, resident_s


# ---------------------------------------------------------------------------
# phase 18: the one-program backend (PipelineConfig.spmd, run --spmd)
# ---------------------------------------------------------------------------
SPMD_REALISTIC_DEVICES = 8  # a 2 x 4 grid of the one card for phase 17's 4 shards


def _sync_calls(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, the synchronizing calls it made as {"file:line": count}, each at
    the innermost frame of the port that made it)."""
    import traceback
    import warnings

    calls = collections.Counter()

    def record(message, *a, **k):
        if "synchroniz" not in str(message).lower():
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "megapath_tpu_torch" in f.filename] or [
            f for f in stack if "warnings" not in f.filename]
        calls[f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, dict(calls)


def _spmd_bytes(pipe: MegaPathPipeline) -> dict:
    """The bytes each shard holds on the card in spmd mode: the grid's
    placement on each of its devices (tables, packed words, sequence
    offsets) and the rescue engine's text codes on its column's first
    device."""
    out = {}
    for (s, dev), placed in pipe._spmd["inputs"].placed.items():
        eng = pipe.nt_engines[s]
        text = eng._ref_dev.numel() if str(eng.device) == dev else 0
        out[s, dev] = dict(tables=placed.dfm.nbytes, words=placed.ref_words.numel() * 4,
                           offsets=placed.seq_off.numel() * 8, text=text,
                           chars=placed.n_text)
    return out


def _print_spmd_bytes(tag: str, pipe: MegaPathPipeline) -> None:
    for (s, dev), b in _spmd_bytes(pipe).items():
        total = b["tables"] + b["words"] + b["offsets"] + b["text"]
        print(f"[spmd] {tag}: shard {s} on {dev} holds {total:,} bytes = "
              f"{total / b['chars']:.3f} a character (tables {b['tables']:,}, packed words "
              f"{b['words']:,}, offsets {b['offsets']:,}, the rescue engine's text "
              f"{b['text']:,})")


def _timed_median(fn, n: int = 3) -> tuple:
    """(median s, all s) of ``n`` synchronized calls of ``fn``."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


def spmd_large(dev: torch.device, smi: str, large, engine_hits, engine_s: float,
               n_timed: int = 3) -> dict:
    """18 (a): phase 7's 512 Mbp shard and its 20,000 pairs through a 1 x 1
    grid under the pipeline's ladder (``_align_shards_spmd``, the exact
    rescue on). The hits must equal the device-seeding engine's and
    LARGE_JAX_HITS. Prints the step's and the backend's median over
    ``n_timed`` synchronized passes beside the engine's pass, the ladder
    level, the stage split (CUDA events), the synchronizing calls of one
    step, the launches of one step, ``dp_fwd`` at the step's deep-DP shape
    beside its plain version and bound, the card peak of one step and the
    payload. Returns the backend run's launch counts and the shard's tables
    on the card (phase 19 (a) reuses them)."""
    ref, fm, (reads1, lens1, reads2, lens2) = large
    n = len(lens1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = PipelineConfig(read_len=100, skip_preprocess=True, skip_human=True,
                         device_seeding=True, spmd=True)
    pipe = MegaPathPipeline([(ref, fm)], mini_taxdb(), config=cfg, devices=[dev], device=dev)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    sp = pipe._spmd
    print(f"[spmd] (a) 512 Mbp, 1 x 1 grid: pipeline built in {place_s:.3f} s (the shard "
          f"packed on the host and put on the card once) [{smi}]")
    _print_spmd_bytes("(a)", pipe)
    args = (reads1, lens1, reads2, lens2, n)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    hits = pipe._align_shards_spmd(*args)[0]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    counts = read_counts()
    tried = list(sp["tried"])
    _require_launches("spmd large", counts, ("dp_fwd", "mmp_seed", "locate"))
    if not np.array_equal(canonical_hits(hits), canonical_hits(engine_hits)) or \
            len(hits) != LARGE_JAX_HITS:
        raise AssertionError(f"[spmd] (a): {len(hits)} hits differ from the device-seeding "
                             f"engine's {len(engine_hits)} (JAX {LARGE_JAX_HITS})")
    level = sp["level"]
    Bl, L, step_args = pipe._spmd_args(*args)
    step = sp["steps"][(Bl, L, level)]

    def one_step(**kw):
        return step(sp["inputs"], *step_args, **kw)

    step_s, step_all = _timed_median(one_step, n_timed)
    backend_s, backend_all = _timed_median(lambda: pipe._align_shards_spmd(*args), n_timed)
    timer = sfull.StageEvents()
    one_step(timer=timer)
    split = timer.seconds()
    zero_counts()
    one_step()
    step_counts = read_counts()
    _, syncs = _sync_calls(one_step)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one_step()
    peak = torch.cuda.max_memory_allocated(dev)
    # dp_fwd at the step's deep-DP shape: the inputs of its first forward pass
    seen = []
    orig = sfull.sw_align_auto
    sfull.sw_align_auto = lambda *a, **k: seen.append((a, k)) or orig(*a, **k)
    try:
        one_step()
    finally:
        sfull.sw_align_auto = orig
    (r, w, rl, wl), kw = seen[0]
    p = kw["params"]
    C, R = r.shape
    W = w.shape[1]
    err = _hold(f"dp_fwd at the spmd deep-DP shape ({C}, {R}, {W})",
                dp_cuda.sw_align_cuda(r, w, rl, wl, p), sw_align(r, w, rl, wl, p), FWD_FIELDS)
    fwd_ms = _median_ms(lambda: dp_cuda.sw_align_cuda(r, w, rl, wl, p))
    plain_ms = _median_ms(lambda: sw_align(r, w, rl, wl, p), reps=3)
    cells, nbytes = dp_work(rl.cpu().numpy(), wl.cpu().numpy(), R, W)
    bound_ms, bound_by = bound(cells, nbytes)
    n_reads = 2 * n
    print(f"[spmd] (a) level {level} (tried {tried}), Bl {Bl}, L {L}; hits {len(hits)} "
          f"== the device-seeding engine's and JAX's {LARGE_JAX_HITS}; first call "
          f"{first_s:.3f} s; launches of the backend's call {counts}")
    print(f"[spmd] (a) the step alone: median {step_s:.4f} s of {n_timed} "
          f"({[round(x, 4) for x in step_all]}) = {n_reads / step_s:.0f} reads/s; the backend "
          f"with the exact rescue: median {backend_s:.4f} s "
          f"({[round(x, 4) for x in backend_all]}); the device-seeding engine's pass "
          f"{engine_s:.4f} s (phase 7) [{smi}]")
    print(f"[spmd] (a) one step's stages (CUDA events): " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in split.items())
        + f"; sum {sum(split.values()) * 1e3:.3f} ms")
    print(f"[spmd] (a) one step: launches {step_counts}; {sum(syncs.values())} synchronizing "
          f"calls {syncs}; card memory {resident / 2**30:.3f} GiB resident before it, peak "
          f"{peak / 2**30:.3f} GiB (+{(peak - resident) / 2**30:.3f}) [{smi}]")
    print(f"[spmd] (a) dp_fwd at the step's deep-DP shape ({C}, {R}, {W}): {fwd_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, max |err| {err}; {cells:,} cells, {_share(fwd_ms, bound_ms)} "
          f"({bound_by}) [{smi}]")
    print(f"[spmd] (a) payload {sp['payload']}")
    return counts, sp["inputs"].cells[0][0].dfm


def spmd_world(dev: torch.device, smi: str) -> dict:
    """18 (b): phase 9's world (two NT shards, hg, ribo) through
    ``MegaPathPipeline(config.spmd=True, devices=[dev] * 4)``, a 2 x 2 grid;
    equal to the JAX pipeline's record; each NT shard on the card once."""
    want = _pipeline_records()["world"]
    world = world_workload(WORLD_PAIRS_PER_KIND)
    if pairs_digest(world["pairs"]) != want["input_sha256"]:
        raise AssertionError("[spmd] the world's inputs differ from the fixture's: "
                             "numpy's generator drifted, this is not a port fault")
    recs = fastq_records(world["pairs"])
    pipe = world_pipeline(world, dev, True, devices=[dev] * 4, spmd=True)
    placed = pipe._spmd["inputs"].placed
    if pipe._spmd["mesh"].shape != {"data": 2, "shard": 2} or len(placed) != 2:
        raise AssertionError(f"[spmd] world: grid {pipe._spmd['mesh'].shape}, "
                             f"placements {list(placed)}")
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pipe.run_records(*recs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = read_counts()
    _require_launches("spmd world", counts, ("dp_fwd", "mmp_seed", "locate", "dp_full"))
    bad = record_diff(pipeline_record(res), want["device_seeding"])
    if bad:
        raise AssertionError(f"[spmd] world: differs from the JAX pipeline's record: {bad}")
    print(f"[spmd] (b) world on a 2 x 2 grid of {dev}: {len(recs[0])} pairs in {dt:.3f} s, level "
          f"{pipe._spmd['level']}; reports, both LSAM.id digests and the counters equal the JAX "
          f"pipeline's; each NT shard placed once ({sorted(placed)}); launches {counts} [{smi}]")
    return counts


def spmd_realistic(dev: torch.device, smi: str, d: Path, resident_s: float) -> dict:
    """18 (c): phase 17's files and 4 shards (in ``d``) through
    ``run_files`` with ``spmd=True, devices=[dev] * 8`` (a 2 x 4 grid) at
    batch ROTATION_BATCH, the configuration ``run`` builds from phase 17's
    argv; the reports and LSAM.id files byte-equal to phase 17's resident
    run. Prints each batch's ladder level and seconds, the run's time
    beside the resident run's, and the card peak."""
    from megapath_tpu_torch import cli

    shards = [cli.load_shard(str(d / "nt" / f"shard{i}")) for i in range(ROTATION_SHARDS)]
    db = TaxDB()
    db.read_nodes(d / "nodes.dmp")
    db.read_names(d / "names.dmp")
    db.read_acc2tid(d / "acc2tid.map")
    cfg = PipelineConfig(read_len=100, skip_human=True, device_seeding=True,
                         batch_size=ROTATION_BATCH, spmd=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    pipe = MegaPathPipeline(shards, db, config=cfg, devices=[dev] * SPMD_REALISTIC_DEVICES,
                            device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    batches = []
    orig = pipe._align_shards_spmd

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a)
        torch.cuda.synchronize()
        batches.append((a[-1], pipe._spmd["level"], list(pipe._spmd["tried"]),
                        time.perf_counter() - t))
        pipe._spmd["tried"].clear()
        return out

    pipe._align_shards_spmd = timed
    zero_counts()
    t = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        pipe.run_files(d / "r1.fq.gz", d / "r2.fq.gz", str(d / "spmd"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = read_counts()
    _require_launches("spmd realistic", counts, ("dp_fwd", "mmp_seed", "locate"))
    bad = [suf for suf in (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")
           if (d / f"spmd{suf}").read_bytes() != (d / f"resident{suf}").read_bytes()]
    if bad:
        raise AssertionError(f"[spmd] (c): differs from phase 17's resident run: {bad}")
    print(f"[spmd] (c) realistic, 4 shards on a {pipe._spmd['mesh'].shape} grid of {dev}: "
          f"pipeline built in {build_s:.3f} s; run_files {run_s:.3f} s against the resident "
          f"run's {resident_s:.3f} s (phase 17, from the CLI); reports and LSAM.id files "
          f"byte-equal to it; card peak {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB "
          f"allocated, {torch.cuda.max_memory_reserved(dev) / 2**20:.1f} reserved; launches "
          f"{counts} [{smi}]")
    for i, (n, level, tried, s) in enumerate(batches):
        print(f"[spmd] (c) batch {i}: {n} pairs after bbduk, level {level} (tried {tried}), "
              f"stage 2 {s:.3f} s")
    _print_spmd_bytes("(c)", pipe)
    return counts


def spmd_cli(dev: torch.device, smi: str, d: Path) -> dict:
    """18 (d): ``run --spmd --nt-index shard0`` over phase 17's files, byte-equal to the
    same ``run`` without ``--spmd``; then ``run --spmd`` over 4 shards on the
    one card, refused before any index is read."""
    from megapath_tpu_torch import cli

    base = ["run", "-1", d / "r1.fq.gz", "-2", d / "r2.fq.gz", "--nt-index",
            d / "nt" / "shard0", "--nodes", d / "nodes.dmp", "--names", d / "names.dmp",
            "--acc2tid", d / "acc2tid.map", "-L", "100", "--batch-size", ROTATION_BATCH]
    zero_counts()
    spmd_s, _ = _cli(base + ["-p", d / "cli_spmd", "--spmd"], dev)
    counts = read_counts()
    _require_launches("spmd cli", counts, ("dp_fwd", "mmp_seed", "locate"))
    plain_s, _ = _cli(base + ["-p", d / "cli_plain"], dev)
    bad = [suf for suf in (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")
           if (d / f"cli_spmd{suf}").read_bytes() != (d / f"cli_plain{suf}").read_bytes()]
    if bad:
        raise AssertionError(f"[spmd] (d): run --spmd differs from run: {bad}")
    loads = []
    orig = cli.load_shard
    cli.load_shard = lambda prefix: loads.append(prefix) or orig(prefix)
    four = [d / "nt" / f"shard{i}" for i in range(ROTATION_SHARDS)]
    argv = base[:6] + four + base[7:] + ["-p", d / "refused", "--spmd", "--device", str(dev)]
    try:
        cli.main([str(a) for a in argv])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("[spmd] (d): run --spmd over 4 shards on one card ran")
    finally:
        cli.load_shard = orig
    if loads or "spmd backend needs >= 4 devices for 4 shards" not in refusal:
        raise AssertionError(f"[spmd] (d): refusal {refusal!r} after loading {loads}")
    print(f"[spmd] (d) run --spmd --nt-index shard0: {spmd_s:.3f} s, byte-equal to run "
          f"({plain_s:.3f} s); launches {counts}; 4 shards on one card refused before any "
          f"index was read: {refusal} [{smi}]")
    return counts


def phase_spmd(dev: torch.device, smi: str, d: Path, resident_s: float) -> tuple:
    """18 (b)-(d); (a) runs after phase 7, while its shard is loaded.
    Returns the seconds of (b)-(d) and their dp_fwd launches."""
    t = time.perf_counter()
    counts = [spmd_world(dev, smi), spmd_realistic(dev, smi, d, resident_s),
              spmd_cli(dev, smi, d)]
    secs = time.perf_counter() - t
    print(f"[spmd] (b)-(d) took {secs:.1f} s [{smi}]")
    return secs, sum(c["dp_fwd"] for c in counts)


# ---------------------------------------------------------------------------
# phase 19: the reduced one-program step (parallel/spmd.py) and the
# candidate-position step (parallel/dist.py)
# ---------------------------------------------------------------------------
REDUCED_CPU_PAIRS = 1000  # (a): the reduced step's rows held to a CPU grid's
DIST_CPU_ROWS = 4096  # (a): dist's rows held to a CPU grid's
DIST_WIDTH = 192


def _small_records() -> dict:
    return json.loads((FIX / "torch_spmd_records.json").read_text())["small"]


def _winner_counts(out, rows: int, n_species: int) -> np.ndarray:
    """The winner-species histogram of an output's first ``rows`` rows."""
    best = out.best_score[:rows]
    sp = out.all_species[:rows][np.arange(rows), np.maximum(out.best_shard[:rows], 0)]
    return np.bincount(sp[best > 0], minlength=n_species)[:n_species].astype(np.int32)


def _rows_diff(tag: str, got, want, n_species: int) -> None:
    """Every field of ``want`` (a run over the first rows of ``got``'s
    batch) equals ``got``'s rows; its histogram, the one of those rows."""
    rows = len(want.best_score)
    bad = [f for f in got._fields if f != "species_counts" and not np.array_equal(
        getattr(got, f)[:rows], getattr(want, f))]
    if not np.array_equal(want.species_counts, _winner_counts(got, rows, n_species)):
        bad.append("species_counts")
    if bad:
        raise AssertionError(f"[reduced] {tag}: the card's first {rows} rows differ from the "
                             f"CPU grid's in {bad}")


def reduced_large(dev: torch.device, smi: str, large, dfm, engine_hits) -> dict:
    """19 (a): phase 7's 512 Mbp shard and its 20,000 pairs through the
    reduced step on a 1 x 1 grid, the tables those of phase 18 (a)'s
    placement (``dfm``, on the card): a warm-up (its launches), the median
    of 3; the first REDUCED_CPU_PAIRS pairs' rows equal the same step on a
    CPU grid of the same tables (the card's ``DeviceFM`` fields copied back,
    the plain walk, locate and DP); the pairs with a hit beside phase 7's
    engine's paired pairs; ``dp_fwd`` at the step's DP shape beside its
    plain version and bound. Then ``build_dist_align_step`` on the shard's
    20,000 r1 reads at phase 7's first forward r1 hit of each pair less the
    margin (a seeded random start without one), width DIST_WIDTH, on the
    card's copy of the text: a warm-up, the median of 3, its first
    DIST_CPU_ROWS rows equal a CPU grid's. Returns the launch counts of the
    two warm-up calls."""
    from megapath_tpu_torch.parallel import dist, spmd

    ref, _, (reads1, lens1, reads2, lens2) = large
    n = len(lens1)
    params = AlignParams()
    M = len(ref.offsets) - 1
    species = np.arange(M, dtype=np.int32)[None]
    sfm, meta = spmd.stack_fms([dfm])
    mesh = spmd.make_mesh_for([dev], n_shards=1)
    t = time.perf_counter()
    inputs = spmd.place_spmd_inputs(mesh, sfm, ref_codes=ref.codes[None], true_n=[len(ref.codes)],
                                    seq_offsets=ref.offsets[None], seq_species=species)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t
    step = spmd.build_spmd_engine_step(mesh, meta, 100, M, params=params)
    args = (reads1, reads2, lens1, lens2)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = step(inputs, *args)
    first_s = time.perf_counter() - t
    counts = read_counts()
    _require_launches("reduced large", counts, ("dp_fwd", "mmp_seed", "locate"))
    step_s, step_all = _timed_median(lambda: step(inputs, *args))

    # the same tables on a CPU grid: the card's DeviceFM copied back
    cpu = torch.device("cpu")
    t = time.perf_counter()
    cmesh = spmd.make_mesh_for([cpu], n_shards=1)
    cinputs = spmd.place_spmd_inputs(cmesh, sfm, ref_codes=ref.codes[None],
                                     true_n=[len(ref.codes)], seq_offsets=ref.offsets[None],
                                     seq_species=species)
    k = REDUCED_CPU_PAIRS
    want = spmd.build_spmd_engine_step(cmesh, meta, 100, M, params=params)(
        cinputs, *(a[:k] for a in args))
    cpu_s = time.perf_counter() - t
    _rows_diff("reduced step", out, want, M)
    paired = len(np.unique(engine_hits.read[engine_hits.paired]))
    print(f"[reduced] (a) 512 Mbp, 1 x 1 grid, {n} pairs x 100 bp, max_seeds 6: tables "
          f"placed in {place_s:.3f} s (phase 18 (a)'s, the text uploaded); first call "
          f"{first_s:.4f} s, median of 3 {step_s:.4f} s ({[round(x, 4) for x in step_all]}) = "
          f"{2 * n / step_s:.0f} reads/s; launches {counts} [{smi}]")
    print(f"[reduced] (a) pairs with best_score > 0: {int((out.best_score > 0).sum())} of {n} "
          f"(phase 7's engine paired {paired}); the first {k} pairs' rows equal the CPU grid's "
          f"(plain walk, locate, DP; tables copied back) in every field; the CPU run with its "
          f"placement {cpu_s:.2f} s on the card's host")

    # dp_fwd at the step's DP shape: the inputs of its one DP call
    seen = []
    orig = spmd.sw_align_auto
    spmd.sw_align_auto = lambda *a, **kw: seen.append((a, kw)) or orig(*a, **kw)
    try:
        step(inputs, *args)
    finally:
        spmd.sw_align_auto = orig
    (r, w, rl, wl), kw = seen[0]
    p = kw["params"]
    C, R = r.shape
    W = w.shape[1]
    err = _hold(f"dp_fwd at the reduced step's DP shape ({C}, {R}, {W})",
                dp_cuda.sw_align_cuda(r, w, rl, wl, p), sw_align(r, w, rl, wl, p), FWD_FIELDS)
    fwd_ms = _median_ms(lambda: dp_cuda.sw_align_cuda(r, w, rl, wl, p))
    plain_ms = _median_ms(lambda: sw_align(r, w, rl, wl, p), reps=3)
    cells, nbytes = dp_work(rl.cpu().numpy(), wl.cpu().numpy(), R, W)
    bound_ms, bound_by = bound(cells, nbytes)
    print(f"[reduced] (a) dp_fwd at the step's DP shape ({C}, {R}, {W}): {fwd_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, max |err| {err}; {cells:,} cells, {_share(fwd_ms, bound_ms)} "
          f"({bound_by}) [{smi}]")

    # dist at phase 7's hits: each pair's first forward r1 hit, less the margin
    margin = params.margin(100)
    cand = np.random.default_rng(19).integers(0, len(ref.codes) - DIST_WIDTH, n)
    h = engine_hits
    fwd = np.flatnonzero((h.end == 0) & (h.strand == 0))
    first = np.unique(h.read[fwd], return_index=True)
    cand[first[0]] = h.start[fwd[first[1]]] - margin
    cand = cand.astype(np.int32)[:, None]
    dmesh = dist.make_mesh(1, devices=[dev])
    dinputs = dist.shard_arrays(dmesh, ref_shards=inputs.cells[0][0].text[None],
                                seq_offsets=ref.offsets[None], seq_species=species)
    dstep = dist.build_dist_align_step(dmesh, DIST_WIDTH, M)
    dargs = (reads1, lens1, cand)
    zero_counts()
    dout = dstep(dinputs, *dargs)
    dcounts = read_counts()
    _require_launches("dist large", dcounts, ("dp_fwd",))
    dist_s, dist_all = _timed_median(lambda: dstep(dinputs, *dargs))
    cmesh = dist.make_mesh(1, devices=[cpu])
    k = DIST_CPU_ROWS
    dwant = dist.build_dist_align_step(cmesh, DIST_WIDTH, M)(
        dist.shard_arrays(cmesh, ref_shards=ref.codes[None], seq_offsets=ref.offsets[None],
                          seq_species=species), *(a[:k] for a in dargs))
    _rows_diff("dist step", dout, dwant, M)
    print(f"[reduced] (a) dist on the 512 Mbp shard: {n} r1 reads at {len(first[0])} pairs' "
          f"first forward r1 hit less {margin} (the rest at seeded random starts), width "
          f"{DIST_WIDTH}: first call launches {dcounts}; median of 3 {dist_s:.4f} s "
          f"({[round(x, 4) for x in dist_all]}); hits {int((dout.best_score > 0).sum())}; the "
          f"first {k} rows equal the CPU grid's in every field [{smi}]")
    return {key: counts[key] + dcounts[key] for key in counts}


def reduced_small(dev: torch.device, smi: str) -> dict:
    """19 (b): the small worlds on 2 x 2 grids of the card (``[dev] * 4``),
    their FM indexes built on the card: the reduced step on the planted
    batch (and ``spmd_report``'s bytes) and on the edge world's, ``dist`` on
    its world; every field equal to the JAX record
    (``tests/fixtures/torch_spmd_records.json``). Returns their launches."""
    from megapath_tpu_torch.parallel import dist, spmd

    want = _small_records()
    if small_worlds_digest() != want["input_sha256"]:
        raise AssertionError("[reduced] the small worlds differ from the fixture's: numpy's "
                             "generator drifted, this is not a port fault")
    world = small_spmd_world()
    edge_world, edge_batch = small_spmd_edge(world)
    mesh = spmd.make_mesh_for([dev] * 4)
    total = collections.Counter()
    t = time.perf_counter()
    for tag, w, (r1, r2, lens) in (("planted", world, small_spmd_planted(world)),
                                   ("edge", edge_world, edge_batch)):
        fms, padded, true_n = spmd.pad_and_index_shards(
            w["codes"], sa_interval=SPMD_SA_INTERVAL, lut_k=8, device=dev)
        sfm, meta = spmd.stack_fms(fms)
        inputs = spmd.place_spmd_inputs(mesh, sfm, ref_codes=padded, true_n=true_n,
                                        seq_offsets=w["seq_offsets"],
                                        seq_species=w["seq_species"])
        step = spmd.build_spmd_engine_step(mesh, meta, SPMD_L, w["n_species"],
                                           params=AlignParams(**SPMD_PARAMS))
        zero_counts()
        out = step(inputs, r1, r2, lens, lens)
        counts = read_counts()
        _require_launches(f"reduced {tag}", counts, ("dp_fwd", "mmp_seed", "locate"))
        total.update(counts)
        rec = dict(out_record(out))
        if tag == "planted":
            rec["report"] = spmd.spmd_report(out, SPMD_TIDS, mini_taxdb(), lens, lens)
        bad = [f for f in want["spmd"][tag] if rec[f] != want["spmd"][tag][f]]
        if bad:
            raise AssertionError(f"[reduced] (b) {tag}: differs from the JAX record in {bad}")
    w = small_dist_world()
    dmesh = dist.make_mesh(4, devices=[dev] * 4)
    keys = ("ref_shards", "seq_offsets", "seq_species")
    dstep = dist.build_dist_align_step(dmesh, w["width"], w["n_species"])
    zero_counts()
    dout = dstep(dist.shard_arrays(dmesh, **{k: w[k] for k in keys}), w["reads"],
                 w["read_lens"], w["cand_pos"])
    counts = read_counts()
    _require_launches("dist small", counts, ("dp_fwd",))
    total.update(counts)
    got = out_record(dout)
    bad = [f for f in want["dist"] if got[f] != want["dist"][f]]
    if bad:
        raise AssertionError(f"[reduced] (b) dist: differs from the JAX record in {bad}")
    print(f"[reduced] (b) the small worlds on 2 x 2 grids of {dev} (indexes built on the card): "
          f"the reduced step on the planted and the edge batch (the float32 kept edge, the "
          f"lowest-shard tie) with spmd_report's bytes, and dist (its highest-shard tie, the "
          f"unmasked best_shard) equal the JAX record in every field, {time.perf_counter() - t:.3f}"
          f" s; launches {dict(total)} [{smi}]")
    return dict(total)


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    lat = load_latency(dev, smi)
    toy = make_toy(dev)
    phase_index(dev, toy)
    timing = kernels_dp(dev, smi)
    timing.update(kernels_subst(dev, smi))
    timing.update(kernels_dna(dev, smi))
    timing.update(kernels_seeding(dev, smi, toy, lat))
    phase_golden(dev)
    launches = {"dp_fwd": phase_step(dev)}
    phase_slice(dev, smi, toy)
    del toy
    large, large_hits, engine_s = phase_large(dev, smi, lat)
    t = time.perf_counter()
    counts, large_dfm = spmd_large(dev, smi, large, large_hits, engine_s)
    launches["dp_fwd"] += counts["dp_fwd"]
    spmd_a_s = time.perf_counter() - t
    t = time.perf_counter()
    reduced = collections.Counter(reduced_large(dev, smi, large, large_dfm, large_hits))
    reduced.update(reduced_small(dev, smi))
    reduced_s = time.perf_counter() - t
    print(f"[reduced] phase 19 took {reduced_s:.1f} s; launches {dict(reduced)} [{smi}]")
    del large_hits, large_dfm
    phase_pipeline_cascade(dev)
    phase_pipeline_world(dev, smi)
    counts = phase_pipeline_large(dev, smi, large)
    launches.update({k: counts[k] for k in ("dp_full", "mmp_seed", "locate")})
    for k in ("dp_fwd", "mmp_seed", "locate"):
        launches[k] += reduced[k]
    phase_cli(dev, smi, large)
    human = human_pairs(*large[2])
    del large
    shard_s = phase_shard(dev, smi, lat)
    db_s = phase_db(dev, smi)
    asm_s, asm_subst = phase_asm(dev, smi)
    prot_s, prot_subst = phase_protein(dev, smi)
    launches["sw_subst"] = asm_subst + prot_subst
    amp_s, launches["sw_dna"] = phase_amplicon(dev, smi)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        rot_s, resident_s = phase_rotation(dev, smi, human, d)
        spmd_s, spmd_fwd = phase_spmd(dev, smi, d / "e2e", resident_s)
    launches["dp_fwd"] += spmd_fwd
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"(the default-shard phase {shard_s:.1f} s, the db phase {db_s:.1f} s, the "
          f"assembly phase {asm_s:.1f} s, the protein phase {prot_s:.1f} s, the amplicon "
          f"phase {amp_s:.1f} s, the rotation phase {rot_s:.1f} s, the spmd phase "
          f"{spmd_a_s + spmd_s:.1f} s, the reduced-step phase {reduced_s:.1f} s) [{smi}]")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[SERVED_BY.get(name, name)],
         **{k: timing[SERVED_BY.get(name, name)][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
