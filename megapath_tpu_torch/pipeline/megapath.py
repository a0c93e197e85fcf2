"""End-to-end MegaPath pipeline (the runMegaPath.sh equivalent).

The port of ``megapath_tpu/pipeline/megapath.py`` onto the port's
engines: preprocess (bbduk) -> human filter -> optional ribosome filter ->
NT alignment over the shards, one after another -> SPIKE coverage filter
-> taxid lookup -> reassignment -> Kraken-style reports. Every engine is
the port's ``AlignEngine`` on one explicit torch device, so on a card the
hg, ribo and NT stages run the port's kernels (the seed walk, the SA
locate and the DP). Everything after the engines is host code in both
packages and stays on the host here.

Stage semantics follow the reference's runMegaPath.sh:105-265; the
inter-stage LSAM text round-trips are internalized. The reports and the
LSAM lines are byte-identical to the JAX pipeline's
(``tests/test_torch_pipeline.py``). ``PipelineConfig.bam`` adds the BAM
sink to ``run_files``: per-shard sorted BAMs and the merged
``PREFIX.nt.bam`` (soap4 -b + samtools, runMegaPath.sh:199-216), whose
content equals the JAX pipeline's (``tests/test_torch_cli.py``).
``run_files(assembly=True)`` adds stage 4 (runMegaPath.sh -A): the viral
and unmapped pairs through bbnorm and the multi-k assembler (or
``megahit_bin``) on the host, the contigs indexed and the reads aligned
back on the pipeline's device, ``PREFIX.contigs.fa`` and
``PREFIX.r2c.lsam`` byte-identical to the JAX pipeline's
(``tests/test_torch_cli_asm.py``); with ``protein_db=`` also stage 4.1,
the protein remap (blastx, its DP on the pipeline's device), writing
``PREFIX.nr.lsam.id``, ``PREFIX.nt.unmap.r2g.lsam.id`` and
``PREFIX.nr.report`` byte-identical to the JAX pipeline's
(``tests/test_torch_cli_protein.py``).

Left out, and refused with NotImplementedError naming the ROADMAP item
that ports them: the one-program SPMD backend (``PipelineConfig.spmd``)
and multi-device shard placement (``devices=``, A10).
"""

from __future__ import annotations

import contextlib
import glob
import os
import queue
import shutil
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from megapath_tpu_torch.align.engine import AlignEngine, BatchHits
from megapath_tpu_torch.align.output import best_per_seq_arrays
from megapath_tpu_torch.align.params import AlignParams, MmpParams
from megapath_tpu_torch.classify.reassign import Reassigner
from megapath_tpu_torch.filters.bbduk import KmerRef, bbduk_pair_arrays
from megapath_tpu_torch.filters.spike import spike_read_filter
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import PackedReference, pack_reads
from megapath_tpu_torch.io.bam import merge_shard_bams, sort_sam_lines, write_bam
from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx, trim_readno
from megapath_tpu_torch.io.lsam import LsamRecord, read_lsam
from megapath_tpu_torch.io.sam import hits_to_sam, sam_header
from megapath_tpu_torch.io.stream import stream_read_pairs
from megapath_tpu_torch.pipeline.assembly import (
    assembly_path,
    extract_viral_and_unmapped,
    protein_remap,
)
from megapath_tpu_torch.taxonomy.report import KrakenReport
from megapath_tpu_torch.taxonomy.taxdb import TaxDB, get_correct_acc, remove_version
from megapath_tpu_torch.utils.timing import StageTimer

HG_PARAMS = AlignParams(mmp=MmpParams(seed_min_length=22, reseed_len=23))
NT_PARAMS = AlignParams()

Shard = Tuple[PackedReference, FMIndex]


class PipelineAbort(RuntimeError):
    """A stage produced no output: fail the run loudly instead of
    emitting an empty report (runMegaPath.sh:143-146 aborts when the
    host-filter output file is empty)."""


@dataclass
class PipelineConfig:
    read_len: int = 150
    min_len: int = 50
    entropy: float = 0.75
    nt_cutoff: int = 40
    spike_stdev: int = 60
    spike_overlap: float = 0.5
    top_percentage: float = 0.95
    skip_preprocess: bool = False
    skip_human: bool = False
    device_seeding: bool = False
    max_read_len: int = 512
    # streaming batch size for run_files (the reference aligns
    # ~2M-read batches through a double-buffered reader, SOAP4.cpp:206)
    batch_size: int = 500_000
    # ribosome filter (-S): extract threshold 0.95 * pair length
    # (runMegaPath.sh:162, extractFromLSAM.pl fractional -t)
    ribo_cutoff: float = 0.95
    # run_files also writes per-shard BAMs + the merged, sorted
    # PREFIX.nt.bam (soap4 -b + samtools, runMegaPath.sh:199-216)
    bam: bool = False
    # the reference package's one-program SPMD backend for stage 2:
    # refused until ROADMAP A10
    spmd: bool = False
    # reference-exact results (AlignEngine.exact_rescue): pairs that
    # end with a zero-hit end re-run through the undialed walk, making
    # every stage's hits byte-exact vs the reference at ~dialed speed
    # on matching-heavy streams (junk-heavy streams auto-switch to the
    # direct exact walk). Disable to trade the measured dial misses
    # (align/params.py) for throughput on junk-heavy cascades.
    exact: bool = True

    @property
    def hg_cutoff(self) -> int:
        return self.read_len * 3 // 5  # runMegaPath.sh:78


class LazyRecords:
    """List-like view that materializes LSAM records on first access.

    run_records callers that only read the reports (the common batch
    loop; the bench) skip the record-object build entirely — the
    reference equivalent is that lsam.gz is only *written*, never
    re-parsed, on the happy path (runMegaPath.sh:208)."""

    def __init__(self, thunk):
        self._thunk = thunk
        self._items: Optional[List[LsamRecord]] = None

    def _force(self) -> List[LsamRecord]:
        if self._items is None:
            self._items = self._thunk()
            self._thunk = None
        return self._items

    def __iter__(self):
        return iter(self._force())

    def __len__(self) -> int:
        return len(self._force())

    def __getitem__(self, i):
        return self._force()[i]


@dataclass
class PipelineResult:
    report: str
    ra_report: str
    lsam_id: List[LsamRecord]
    ra_lsam_id: List[LsamRecord]
    n_input_pairs: int = 0
    n_after_preprocess: int = 0
    n_after_human: int = 0
    spike_removed: int = 0
    n_after_ribo: int = 0


class MegaPathPipeline:
    def __init__(
        self,
        nt_shards: Sequence[Shard],
        taxdb: TaxDB,
        hg_shard: Optional[Shard] = None,
        adapters: Optional[KmerRef] = None,
        config: Optional[PipelineConfig] = None,
        ribo_shard: Optional[Shard] = None,
        devices: Optional[Sequence] = None,
        *,
        device: torch.device,
        timer: Optional[StageTimer] = None,
    ):
        """Every engine (hg, ribo, each NT shard) is the port's
        ``AlignEngine`` on ``device``, its shard committed there once.
        ``timer``, when given, records the stages of ``run_records``
        (bbduk, hg, ribo, nt, tail) on the host clock."""
        self.cfg = config or PipelineConfig()
        if devices is not None:
            raise NotImplementedError(
                "devices=: multi-device shard placement and wave rotation "
                "are ROADMAP A10; the port runs every engine on one device"
            )
        if self.cfg.spmd:
            raise NotImplementedError(
                "PipelineConfig.spmd: the one-program SPMD backend is ROADMAP A10"
            )
        self.taxdb = taxdb
        self.adapters = adapters
        self.device = torch.device(device)
        self.timer = timer
        nt_params = NT_PARAMS.with_(top_percentage=self.cfg.top_percentage)
        self.nt_engines = [self._engine(ref, fm, nt_params) for ref, fm in nt_shards]
        self.hg_engine = (
            self._engine(hg_shard[0], hg_shard[1], HG_PARAMS)
            if hg_shard is not None
            else None
        )
        # ribosome filter stage (-S): soap4 vs SILVA with -P -top 100
        # (runMegaPath.sh:155-169); pair-required scoring, no retention
        self.ribo_engine = (
            self._engine(
                ribo_shard[0], ribo_shard[1],
                HG_PARAMS.with_(megapath_mode=2, top_percentage=1.0),
            )
            if ribo_shard is not None
            else None
        )
        # per-shard seq -> species taxid (and superkingdom), vectorized
        # lookup tables for the array merge path (-1 = unknown acc)
        self._species_of: List[np.ndarray] = []
        self._sk_of: List[np.ndarray] = []
        for ref, _ in nt_shards:
            sp = np.full(len(ref.names), -1, dtype=np.int64)
            sk = np.zeros(len(ref.names), dtype=np.int64)
            for j, name in enumerate(ref.names):
                acc = remove_version(get_correct_acc(name))
                tid = taxdb.acc2tid.get(acc)
                if tid is not None:
                    sp[j] = taxdb.pop_to_species(tid)
                    sk[j] = taxdb.superkingdom_of(tid)
            self._species_of.append(sp)
            self._sk_of.append(sk)

    def _engine(
        self, ref: PackedReference, fm: FMIndex, params: AlignParams
    ) -> AlignEngine:
        eng = AlignEngine(ref, fm, params, device=self.device,
                          device_seeding=self.cfg.device_seeding)
        eng.exact_rescue = self.cfg.exact
        return eng

    def _stage(self, name: str):
        return self.timer.stage(name) if self.timer is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def run_files(
        self,
        r1_path,
        r2_path,
        out_prefix: str,
        batch_size: Optional[int] = None,
        assembly: bool = False,
        megahit_bin: Optional[str] = None,
        protein_db=None,
    ) -> PipelineResult:
        """Streaming file pipeline (the runMegaPath.sh equivalent).

        Reads flow through ``io.stream`` in ~batch_size-pair batches on
        a prefetching reader thread (the aio_thread.cpp double buffer,
        SOAP4.cpp:445); per-batch LSAM.id lines stream to disk, only
        numeric accumulators (merged hit rows, per-shard coverage
        intervals) stay in memory, so RSS is bounded by the batch size
        rather than the input. Per-stage ``.done`` markers + a saved
        align-state snapshot give stage-level resume like the
        reference's gates (runMegaPath.sh:109-246).
        """
        cfg = self.cfg
        bs = batch_size or cfg.batch_size
        raw_lsam = out_prefix + ".nt.raw.lsam.id"
        state_p = out_prefix + ".align_state.npz"
        timer = StageTimer()

        # ---- stage A: stream align (bbduk -> hg -> ribo -> NT) -------
        if os.path.exists(out_prefix + ".align.done"):
            print(f"Skipping alignment: {out_prefix}.align.done", file=sys.stderr)
            st = np.load(state_p, allow_pickle=False)
            rows = tuple(st[k] for k in ("read", "end", "sp", "sk", "score"))
            best = st["best"]
            counters = st["counters"]
            spike_parts = [
                (st[f"spk{si}_read"], st[f"spk{si}_seq"],
                 st[f"spk{si}_start"], st[f"spk{si}_stop"])
                for si in range(len(self.nt_engines))
            ]
        else:
            acc_rows: List[Tuple[np.ndarray, ...]] = []
            acc_best: List[np.ndarray] = []
            spike_acc: List[List[Tuple[np.ndarray, ...]]] = [
                [] for _ in self.nt_engines
            ]
            counters = np.zeros(4, dtype=np.int64)  # in, pre, hg, ribo
            base = 0

            # ---- per-batch resume journal -----------------------------
            # Each completed batch appends one npz under .align_batches/;
            # a killed run replays the journal (cheap array loads), skips
            # that many parsed batches, truncates the raw LSAM to the
            # last recorded byte offset, and realigns only the rest —
            # the reference gates whole stages (runMegaPath.sh:109-246);
            # this is the finer per-batch version of that contract.
            bdir = out_prefix + ".align_batches"
            os.makedirs(bdir, exist_ok=True)
            n_done = 0
            lsam_off = 0
            while True:
                bp = os.path.join(bdir, f"batch{n_done:06d}.npz")
                if not os.path.exists(bp):
                    break
                z = np.load(bp, allow_pickle=False)
                acc_rows.append(tuple(
                    z[k] for k in ("read", "end", "sp", "sk", "score")
                ))
                acc_best.append(z["best"])
                for si in range(len(self.nt_engines)):
                    if len(z[f"spk{si}_read"]):
                        spike_acc[si].append(tuple(
                            z[f"spk{si}_{k}"]
                            for k in ("read", "seq", "start", "stop")
                        ))
                counters += z["counters"]
                base = int(z["base_after"])
                lsam_off = int(z["lsam_off_after"])
                n_done += 1
            if n_done:
                print(
                    f"[stream] resuming after {n_done} journaled batches "
                    f"({base} pairs)", file=sys.stderr,
                )
                with open(raw_lsam, "a") as f:
                    f.truncate(lsam_off)
            else:
                open(raw_lsam, "w").close()

            # writer thread: LSAM record build + journal write of batch
            # i overlap the align of batch i+1 (the output-thread half
            # of soap4's MultiThreadDelegator)
            wq: "queue.Queue" = queue.Queue(maxsize=2)
            werr: List[BaseException] = []

            def _writer():
                nonlocal lsam_off
                with open(raw_lsam, "r+" if n_done else "w") as lsam_out:
                    lsam_out.seek(lsam_off)
                    lsam_out.truncate()
                    while True:
                        item = wq.get()
                        if item is None:
                            return
                        try:
                            (bi, recs1, recs2, best_b, brows, bspk,
                             bcounters, base_before, base_after,
                             bsam) = item
                            for rec in self._build_lsam_records(
                                recs1, recs2,
                                np.ones(base_after - base_before, bool),
                                best_b, *brows,
                            ):
                                lsam_out.write(rec.to_line() + "\n")
                            lsam_out.flush()
                            if bsam is not None:
                                # per-(shard, batch) SAM line files; the
                                # BAM finalize sorts + merges them after
                                # the align stage (samtools merge/sort,
                                # runMegaPath.sh:211-216)
                                self._write_batch_sam(bdir, bi, *bsam)
                            save = dict(
                                read=brows[0] + base_before, end=brows[1],
                                sp=brows[2], sk=brows[3], score=brows[4],
                                best=best_b, counters=bcounters,
                                base_after=base_after,
                                lsam_off_after=lsam_out.tell(),
                            )
                            for si, part in enumerate(bspk):
                                for k, a in zip(
                                    ("read", "seq", "start", "stop"), part
                                ):
                                    save[f"spk{si}_{k}"] = a
                            tmp = os.path.join(bdir, f".tmp{bi:06d}.npz")
                            np.savez_compressed(tmp, **save)
                            os.replace(
                                tmp,
                                os.path.join(bdir, f"batch{bi:06d}.npz"),
                            )
                        except BaseException as e:  # propagate
                            werr.append(e)
                            return

            wt = threading.Thread(target=_writer, daemon=True)
            wt.start()

            with timer.stage("align"):
              try:
                for bi, batch in enumerate(stream_read_pairs(
                    r1_path, r2_path, batch_size=bs, max_len=cfg.max_read_len
                )):
                    if bi < n_done:
                        continue  # journaled: parsed-and-skipped on resume
                    if werr:
                        break
                    names = [trim_readno(n_) for n_ in batch.names]
                    recs1 = [
                        FastqRecord(n_, s_, q_)
                        for n_, s_, q_ in zip(names, batch.seqs1, batch.quals1)
                    ]
                    recs2 = [
                        FastqRecord(n_, s_, q_)
                        for n_, s_, q_ in zip(names, batch.seqs2, batch.quals2)
                    ]
                    bcounters = np.zeros(4, dtype=np.int64)
                    bcounters[0] = len(recs1)
                    (recs1, recs2, reads1, lens1, reads2, lens2,
                     n_pre, n_hg, n_ribo) = self._filter_batch(recs1, recs2)
                    bcounters[1:] = (n_pre, n_hg, n_ribo)
                    counters += bcounters
                    per_shard = self._align_shards(
                        reads1, lens1, reads2, lens2, n_ribo
                    )
                    bspk = []
                    for si, hits in enumerate(per_shard):
                        if len(hits):
                            off = self.nt_engines[si].ref.offsets[hits.seq]
                            part = (hits.read + base, hits.seq,
                                    hits.start - off, hits.stop - off)
                            spike_acc[si].append(part)
                            bspk.append(part)
                        else:
                            bspk.append(tuple(
                                np.zeros(0, np.int64) for _ in range(4)
                            ))
                    read, end, sp, sk, score, best_b = self._merge_arrays(
                        per_shard, n_ribo
                    )
                    bsam = None
                    if cfg.bam:
                        bsam = (
                            per_shard,
                            [r.name for r in recs1],
                            reads1, lens1, reads2, lens2,
                            [r.qual for r in recs1],
                            [r.qual for r in recs2],
                        )
                    wq.put((
                        bi, recs1, recs2, best_b,
                        (read, end, sp, sk, score), bspk, bcounters,
                        base, base + n_ribo, bsam,
                    ))
                    acc_rows.append(
                        (read + base, end, sp, sk, score)
                    )
                    acc_best.append(best_b)
                    base += n_ribo
                    print(
                        f"[stream] batch done: {base} pairs aligned so far",
                        file=sys.stderr,
                    )
              finally:
                wq.put(None)
                wt.join()
              if werr:
                  raise werr[0]
            rows = (
                tuple(
                    np.concatenate([p[i] for p in acc_rows])
                    for i in range(5)
                )
                if acc_rows
                else tuple(np.zeros(0, np.int64) for _ in range(5))
            )
            best = (
                np.concatenate(acc_best, axis=1)
                if acc_best
                else np.zeros((2, 0), np.int64)
            )
            save_kw = dict(
                read=rows[0], end=rows[1], sp=rows[2], sk=rows[3],
                score=rows[4], best=best, counters=counters,
            )
            for si, parts in enumerate(spike_acc):
                cat = (
                    [np.concatenate([p[i] for p in parts]) for i in range(4)]
                    if parts
                    else [np.zeros(0, np.int64)] * 4
                )
                save_kw[f"spk{si}_read"] = cat[0]
                save_kw[f"spk{si}_seq"] = cat[1]
                save_kw[f"spk{si}_start"] = cat[2]
                save_kw[f"spk{si}_stop"] = cat[3]
            np.savez_compressed(state_p, **save_kw)
            spike_parts = [
                (save_kw[f"spk{si}_read"], save_kw[f"spk{si}_seq"],
                 save_kw[f"spk{si}_start"], save_kw[f"spk{si}_stop"])
                for si in range(len(self.nt_engines))
            ]
            if cfg.bam:
                with timer.stage("bam"):
                    self._finalize_bam(bdir, out_prefix)
            with open(out_prefix + ".align.done", "w") as f:
                f.write("ok\n")
            # the stage gate supersedes the per-batch journal; drop it
            # so stale batch files can never leak into a future resume
            shutil.rmtree(bdir, ignore_errors=True)

        n = int(counters[3])
        if int(counters[0]) > 0:
            # stage-level failure detection (runMegaPath.sh:143-146):
            # a silent empty report is worse than a loud abort
            if int(counters[1]) == 0:
                raise PipelineAbort("No reads remained after preprocessing")
            if int(counters[2]) == 0:
                raise PipelineAbort("No reads remained after host filtering")
            if n == 0:
                raise PipelineAbort(
                    "No reads remained after the ribosome filter"
                )

        # ---- stage B: SPIKE filter over global coverage ---------------
        with timer.stage("spike"):
            banned: set = set()
            for si, (rd, sq, st_, sp_) in enumerate(spike_parts):
                if len(rd):
                    banned |= self._spike_from_intervals(si, rd, sq, st_, sp_)
            keep_read = np.ones(n, dtype=bool)
            if banned:
                keep_read[list(banned)] = False

        # ---- stage C: reassign + reports + filtered LSAM files --------
        with timer.stage("report"):
            report, ra_report, drop, _, ra_obj = self._tail(
                rows[0], rows[1], rows[2], rows[3], rows[4],
                best, keep_read, n,
            )
            with open(out_prefix + ".nt.report", "w") as f:
                f.write(report)
            with open(out_prefix + ".nt.ra.report", "w") as f:
                f.write(ra_report)
            # stream-filter the on-disk LSAM (lsamReadFilter semantics)
            # and the reassign rewrite (reassign.cpp pass 2)
            with open(raw_lsam) as fin, \
                    open(out_prefix + ".nt.lsam.id", "w") as fo, \
                    open(out_prefix + ".nt.ra.lsam.id", "w") as fr:
                for li, line in enumerate(fin):
                    if not keep_read[li // 2]:
                        continue
                    fo.write(line)
                    fr.write(ra_obj.rewrite_line(line) + "\n")

        # ---- stage 4 (-A): assembly + protein remap ----------------------
        if assembly and not os.path.exists(out_prefix + ".assembly.done"):
            with timer.stage("assembly"):
                self._assembly_stage(r1_path, r2_path, out_prefix, megahit_bin,
                                     protein_db=protein_db)
            with open(out_prefix + ".assembly.done", "w") as f:
                f.write("ok\n")

        with open(out_prefix + ".done", "w") as f:
            f.write("ok\n")
        return PipelineResult(
            report=report,
            ra_report=ra_report,
            lsam_id=[],
            ra_lsam_id=[],
            n_input_pairs=int(counters[0]),
            n_after_preprocess=int(counters[1]),
            n_after_human=int(counters[2]),
            spike_removed=len(banned),
            n_after_ribo=int(counters[3]),
        )

    def _assembly_stage(
        self, r1_path, r2_path, out_prefix: str, megahit_bin: Optional[str],
        protein_db=None,
    ) -> None:
        """Stage 4/4.1 (-A, runMegaPath.sh:267-330): extract viral +
        unmapped pairs from the filtered LSAM, bbnorm + assemble on the
        host, map the reads back to the contigs on the pipeline's device;
        with ``protein_db`` (a ``classify.protein.ProteinDB``), the protein
        remap of the contigs and the still-unmapped reads, its DP on the
        pipeline's device."""
        lsam_id = list(read_lsam(out_prefix + ".nt.lsam.id"))
        recs1 = list(read_fastx(r1_path))
        recs2 = list(read_fastx(r2_path))
        for r in recs1 + recs2:
            r.name = trim_readno(r.name)
        v1, v2 = extract_viral_and_unmapped(
            lsam_id, recs1, recs2, threshold=self.cfg.nt_cutoff
        )
        res = assembly_path(v1, v2, megahit_bin=megahit_bin, device=self.device,
                            device_seeding=self.cfg.device_seeding)
        with open(out_prefix + ".contigs.fa", "w") as f:
            for i, c in enumerate(res.contigs):
                f.write(f">ctg{i}\n{c}\n")
        with open(out_prefix + ".r2c.lsam", "w") as f:
            for rec in res.read2contig:
                f.write(rec.to_line() + "\n")
        if protein_db is not None:
            nr_lsam_id, r2g, nr_report = protein_remap(
                res, v1, v2, protein_db, self.taxdb,
                cutoff=self.cfg.nt_cutoff, device=self.device,
            )
            with open(out_prefix + ".nr.lsam.id", "w") as f:
                for rec in nr_lsam_id:
                    f.write(rec.to_line() + "\n")
            with open(out_prefix + ".nt.unmap.r2g.lsam.id", "w") as f:
                for rec in r2g:
                    f.write(rec.to_line() + "\n")
            with open(out_prefix + ".nr.report", "w") as f:
                f.write(nr_report)

    def _write_batch_sam(
        self, bdir: str, bi: int, per_shard, names,
        reads1, lens1, reads2, lens2, quals1, quals2,
    ) -> None:
        """One batch's per-shard SAM alignment lines (writer thread)."""
        for si, hits in enumerate(per_shard):
            path = os.path.join(bdir, f"sam{si}_{bi:06d}.txt")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                if len(hits):
                    for line in hits_to_sam(
                        hits, self.nt_engines[si].ref, names,
                        reads1, lens1, reads2, lens2,
                        quals1=quals1, quals2=quals2,
                    ):
                        f.write(line + "\n")
            os.replace(tmp, path)

    def _finalize_bam(self, bdir: str, out_prefix: str) -> None:
        """Per-shard sorted BAMs + the merged PREFIX.nt.bam (the
        samtools merge/sort tail, runMegaPath.sh:211-216)."""
        shard_paths = []
        for si in range(len(self.nt_engines)):
            lines: List[str] = []
            for p in sorted(glob.glob(os.path.join(bdir, f"sam{si}_*.txt"))):
                with open(p) as f:
                    lines.extend(l.rstrip("\n") for l in f if l.strip())
            header = sam_header(self.nt_engines[si].ref)
            sp = f"{out_prefix}.nt.bam.{si}"
            with open(sp, "wb") as f:
                write_bam(f, header, sort_sam_lines(header, lines))
            shard_paths.append(sp)
        with open(out_prefix + ".nt.bam", "wb") as fo:
            fhs = [open(p, "rb") for p in shard_paths]
            try:
                merge_shard_bams(fhs, fo)
            finally:
                for f in fhs:
                    f.close()

    # ------------------------------------------------------------------
    def _filter_batch(
        self, recs1: List[FastqRecord], recs2: List[FastqRecord]
    ):
        """Stages 0-1.5 on one batch: bbduk preprocess, human filter,
        optional ribosome filter. Returns the surviving records +
        packed arrays + (n_pre, n_hg, n_ribo) counters."""
        cfg = self.cfg

        # -- 0. preprocess (bbduk passes, runMegaPath.sh:119) ----------
        if not cfg.skip_preprocess:
            # array fast path: bbduk hands back the trimmed/masked
            # code matrices directly (bit-identical to pack_reads over
            # its record output) and the records stay lazy — the
            # aligner never needs them, only the LSAM/FASTQ sinks do
            with self._stage("bbduk"):
                ba = bbduk_pair_arrays(
                    recs1,
                    recs2,
                    self.adapters,
                    min_len=cfg.min_len,
                    trimq=10,
                    entropy_cutoff=cfg.entropy,
                    max_len=cfg.max_read_len,
                )
            recs1, recs2 = ba.kept1, ba.kept2
            reads1, lens1 = ba.codes1, ba.lens1
            reads2, lens2 = ba.codes2, ba.lens2
            n_pre = len(recs1)
        else:
            n_pre = len(recs1)
            reads1, lens1 = pack_reads(
                [r.seq for r in recs1], cfg.max_read_len
            )
            reads2, lens2 = pack_reads(
                [r.seq for r in recs2], cfg.max_read_len
            )

        # -- 1. human filter (runMegaPath.sh:128-153) ------------------
        if self.hg_engine is not None and not cfg.skip_human and n_pre:
            with self._stage("hg"):
                hits = self.hg_engine.align_pairs(reads1, lens1, reads2, lens2)
            best = self._best_per_end(hits, n_pre, mode=1)
            # extractFromLSAM.pl:69 keeps the pair when EITHER end is
            # below the cutoff
            keep = (best[0] < cfg.hg_cutoff) | (best[1] < cfg.hg_cutoff)
            kidx = np.flatnonzero(keep)
            recs1 = [recs1[i] for i in kidx]
            recs2 = [recs2[i] for i in kidx]
            reads1, lens1 = reads1[kidx], lens1[kidx]
            reads2, lens2 = reads2[kidx], lens2[kidx]
        n_hg = len(recs1)

        # -- 1.5 ribosome filter (-S, runMegaPath.sh:155-169) ----------
        # soap4 -P -top 100 vs SILVA, extract at fractional t=0.95:
        # cutoff = 0.95 * (len1 + len2) against the pair-required score
        if self.ribo_engine is not None and n_hg:
            with self._stage("ribo"):
                hits = self.ribo_engine.align_pairs(reads1, lens1, reads2, lens2)
            best = self._best_per_end(hits, n_hg, mode=2)
            cut = (
                cfg.ribo_cutoff
                * (lens1.astype(np.int64) + lens2.astype(np.int64))
            )
            keep = (best[0] < cut) | (best[1] < cut)
            kidx = np.flatnonzero(keep)
            recs1 = [recs1[i] for i in kidx]
            recs2 = [recs2[i] for i in kidx]
            reads1, lens1 = reads1[kidx], lens1[kidx]
            reads2, lens2 = reads2[kidx], lens2[kidx]
        n_ribo = len(recs1)

        return recs1, recs2, reads1, lens1, reads2, lens2, n_pre, n_hg, n_ribo

    @staticmethod
    def _best_per_end(hits: BatchHits, n: int, mode: int) -> np.ndarray:
        """[2, n] best normalized score per read end; mode 2 counts
        paired hits only (BGS-IO.cpp:2001-2010)."""
        best = np.zeros((2, n), dtype=np.int64)
        m = hits.paired if mode == 2 else np.ones(len(hits.read), bool)
        if m.any():
            np.maximum.at(
                best,
                (hits.end[m].astype(np.int64), hits.read[m].astype(np.int64)),
                hits.score[m].astype(np.int64),
            )
        return best

    def _align_shards(self, reads1, lens1, reads2, lens2, n) -> List[BatchHits]:
        """Stage 2: NT alignment over all shards, one after another on the
        pipeline's device (the reference's sequential shard cascade,
        runMegaPath.sh:191-227, with the hit lists merged as arrays)."""
        if not n:
            return [BatchHits.empty() for _ in self.nt_engines]
        return [
            engine.align_pairs(reads1, lens1, reads2, lens2)
            for engine in self.nt_engines
        ]

    def _tail(
        self,
        read: np.ndarray,
        end: np.ndarray,
        sp: np.ndarray,
        sk: np.ndarray,
        score: np.ndarray,
        best: np.ndarray,
        keep_read: np.ndarray,
        n: int,
    ):
        """Stage 3 on merged arrays: reassign + both reports. Returns
        (report, ra_report, drop_mask, filtered row arrays)."""
        cfg = self.cfg
        rows_keep = keep_read[read] if len(read) else np.zeros(0, bool)
        read, end, sp, sk, score = (
            read[rows_keep], end[rows_keep], sp[rows_keep],
            sk[rows_keep], score[rows_keep],
        )
        gid = (read.astype(np.int64) * 2 + end).astype(np.int64)
        line_scores = best.T.reshape(-1)  # [2n]: index r*2+e

        ra = Reassigner(t=float(cfg.nt_cutoff))
        ra.count_grouped(sp, gid, line_scores)
        ra.resolve()
        drop = ra.explained_rows(sp, gid, 2 * n)

        line_mask = np.repeat(keep_read, 2)
        report = self._report_arrays(sp, gid, line_scores, line_mask, n)
        ra_report = self._report_arrays(
            sp[~drop], gid[~drop], line_scores, line_mask, n
        )
        return report, ra_report, drop, (read, end, sp, sk, score), ra

    def run_records(
        self, recs1: List[FastqRecord], recs2: List[FastqRecord]
    ) -> PipelineResult:
        n_input = len(recs1)
        (recs1, recs2, reads1, lens1, reads2, lens2,
         n_pre, n_hg, n_ribo) = self._filter_batch(recs1, recs2)
        n = n_ribo

        with self._stage("nt"):
            per_shard_hits = self._align_shards(reads1, lens1, reads2, lens2, n)
        with self._stage("tail"):
            return self._finish_records(
                recs1, recs2, per_shard_hits, n,
                n_input=n_input, n_pre=n_pre, n_hg=n_hg,
            )

    def _finish_records(
        self,
        recs1: List[FastqRecord],
        recs2: List[FastqRecord],
        per_shard_hits: List[BatchHits],
        n: int,
        n_input: int = 0,
        n_pre: int = 0,
        n_hg: int = 0,
    ) -> PipelineResult:
        """Post-alignment tail (SPIKE -> merge -> reassign -> reports)
        on precomputed per-shard hit tables."""
        # -- SPIKE filter (runMegaPath.sh:211-221) ---------------------
        spike_removed = self._spike_banned(per_shard_hits, n)
        n_spiked = len(spike_removed)

        # -- array hit merge + taxid lookup (taxLookupAcc) -------------
        # Everything downstream (reassign counting, LCA, reports) runs
        # on flat arrays; LsamRecord objects materialize only for the
        # returned LSAM views. Rows are sorted by (read, end, species);
        # a "line" is one read end, gid = read*2 + end.
        read, end, sp, sk, score, best = self._merge_arrays(
            per_shard_hits, n
        )
        keep_read = np.ones(n, dtype=bool)
        if spike_removed:
            keep_read[list(spike_removed)] = False

        report, ra_report, drop, rows, _ = self._tail(
            read, end, sp, sk, score, best, keep_read, n
        )
        read, end, sp, sk, score = rows

        lsam_id = LazyRecords(lambda: self._build_lsam_records(
            recs1, recs2, keep_read, best, read, end, sp, sk, score
        ))
        ra_lsam = LazyRecords(lambda: self._build_lsam_records(
            recs1, recs2, keep_read, best,
            read[~drop], end[~drop], sp[~drop], sk[~drop], score[~drop],
            reassigned=True,
            sk_full=(read, end, sk),
        ))
        return PipelineResult(
            report=report,
            ra_report=ra_report,
            lsam_id=lsam_id,
            ra_lsam_id=ra_lsam,
            n_input_pairs=n_input,
            n_after_preprocess=n_pre,
            n_after_human=n_hg,
            spike_removed=n_spiked,
            n_after_ribo=n,
        )

    def _spike_banned(
        self, per_shard_hits: List[BatchHits], n_reads: int
    ) -> set:
        banned: set = set()
        for si, hits in enumerate(per_shard_hits):
            if not len(hits):
                continue
            off = self.nt_engines[si].ref.offsets[hits.seq]
            banned |= self._spike_from_intervals(
                si, hits.read, hits.seq, hits.start - off, hits.stop - off
            )
        return banned

    def _spike_from_intervals(
        self, shard_idx: int, read, seq, local_start, local_stop
    ) -> set:
        seq_lens = np.diff(self.nt_engines[shard_idx].ref.offsets)
        bad = spike_read_filter(
            seq_lens.tolist(),
            read,
            seq,
            local_start,
            local_stop,
            max_depth_stdev=self.cfg.spike_stdev,
            overlap=self.cfg.spike_overlap,
        )
        return {int(b) for b in bad}

    def _merge_arrays(
        self, per_shard_hits: List[BatchHits], n: int
    ) -> Tuple[np.ndarray, ...]:
        """Array merge across shards -> species hits per read end.

        Equivalent of the cfq-comment chain + taxLookupAcc: per
        (end, read) keep max score per species, apply the
        top-percentage retention against the per-end best. Returns
        (read, end, sp, sk, score) rows sorted by (read, end, sp) plus
        the [2, n] per-end best-score table.
        """
        top = self.cfg.top_percentage

        reads_l, ends_l, sp_l, sk_l, sc_l = [], [], [], [], []
        for si, hits in enumerate(per_shard_hits):
            r, e, q, s = best_per_seq_arrays(hits, megapath_mode=1)
            reads_l.append(r)
            ends_l.append(e)
            sp_l.append(self._species_of[si][q])
            sk_l.append(self._sk_of[si][q])
            sc_l.append(s)
        if reads_l:
            read = np.concatenate(reads_l)
            end = np.concatenate(ends_l)
            sp = np.concatenate(sp_l)
            sk = np.concatenate(sk_l)
            score = np.concatenate(sc_l).astype(np.int64)
        else:
            read = np.zeros(0, np.int32)
            end = np.zeros(0, np.int8)
            sp = sk = np.zeros(0, np.int64)
            score = np.zeros(0, np.int64)

        # per (end, read) best over ALL hits, unknown accessions
        # included: taxLookupAcc passes the LSAM score column through
        # even when no hit maps to a species (taxLookupAcc.cpp:62-92),
        # and the -top retention compares against this best
        best = np.zeros((2, n), dtype=np.int64)
        if len(read):
            np.maximum.at(
                best, (end.astype(np.int64), read.astype(np.int64)), score
            )

        known = sp >= 0
        read, end, sp, sk, score = (
            read[known], end[known], sp[known], sk[known], score[known]
        )
        if len(read):
            # best per (end, read, species)
            order = np.lexsort((-score, sp, read, end))
            read, end, sp, sk, score = (
                read[order], end[order], sp[order], sk[order], score[order]
            )
            first = np.r_[
                True,
                (read[1:] != read[:-1]) | (end[1:] != end[:-1]) | (sp[1:] != sp[:-1]),
            ]
            read, end, sp, sk, score = (
                read[first], end[first], sp[first], sk[first], score[first]
            )
            # -top retention against the all-hits best computed above
            keep = score >= best[end.astype(np.int64), read.astype(np.int64)] * top
            read, end, sp, sk, score = (
                read[keep], end[keep], sp[keep], sk[keep], score[keep]
            )
            # canonical (read, end, species) row order
            order = np.lexsort((sp, end, read))
            read, end, sp, sk, score = (
                read[order], end[order], sp[order], sk[order], score[order]
            )
        return read, end, sp, sk, score, best

    def _report_arrays(
        self,
        sp: np.ndarray,
        gid: np.ndarray,
        line_scores: np.ndarray,
        line_mask: np.ndarray,
        n: int,
    ) -> str:
        """Kraken report from hit rows: per-line LCA (vectorized group
        fold), lines below the cutoff or without hits unclassified
        (genKrakenReport.cpp:148-156)."""
        lca_full = np.zeros(2 * n, dtype=np.int64)
        has = np.zeros(2 * n, dtype=bool)
        if len(sp):
            pres = np.unique(gid)
            lca_full[pres] = self.taxdb.lca_grouped(sp, gid)
            has[pres] = True
        scores_eff = np.where(has, line_scores, -1)[line_mask]
        rpt = KrakenReport(self.taxdb)
        rpt.add_lsam_batch(
            scores_eff, lca_full[line_mask], self.cfg.nt_cutoff
        )
        return rpt.format()

    def _build_lsam_records(
        self, recs1, recs2, keep_read, best,
        read, end, sp, sk, score,
        reassigned: bool = False,
        sk_full=None,
    ) -> List[LsamRecord]:
        """Materialize LSAM.id records from merged rows (sorted by
        (read, end, sp)). ``reassigned`` masks seq/qual to '*' like the
        reassign tool; ``sk_full`` supplies the pre-reassign rows whose
        superkingdom set labels the opts column (the reference keeps
        the original annotation columns through reassign)."""
        # byte parity depends on integer text ('3', never '3.0'): the
        # .tolist() fast paths below format values verbatim
        for a in (sp, score, best):
            assert np.asarray(a).dtype.kind in "iu", (
                f"_build_lsam_records requires integer arrays, got "
                f"{np.asarray(a).dtype}"
            )
        db = self.taxdb
        name_cache: Dict[int, str] = {}

        def _names(sks) -> List[str]:
            out = []
            for t in sks:
                nm = name_cache.get(t)
                if nm is None:
                    nm = name_cache[t] = db.name_of(t)
                out.append(nm)
            return out

        def _group_bounds(r, e):
            """(read, end) -> (start, stop) row ranges, via one pass
            over the (read,end)-sorted rows; .tolist() hoists every
            per-element numpy-scalar conversion out of the line loop."""
            g: Dict[Tuple[int, int], Tuple[int, int]] = {}
            if len(r):
                bounds = np.flatnonzero(
                    np.r_[True, (r[1:] != r[:-1]) | (e[1:] != e[:-1])]
                ).tolist()
                bounds.append(len(r))
                rl, el = r.tolist(), e.tolist()
                for gi in range(len(bounds) - 1):
                    b = bounds[gi]
                    g[(rl[b], el[b])] = (b, bounds[gi + 1])
            return g

        groups = _group_bounds(read, end)
        score_l = score.tolist()
        sp_l = [str(t) for t in sp.tolist()]
        sk_l = sk.tolist()
        sk_groups: Dict[Tuple[int, int], List[str]] = {}
        if sk_full is not None:
            fr, fe, fsk = sk_full
            fsk_l = fsk.tolist()
            for key, (b, e_) in _group_bounds(fr, fe).items():
                sks = sorted(set(fsk_l[b:e_]) - {0})
                sk_groups[key] = _names(sks)

        best_l = best.tolist()
        out: List[LsamRecord] = []
        for i in np.flatnonzero(keep_read).tolist():
            for e_, recs in ((0, recs1), (1, recs2)):
                rec = recs[i]
                g = groups.get((i, e_))
                if sk_full is not None:
                    opts = sk_groups.get((i, e_), [])
                elif g is not None:
                    sks = sorted(set(sk_l[g[0]:g[1]]) - {0})
                    opts = _names(sks)
                else:
                    opts = []
                seq = "*" if reassigned else rec.seq
                qual = "*" if reassigned else rec.qual
                hits = (
                    list(zip(score_l[g[0]:g[1]], sp_l[g[0]:g[1]]))
                    if g is not None
                    else []
                )
                out.append(
                    LsamRecord(
                        name=rec.name,
                        flag=0x40 if e_ == 0 else 0x80,
                        score=best_l[e_][i],
                        seq=seq,
                        qual=qual,
                        hits=hits,
                        opts=opts,
                    )
                )
        return out
