"""MegaPath-Amplicon pipeline (runMegaPath-Amplicon.sh equivalent).

The reference drives bwa-mem/GATK/pypy-realignment subprocesses
(MegaPath: runMegaPath-Amplicon.sh, scripts/amplicon/*): QC ->
human + decoy filters (AS/len ratio) -> taxon filter (top-AS hits must
include the target) -> alignment filter (AS>=150 & MAPQ>=10) ->
variant calling -> DeepVariant-style local realignment. Here every
alignment stage runs on the same batched engine, the realignment is
the batched dBG/SSW realigner (megapath_tpu_torch.amplicon), and variant
candidates come from an in-process pileup over the final alignments
(the GATK HaplotypeCaller subprocess is replaced by pileup + local
reassembly, the same evidence model the realigner refines).

The port's copy of ``megapath_tpu/pipeline/amplicon.py``, held equal to it
by ``tests/test_torch_amplicon_pipeline.py`` and
``tests/test_torch_cli_amplicon.py``. ``AmpliconPipeline`` takes a
keyword-only ``device``: every engine (decoy, taxon, target and
``assembly_filter``'s contig engine) aligns there on host seeding, as the
JAX pipeline's engines do, the contig index is built there, and the DNA DP
of the realigner and of ``_hap_variants`` runs there
(``amplicon.realign.dna_dp``). The pileup, the de Bruijn haplotypes and the
tracebacks run on the host, as in the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from megapath_tpu_torch.align import AlignEngine, AlignParams, best_per_seq
from megapath_tpu_torch.amplicon.realign import realign_window
from megapath_tpu_torch.filters.bbduk import KmerRef, bbduk_pair
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import COMPLEMENT, PackedReference, decode_seq, pack_reads
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.ops.dp import DPParams


@dataclass
class AmpliconConfig:
    min_len: int = 50
    as_over_len_ratio: float = 1.0  # decoy-stage filter (filter_bam.py)
    final_as: int = 150  # final alignment filter
    final_mapq: int = 10
    min_allele_frac: float = 0.2
    min_depth: int = 4
    realign_window_pad: int = 60
    # active-region span cap (GATK analogue): indel-bearing reads
    # project ungapped mismatch TAILS that nominate noise sites and
    # chain-merge candidate windows into multi-hundred-bp regions the
    # local dBG realigner cannot assemble (measured: windows up to
    # 839 bp and a recall wipeout at 120x before the cap)
    max_window: int = 260
    max_read_len: int = 512


@dataclass
class Variant:
    seq: str
    pos: int  # 0-based
    ref: str
    alt: str
    depth: int
    alt_count: int


@dataclass
class AmpliconResult:
    n_input: int
    n_after_qc: int
    n_after_decoy: int
    n_after_taxon: int
    n_final: int
    variants: List[Variant]


def _hap_variants(window: str, hap: str, _params=None, *, device: torch.device):
    """(0-based window pos, ref allele, alt allele) triples from one
    haplotype's alignment to the reference window. Indels are anchored
    on the previous reference base (VCF convention); runs of
    mismatches emit one SNP per position."""
    from megapath_tpu_torch.amplicon.realign import SSW_PARAMS, dna_dp
    from megapath_tpu_torch.index.pack import encode_seq
    from megapath_tpu_torch.ops.dp import sw_traceback_ops

    wc = encode_seq(window)
    hc = encode_seq(hap)
    _, end_ref, end_read = dna_dp(
        hc[None, :], wc[None, :],
        np.array([len(hc)], np.int32), np.array([len(wc)], np.int32),
        SSW_PARAMS, device=device,
    )
    e_ref = int(end_ref[0])
    e_read = int(end_read[0])
    if e_ref == 0 or e_read == 0:
        return []
    s_ref, s_read, ops = sw_traceback_ops(
        hc[:e_read], wc[:e_ref], e_ref, e_read, SSW_PARAMS
    )
    out = []
    i, j = s_ref, s_read  # window / haplotype cursors
    k = 0
    while k < len(ops):
        o = ops[k]
        if o == "M":
            i += 1
            j += 1
            k += 1
        elif o == "X":
            out.append((i, window[i], hap[j]))
            i += 1
            j += 1
            k += 1
        elif o == "I":  # bases present in hap, absent from ref
            run = 0
            while k < len(ops) and ops[k] == "I":
                run += 1
                k += 1
            if i > 0:
                out.append((
                    i - 1, window[i - 1],
                    window[i - 1] + hap[j : j + run],
                ))
            j += run
        else:  # 'D': bases present in ref, absent from hap
            run = 0
            while k < len(ops) and ops[k] == "D":
                run += 1
                k += 1
            if i > 0:
                out.append((
                    i - 1, window[i - 1 : i + run], window[i - 1],
                ))
            i += run
    return out


class AmpliconPipeline:
    def __init__(
        self,
        target: Tuple[PackedReference, FMIndex],  # e.g. the TB reference
        target_seq_ids: Optional[Set[int]] = None,
        decoys: Sequence[Tuple[PackedReference, FMIndex]] = (),  # human, oral
        taxon_db: Optional[Tuple[PackedReference, FMIndex]] = None,  # refseq
        adapters: Optional[KmerRef] = None,
        config: Optional[AmpliconConfig] = None,
        *,
        device: torch.device,
    ):
        self.cfg = config or AmpliconConfig()
        self.device = torch.device(device)
        self.target_ref, self.target_fm = target
        self.target_engine = AlignEngine(self.target_ref, self.target_fm, AlignParams(),
                                         device=self.device)
        self.target_seq_ids = target_seq_ids
        self.decoy_engines = [AlignEngine(r, f, AlignParams(), device=self.device)
                              for r, f in decoys]
        self.taxon_engine = (
            AlignEngine(taxon_db[0], taxon_db[1], AlignParams(), device=self.device)
            if taxon_db is not None
            else None
        )
        self.adapters = adapters

    # ------------------------------------------------------------------
    def run_records(
        self, recs1: List[FastqRecord], recs2: List[FastqRecord]
    ) -> AmpliconResult:
        cfg = self.cfg
        n_input = len(recs1)

        bb = bbduk_pair(recs1, recs2, self.adapters, min_len=cfg.min_len,
                        entropy_cutoff=0, max_len=cfg.max_read_len)
        recs1, recs2 = bb.kept1, bb.kept2
        n_qc = len(recs1)

        reads1, lens1 = pack_reads([r.seq for r in recs1], cfg.max_read_len)
        reads2, lens2 = pack_reads([r.seq for r in recs2], cfg.max_read_len)

        # decoy filters: drop pairs matching human/oral refs with
        # AS/len >= ratio (AS_over_len_ratio_filter, runMegaPath-
        # Amplicon.sh:61-81)
        keep = np.ones(n_qc, dtype=bool)
        for eng in self.decoy_engines:
            if not keep.any():
                break
            hits = eng.align_pairs(reads1, lens1, reads2, lens2)
            t = best_per_seq(hits, n_qc, megapath_mode=1)
            for i in range(n_qc):
                b1 = max(t[0][i].values(), default=0)
                b2 = max(t[1][i].values(), default=0)
                # per-end raw AS ~ score/2 for paired sums; use raw max
                r1l, r2l = max(int(lens1[i]), 1), max(int(lens2[i]), 1)
                if (b1 / (r1l + r2l) >= self.cfg.as_over_len_ratio) or (
                    b2 / (r1l + r2l) >= self.cfg.as_over_len_ratio
                ):
                    keep[i] = False
        idx = np.flatnonzero(keep)
        recs1 = [recs1[i] for i in idx]
        recs2 = [recs2[i] for i in idx]
        reads1, lens1 = reads1[idx], lens1[idx]
        reads2, lens2 = reads2[idx], lens2[idx]
        n_decoy = len(recs1)

        # taxon filter: keep reads whose top-scoring hits include the
        # target seq ids (get_highestAS_read_match_target.py)
        if self.taxon_engine is not None and self.target_seq_ids and n_decoy:
            hits = self.taxon_engine.align_pairs(reads1, lens1, reads2, lens2)
            t = best_per_seq(hits, n_decoy, megapath_mode=1)
            keep = np.zeros(n_decoy, dtype=bool)
            for i in range(n_decoy):
                for e in range(2):
                    d = t[e][i]
                    if not d:
                        continue
                    best = max(d.values())
                    tops = {s for s, sc in d.items() if sc == best}
                    if tops & self.target_seq_ids:
                        keep[i] = True
            idx = np.flatnonzero(keep)
            recs1 = [recs1[i] for i in idx]
            recs2 = [recs2[i] for i in idx]
            reads1, lens1 = reads1[idx], lens1[idx]
            reads2, lens2 = reads2[idx], lens2[idx]
        n_taxon = len(recs1)

        # final alignment vs the target; AS>=150 & MAPQ>=10 equivalent:
        # require a passing paired alignment with raw AS >= final_as
        final_hits = (
            self.target_engine.align_pairs(reads1, lens1, reads2, lens2)
            if n_taxon
            else None
        )
        variants: List[Variant] = []
        n_final = 0
        if final_hits is not None and len(final_hits.read):
            ok = final_hits.raw_score >= self.cfg.final_as
            n_final = len(np.unique(final_hits.read[ok]))
            variants = self._call_and_realign(
                final_hits, ok, recs1, recs2, reads1, lens1, reads2, lens2
            )
        return AmpliconResult(
            n_input=n_input,
            n_after_qc=n_qc,
            n_after_decoy=n_decoy,
            n_after_taxon=n_taxon,
            n_final=n_final,
            variants=variants,
        )

    # ------------------------------------------------------------------
    def assembly_filter(
        self,
        recs1: List[FastqRecord],
        recs2: List[FastqRecord],
        reads1: np.ndarray,
        lens1: np.ndarray,
        reads2: np.ndarray,
        lens2: np.ndarray,
        regions: Sequence[Tuple[int, int]],
        mean_mapq_thres: int = 10,
        k: int = 31,
    ) -> np.ndarray:
        """Per-amplicon-region assembly filter -> keep mask per pair.

        Mirrors the reference's assembly-filter stage
        (runMegaPath-Amplicon.sh:104-138 + scripts/amplicon/
        filter_contigs.py): reads mapping to each region assemble into
        contigs; a region's reads survive when they align to a
        credible contig (contig maps back to the region AND its reads
        average MAPQ >= thres) or fail to align to any contig; when no
        contig maps to the region at all, the whole region's reads are
        retained. MEGAHIT/bwa/minimap2/samtools subprocesses become
        the built-in unitig assembler + this engine.
        """
        from megapath_tpu_torch.index.fm import build_fm_index
        from megapath_tpu_torch.index.pack import pack_fasta
        from megapath_tpu_torch.io.sam import bwa_single_mapq
        from megapath_tpu_torch.pipeline.assembly import assemble_unitigs

        n = len(recs1)
        keep = np.zeros(n, dtype=bool)
        hits = self.target_engine.align_pairs(reads1, lens1, reads2, lens2)
        for rstart, rend in regions:
            rows = (hits.start < rend) & (hits.stop > rstart)
            rids = np.unique(hits.read[rows])
            if len(rids) == 0:
                continue
            seqs = [recs1[i].seq for i in rids] + [recs2[i].seq for i in rids]
            contigs = assemble_unitigs(seqs, k=k, min_count=2, min_len=100)
            # contigs that map back inside the region (seed check on
            # the target index; contigs assemble from real reads, so
            # exact seeds locate them)
            region_contigs: List[str] = []
            for cseq in contigs:
                probe = cseq[: self.cfg.max_read_len]
                codes, lens_ = pack_reads([probe], self.cfg.max_read_len)
                sp = self.target_engine.seed_positions(codes, lens_)
                if len(sp.pos) and (
                    (sp.pos >= rstart - 200) & (sp.pos < rend + 200)
                ).any():
                    region_contigs.append(cseq)
            if not region_contigs:
                keep[rids] = True  # no credible assembly: retain region
                continue
            # reads -> contigs: mean MAPQ per contig
            cref = pack_fasta(
                [FastqRecord(f"ctg{i}", s, "", "") for i, s in enumerate(region_contigs)]
            )
            cfm = build_fm_index(cref.codes, sa_interval=8, lut_k=8, device=self.device)
            ceng = AlignEngine(cref, cfm, AlignParams(), device=self.device)
            chits = ceng.align_pairs(
                reads1[rids], lens1[rids], reads2[rids], lens2[rids]
            )
            # per-(read,end) BWA-like MAPQ over the contig hit set
            # (filter_contigs.py gates on bwa-mem MAPQ >= 10)
            read_mapq: dict = {}
            for rr in np.unique(chits.read):
                for ee in (0, 1):
                    m_ = (chits.read == rr) & (chits.end == ee)
                    if not m_.any():
                        continue
                    raws = chits.raw_score[m_]
                    best = raws.max()
                    x0 = int((raws == best).sum())
                    rest = raws[raws < best]
                    x1 = int((rest == rest.max()).sum()) if len(rest) else 0
                    read_mapq[(int(rr), ee)] = bwa_single_mapq(x0, x1)
            passed: set = set()
            for ci in range(len(region_contigs)):
                m = chits.seq == ci
                if not m.any():
                    continue
                mapqs = [
                    read_mapq[(int(r_), int(e_))]
                    for r_, e_ in zip(chits.read[m], chits.end[m])
                ]
                if np.mean(mapqs) >= mean_mapq_thres:
                    passed.add(ci)
            # retain reads aligned to passed contigs or unaligned to any
            aligned_reads = set(int(r) for r in np.unique(chits.read))
            for local_idx, rid in enumerate(rids):
                m = chits.read == local_idx
                if local_idx not in aligned_reads:
                    keep[rid] = True
                elif any(int(c) in passed for c in chits.seq[m]):
                    keep[rid] = True
        return keep

    # ------------------------------------------------------------------
    def run_files(self, r1_path, r2_path, out_prefix: str) -> AmpliconResult:
        """File entry point: FASTQ pair in, ``<prefix>.vcf`` + stats out,
        with a ``.done`` resume marker like the reference script's
        stage gates (runMegaPath-Amplicon.sh:85,203,241)."""
        import os
        import sys

        from megapath_tpu_torch.io.fastq import read_fastx, trim_readno
        from megapath_tpu_torch.io.vcf import write_vcf

        done = out_prefix + ".done"
        if os.path.exists(done):
            print(f"Skipping: {done} exists", file=sys.stderr)
            return AmpliconResult(0, 0, 0, 0, 0, [])
        recs1 = list(read_fastx(r1_path))
        recs2 = list(read_fastx(r2_path))
        for r in recs1 + recs2:
            r.name = trim_readno(r.name)
        result = self.run_records(recs1, recs2)
        contigs = [
            (name.split()[0], int(ln))
            for name, ln in zip(
                self.target_ref.names, np.diff(self.target_ref.offsets)
            )
        ]
        with open(out_prefix + ".vcf", "w") as f:
            write_vcf(result.variants, f, contigs=contigs)
        with open(done, "w") as f:
            f.write("ok\n")
        return result

    # ------------------------------------------------------------------
    def _call_and_realign(
        self, hits, ok, recs1, recs2, reads1, lens1, reads2, lens2
    ) -> List[Variant]:
        """Haplotype-based variant calling (SNPs AND indels, mixed AF).

        Fills the GATK HaplotypeCaller stage's role
        (runMegaPath-Amplicon.sh:202-238) with the realignment
        subsystem's machinery: pileup mismatches nominate candidate
        windows (an indel shows up as a mismatch cluster downstream of
        the gap under ungapped projection), dBG candidate haplotypes +
        batched-SSW read assignment (amplicon.realign.realign_window)
        pick the supported haplotypes, and variants are read off each
        winning haplotype's alignment to the reference window.
        Divergences from HaplotypeCaller: no quality-weighted pair-HMM
        genotype likelihoods (read counts stand in for GQ/PL) and no
        joint genotyping across samples — see
        tests/test_amplicon_pipeline.py planted-truth accuracy.
        """
        cfg = self.cfg
        ref = self.target_ref
        n = ref.total_len
        depth = np.zeros(n, dtype=np.int32)
        alt_counts: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))

        rows = np.flatnonzero(ok)
        for i in rows:
            r = int(hits.read[i])
            e = int(hits.end[i])
            strand = int(hits.strand[i])
            reads = reads1 if e == 0 else reads2
            lens = lens1 if e == 0 else lens2
            rl = int(lens[r])
            codes = reads[r, :rl]
            if strand:
                codes = COMPLEMENT[codes[::-1]]
            g0 = int(hits.start[i])
            g1 = int(hits.stop[i])
            span = min(g1 - g0, rl)
            depth[g0 : g0 + span] += 1
            seg = ref.codes[g0 : g0 + span]
            mism = np.flatnonzero(seg != codes[:span])
            for m in mism:
                alt_counts[g0 + int(m)][int(codes[m])] += 1

        # candidate sites -> merged windows. Site nomination must scale
        # with depth (GATK's active-region detection analogue): at
        # amplicon depths a flat ">=2 alt reads" gate nominates every
        # position touched by sequencing errors (0.5% error x 100x
        # depth trips it genome-wide), the windows merge into one
        # genome-sized region and the dBG realigner has nothing local
        # to assemble — measured as a total call wipeout at 120x.
        pad = cfg.realign_window_pad
        site_min = lambda pos: max(
            2, int(0.25 * cfg.min_allele_frac * depth[pos])
        )
        sites = sorted(
            pos for pos, alts in alt_counts.items()
            if max(alts.values()) >= site_min(pos)
            and depth[pos] >= cfg.min_depth
        )
        windows: List[Tuple[int, int]] = []
        for pos in sites:
            w0, w1 = max(0, pos - pad), min(n, pos + pad)
            if (
                windows
                and w0 <= windows[-1][1]
                and max(windows[-1][1], w1) - windows[-1][0]
                <= cfg.max_window
            ):
                windows[-1] = (windows[-1][0], max(windows[-1][1], w1))
            else:
                windows.append((w0, w1))

        # batch ALL windows' (read x haplotype) scoring into one device
        # call (the GNU-parallel fan-out of runMegaPath-Amplicon.sh:
        # 122-130, as batch rows instead of processes)
        from megapath_tpu_torch.amplicon.realign import realign_windows_batched

        jobs, job_meta = [], []
        for w0, w1 in windows:
            window = decode_seq(ref.codes[w0:w1])
            support, spans = self._window_reads(
                hits, ok, w0, w1, reads1, lens1, reads2, lens2,
                with_spans=True,
            )
            if not support:
                continue
            jobs.append((window, support))
            job_meta.append((w0, w1, window, spans))
        ras = realign_windows_batched(jobs, k=21, device=self.device)

        found: Dict[Tuple[str, int, str, str], Variant] = {}
        for (w0, w1, window, spans), ra in zip(job_meta, ras):
            has_score = (
                np.asarray(ra.scores).max(axis=1) > 0
                if len(ra.best_hap)
                else np.zeros(0, bool)
            )
            if int(has_score.sum()) < cfg.min_depth:
                continue
            counts = np.bincount(
                ra.best_hap[has_score], minlength=len(ra.haplotypes)
            )
            total = int(has_score.sum())
            span_arr = np.asarray(spans, np.int64).reshape(-1, 2)
            for hj, hap in enumerate(ra.haplotypes):
                if hap == window:
                    continue
                cnt = int(counts[hj])
                # window-level support is only a weak >=2-read gate:
                # reads overlapping just the window edge tie between
                # ref and alt haplotypes (argmax -> ref) and inflate
                # ``total``, so a window-level FRACTION gate starves
                # real alleles (a 0.3-AF alt can hold <0.2 of the
                # window's scored reads). The allele-fraction test
                # happens at the SITE level below, over reads that
                # actually cover the locus.
                if cnt < 2:
                    continue
                for vpos, vref, valt in _hap_variants(
                    window, hap, self.target_engine.params, device=self.device
                ):
                    gpos = w0 + vpos
                    # per-site AF over the SCORED WINDOW SET: both the
                    # alt count and the denominator come from the same
                    # (possibly capped) read sample — dividing the
                    # window-sampled alt count by the genome-wide
                    # pileup depth understated het AFs ~2x and starved
                    # real calls at amplicon depths
                    cov_all = (
                        has_score
                        & (span_arr[:, 0] <= gpos)
                        & (span_arr[:, 1] > gpos)
                    )
                    covers = cov_all & (ra.best_hap == hj)
                    site_alt = int(covers.sum())
                    site_cov = max(int(cov_all.sum()), site_alt, 1)
                    site_depth = max(int(depth[gpos]), site_alt)
                    if site_alt < max(
                        2, cfg.min_allele_frac * site_cov
                    ):
                        continue
                    seq_idx, local = ref.local_pos(np.array([gpos]))
                    key = (ref.names[int(seq_idx[0])], int(local[0]),
                           vref, valt)
                    v = found.get(key)
                    if v is None or site_alt > v.alt_count:
                        found[key] = Variant(
                            seq=key[0], pos=key[1], ref=vref, alt=valt,
                            depth=site_depth, alt_count=site_alt,
                        )
        return sorted(
            found.values(), key=lambda v: (v.seq, v.pos, v.ref, v.alt)
        )

    def _window_reads(
        self, hits, ok, w0, w1, reads1, lens1, reads2, lens2,
        with_spans: bool = False,
    ):
        rows = np.flatnonzero(ok & (hits.start < w1) & (hits.stop > w0))
        # subsample EVENLY when over the cap: hit rows are read-id
        # ordered, so a head slice would silently drop whole read
        # subpopulations (low-AF alleles, later library halves) from
        # the window evidence — an even stride keeps every allele's
        # support proportional
        cap = 96
        if len(rows) > cap:
            rows = rows[np.round(np.linspace(0, len(rows) - 1, cap)).astype(int)]
        out = []
        spans = []
        for i in rows:
            r = int(hits.read[i])
            e = int(hits.end[i])
            strand = int(hits.strand[i])
            reads = reads1 if e == 0 else reads2
            lens = lens1 if e == 0 else lens2
            rl = int(lens[r])
            codes = reads[r, :rl]
            if strand:
                codes = COMPLEMENT[codes[::-1]]
            out.append(decode_seq(codes))
            spans.append((int(hits.start[i]), int(hits.stop[i])))
        if with_spans:
            return out, spans
        return out
