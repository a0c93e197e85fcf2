"""Assembly path (runMegaPath.sh -A, stage 4).

The port's copy of ``megapath_tpu/pipeline/assembly.py`` less the
protein remap (stage 4.1, ROADMAP A9b), held equal to it by
``tests/test_torch_assembly.py``. The reference shells out to bbnorm |
MEGAHIT, then aligns reads back to contigs with soap4
(runMegaPath.sh:267-299). Here:

- viral/unmapped read extraction follows extractFromLSAM.pl -v -t
- digital normalization is filters.bbnorm (host)
- assembly uses MEGAHIT if a binary is provided, else the built-in
  multi-k assembler (pipeline.multik, host); the single-k unitig
  assembler stays beside it
- read->contig alignment reuses the port's AlignEngine on a contig
  index built on the engine's device, so on a card the contigs are
  indexed there and the reads aligned back by the port's kernels
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.output import best_per_seq
from megapath_tpu_torch.align.params import AlignParams, MmpParams
from megapath_tpu_torch.filters.bbnorm import normalize_pairs
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import pack_fasta, pack_reads
from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx
from megapath_tpu_torch.io.lsam import LsamRecord
from megapath_tpu_torch.pipeline.multik import assemble_multik


def extract_viral_and_unmapped(
    lsam_id: Sequence[LsamRecord],
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    threshold: float = 40,
) -> Tuple[List[FastqRecord], List[FastqRecord]]:
    """Pairs that are unmapped (either end under threshold) or viral
    (superkingdom column 'Viruses'), per extractFromLSAM.pl:67-69."""
    by_name: Dict[str, List[LsamRecord]] = defaultdict(list)
    for rec in lsam_id:
        by_name[rec.name].append(rec)
    out1, out2 = [], []
    for a, b in zip(recs1, recs2):
        recs = by_name.get(a.name, [])
        # select ends by flag (0x40 first / 0x80 second), not dict
        # insertion order — duplicate or odd records must not mispair
        r1 = next((r for r in recs if r.flag & 0x40), None)
        r2 = next((r for r in recs if r.flag & 0x80), None)
        if r1 is None or r2 is None:
            continue
        pair_len = len(a.seq) + len(b.seq)
        cut = threshold * pair_len if threshold < 1 else threshold
        viral = "Viruses" in r1.opts or "Viruses" in r2.opts
        if r1.score < cut or r2.score < cut or viral:
            out1.append(a)
            out2.append(b)
    return out1, out2


# ---------------------------------------------------------------------------
# built-in unitig assembler (fallback for MEGAHIT)
# ---------------------------------------------------------------------------


def assemble_unitigs(
    seqs: Sequence[str], k: int = 31, min_count: int = 2, min_len: int = 100
) -> List[str]:
    """Maximal non-branching de Bruijn paths over solid k-mers.

    ``solid`` is a set of strings, so the walk's start order, and with it
    which strand of each unitig is kept, follows the process's string
    hash: the output's text differs between processes as the JAX
    package's does (ROADMAP §C). Within one process both iterate the
    same set built the same way, and agree."""
    counts: Dict[str, int] = defaultdict(int)
    for s in seqs:
        s = s.upper()
        for i in range(len(s) - k + 1):
            km = s[i : i + k]
            if "N" not in km:
                counts[km] += 1
    solid = {km for km, c in counts.items() if c >= min_count}
    if not solid:
        return []

    def exts(km, forward=True):
        core = km[1:] if forward else km[:-1]
        out = []
        for b in "ACGT":
            nxt = core + b if forward else b + core
            if nxt in solid:
                out.append(nxt)
        return out

    visited: Set[str] = set()
    unitigs: List[str] = []
    for start in solid:
        if start in visited:
            continue
        # walk backward to a branch/start
        km = start
        seen_local = {km}
        while True:
            preds = exts(km, forward=False)
            if len(preds) != 1 or len(exts(preds[0], forward=True)) != 1:
                break
            if preds[0] in seen_local:
                break
            km = preds[0]
            seen_local.add(km)
        # walk forward collecting the unitig
        contig = km
        visited.add(km)
        while True:
            nxts = exts(km, forward=True)
            if len(nxts) != 1 or len(exts(nxts[0], forward=False)) != 1:
                break
            nxt = nxts[0]
            if nxt in visited:
                break
            contig += nxt[-1]
            visited.add(nxt)
            km = nxt
        # contigs of both strands emerge separately; dedup by canon
        if len(contig) >= min_len:
            unitigs.append(contig)
    # canonical dedup
    comp = str.maketrans("ACGT", "TGCA")
    seen: Set[str] = set()
    out = []
    for c in sorted(unitigs, key=len, reverse=True):
        canon = min(c, c.translate(comp)[::-1])
        if canon not in seen:
            seen.add(canon)
            out.append(c)
    return out


def run_megahit(
    r1: Sequence[FastqRecord],
    r2: Sequence[FastqRecord],
    megahit_bin: str,
    workdir: Optional[str] = None,
) -> List[str]:
    """External MEGAHIT hook (--presets meta-sensitive, runMegaPath.sh:283)."""
    wd = workdir or tempfile.mkdtemp(prefix="megahit_")
    p1 = os.path.join(wd, "r1.fq")
    p2 = os.path.join(wd, "r2.fq")
    for path, recs in ((p1, r1), (p2, r2)):
        with open(path, "w") as f:
            for r in recs:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    out = os.path.join(wd, "asm")
    subprocess.run(
        [megahit_bin, "--presets", "meta-sensitive", "-1", p1, "-2", p2, "-o", out],
        check=True, capture_output=True,
    )
    return [r.seq for r in read_fastx(os.path.join(out, "final.contigs.fa"))]


@dataclass
class AssemblyResult:
    contigs: List[str]
    read2contig: List[LsamRecord]


def assembly_path(
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    norm_target: int = 70,
    k: int = 31,
    megahit_bin: Optional[str] = None,
    min_contig: int = 100,
    multi_k: bool = True,
    *,
    device: torch.device,
    device_seeding: bool = False,
) -> AssemblyResult:
    """bbnorm -> assemble -> map reads back to contigs (r2c LSAM).

    bbnorm and the assemblers run on the host; the contigs' FM index is
    built on ``device`` and the port's ``AlignEngine`` aligns every
    (un-normalized) pair back to them there, seeding on the device when
    ``device_seeding``."""
    keep = normalize_pairs(
        [r.seq for r in recs1], [r.seq for r in recs2], target=norm_target
    )
    n1 = [r for r, k_ in zip(recs1, keep) if k_]
    n2 = [r for r, k_ in zip(recs2, keep) if k_]

    if megahit_bin:
        contigs = run_megahit(n1, n2, megahit_bin)
    elif multi_k:
        # iterative multi-k with graph cleaning (MEGAHIT contract; on
        # tests/test_assembly.py's uneven-coverage mock it beats single-k
        # on N50 and on every genome's recovery)
        contigs = assemble_multik(
            [r.seq for r in n1] + [r.seq for r in n2], min_len=min_contig
        )
    else:
        contigs = assemble_unitigs(
            [r.seq for r in n1] + [r.seq for r in n2], k=k, min_len=min_contig
        )
    if not contigs:
        return AssemblyResult([], [])

    # index contigs, align all (un-normalized) reads back
    ref = pack_fasta(
        [FastqRecord(f"ctg{i}", c, "", "") for i, c in enumerate(contigs)]
    )
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=8, device=device)
    eng = AlignEngine(
        ref, fm, AlignParams(mmp=MmpParams(seed_min_length=17)),
        device=device, device_seeding=device_seeding,
    )
    L = max(max((len(r.seq) for r in recs1), default=1),
            max((len(r.seq) for r in recs2), default=1))
    reads1, lens1 = pack_reads([r.seq for r in recs1], L)
    reads2, lens2 = pack_reads([r.seq for r in recs2], L)
    hits = eng.align_pairs(reads1, lens1, reads2, lens2)
    table = best_per_seq(hits, len(recs1), megapath_mode=1)

    r2c: List[LsamRecord] = []
    for i in range(len(recs1)):
        for e, recs in ((0, recs1), (1, recs2)):
            d = table[e][i]
            if not d:
                continue
            best = max(d.values())
            r2c.append(
                LsamRecord(
                    name=recs[i].name,
                    flag=0x40 if e == 0 else 0x80,
                    score=int(best),
                    seq="*",
                    qual="*",
                    hits=[(float(s), f"ctg{q}") for q, s in sorted(d.items())],
                )
            )
    return AssemblyResult(contigs, r2c)
