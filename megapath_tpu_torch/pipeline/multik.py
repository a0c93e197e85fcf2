"""Multi-k iterative de Bruijn assembly (MEGAHIT-contract fallback).

The port's copy of ``megapath_tpu/pipeline/multik.py``, held equal to it
by ``tests/test_torch_assembly.py``.

The reference runs MEGAHIT ``--presets meta-sensitive`` — a multi-k
succinct-dBG assembler with error-pruned iteration
(runMegaPath.sh:279-283). This module lifts the
built-in single-k unitig assembler toward that contract:

* iterate k over an ascending list (21 -> 41 -> 61 -> 81 by default):
  small k connects low-coverage regions, large k resolves repeats;
* contigs from pass k-1 feed forward into pass k (their k-mers are
  seeded at solid weight, the MEGAHIT "contig as super-read" step);
* per-k graph cleaning before unitig extraction:
  - tip clipping: dead-end unitigs shorter than 2k with coverage
    below a fraction of their junction neighbor's;
  - bubble popping: parallel unitigs sharing both junctions, the
    lower-coverage branch removed;
* the k-mer domain is int-encoded (2 bits/char) with canonical-free
  double-strand insertion, matching the single-k assembler's
  semantics.

Pure host-side Python/numpy: assembly input sizes here are the viral/
unmapped leftovers (runMegaPath.sh:274 extracts them before MEGAHIT),
orders of magnitude below the aligner's load. The external MEGAHIT
hook (pipeline.assembly.run_megahit) remains the production choice
when a binary exists.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
BASES = "ACGT"


def _count_kmers(
    seqs: Iterable[str], k: int, weights: Optional[Iterable[int]] = None
) -> Dict[int, int]:
    counts: Dict[int, int] = defaultdict(int)
    mask = (1 << (2 * k)) - 1
    wit = iter(weights) if weights is not None else None
    for s in seqs:
        w = next(wit) if wit is not None else 1
        val = 0
        run = 0
        for ch in s.upper():
            c = CODE.get(ch)
            if c is None:
                run = 0
                val = 0
                continue
            val = ((val << 2) | c) & mask
            run += 1
            if run >= k:
                counts[val] += w
    return counts


def _exts(solid: Dict[int, int], km: int, k: int, forward: bool) -> List[int]:
    mask = (1 << (2 * k)) - 1
    out = []
    if forward:
        core = (km << 2) & mask
        for b in range(4):
            n = core | b
            if n in solid:
                out.append(n)
    else:
        core = km >> 2
        for b in range(4):
            n = core | (b << (2 * (k - 1)))
            if n in solid:
                out.append(n)
    return out


def _decode(km: int, k: int) -> str:
    return "".join(BASES[(km >> (2 * (k - 1 - i))) & 3] for i in range(k))


class _Unitig:
    __slots__ = ("kmers", "cov", "seq")

    def __init__(self, kmers: List[int], cov: float, k: int):
        self.kmers = kmers
        self.cov = cov
        self.seq = _decode(kmers[0], k) + "".join(
            BASES[km & 3] for km in kmers[1:]
        )


def _build_unitigs(solid: Dict[int, int], k: int) -> List[_Unitig]:
    """Maximal non-branching paths with mean coverage."""
    visited: Set[int] = set()
    out: List[_Unitig] = []
    for start in list(solid):
        if start in visited:
            continue
        km = start
        seen_local = {km}
        while True:
            preds = _exts(solid, km, k, forward=False)
            if len(preds) != 1 or len(_exts(solid, preds[0], k, True)) != 1:
                break
            if preds[0] in seen_local:
                break
            km = preds[0]
            seen_local.add(km)
        path = [km]
        visited.add(km)
        while True:
            nxts = _exts(solid, km, k, forward=True)
            if len(nxts) != 1 or len(_exts(solid, nxts[0], k, False)) != 1:
                break
            nxt = nxts[0]
            if nxt in visited:
                break
            path.append(nxt)
            visited.add(nxt)
            km = nxt
        cov = sum(solid[x] for x in path) / len(path)
        out.append(_Unitig(path, cov, k))
    return out


def _clean_graph(
    solid: Dict[int, int], k: int, tip_ratio: float = 0.3,
    bubble_ratio: float = 0.7, rounds: int = 3,
) -> Dict[int, int]:
    """Tip clipping + bubble popping at the k-mer-set level."""
    for _ in range(rounds):
        unis = _build_unitigs(solid, k)
        if not unis:
            return solid
        # junction adjacency: map each unitig's outside neighbors
        drop: Set[int] = set()
        # index unitigs by their terminal kmers for bubble detection
        by_ends: Dict[Tuple[int, int], List[_Unitig]] = defaultdict(list)
        for u in unis:
            first, last = u.kmers[0], u.kmers[-1]
            preds = tuple(sorted(_exts(solid, first, k, forward=False)))
            succs = tuple(sorted(_exts(solid, last, k, forward=True)))
            # tips: one dead junction, short, weak vs the neighborhood
            if (not preds or not succs) and len(u.seq) < 2 * k:
                nb_cov = 0.0
                for nb in (*preds, *succs):
                    nb_cov = max(nb_cov, float(solid.get(nb, 0)))
                if not preds and not succs:
                    # isolated islands: real rare-genome fragments have
                    # cov >= ~2 or meaningful length; singleton error
                    # chains (min_count=1 mode) have neither
                    if u.cov < 2.0 and len(u.seq) < 3 * k:
                        drop.update(u.kmers)
                    continue
                if u.cov <= max(2.0, tip_ratio * nb_cov):
                    drop.update(u.kmers)
                    continue
            if preds and succs:
                by_ends[(preds, succs)].append(u)
        # junction-relative pruning (MEGAHIT's local low-depth filter):
        # among sibling branches leaving the same junction, a branch
        # whose coverage is a small fraction of the dominant sibling's
        # is an error path even if its own count passed min_count
        by_first: Dict[int, List[_Unitig]] = defaultdict(list)
        by_last: Dict[int, List[_Unitig]] = defaultdict(list)
        for u in unis:
            by_first[u.kmers[0]].append(u)
            by_last[u.kmers[-1]].append(u)
        for u in unis:
            if u.kmers[0] in drop:
                continue
            preds = _exts(solid, u.kmers[0], k, forward=False)
            sibs: List[_Unitig] = []
            for p in preds:
                for nxt in _exts(solid, p, k, forward=True):
                    for v in by_first.get(nxt, ()):
                        if v is not u:
                            sibs.append(v)
            if sibs:
                mx = max(v.cov for v in sibs)
                if u.cov < 3.0 and u.cov <= 0.1 * mx:
                    drop.update(u.kmers)
        # bubbles: same junction context, keep the strongest branch
        for (_, _), group in by_ends.items():
            if len(group) < 2:
                continue
            group.sort(key=lambda u: (-u.cov, -len(u.kmers)))
            best = group[0]
            for u in group[1:]:
                if (
                    abs(len(u.seq) - len(best.seq)) <= k
                    and u.cov <= bubble_ratio * best.cov
                ):
                    drop.update(u.kmers)
        if not drop:
            break
        for km in drop:
            solid.pop(km, None)
    return solid


def assemble_multik(
    seqs: Sequence[str],
    k_list: Sequence[int] = (21, 41, 61, 81),
    min_count: int = 2,
    min_len: int = 100,
) -> List[str]:
    """Iterative multi-k assembly of ``seqs``; returns contigs.

    Each pass counts read k-mers plus the previous pass's contigs at
    solid weight, cleans the graph (tips/bubbles), and extracts
    unitigs. ks longer than the reads contribute via carried contigs
    only."""
    max_read = max((len(s) for s in seqs), default=0)
    contigs: List[str] = []
    for k in k_list:
        if k >= max_read and not any(len(c) > k for c in contigs):
            break
        counts = _count_kmers(seqs, k)
        if contigs:
            # carried contigs stay solid regardless of read support
            for km, c in _count_kmers(contigs, k).items():
                counts[km] = counts.get(km, 0) + min_count * c
        solid = {km: c for km, c in counts.items() if c >= min_count}
        if not solid:
            continue
        solid = _clean_graph(dict(solid), k)
        unis = _build_unitigs(solid, k)
        cand = [u.seq for u in unis if len(u.seq) >= max(min_len, k + 1)]
        contigs = _dedup(cand) or contigs
    return [c for c in contigs if len(c) >= min_len]


def _dedup(contigs: List[str]) -> List[str]:
    """Canonical-strand dedup + containment prune (suffix-free set)."""
    comp = str.maketrans("ACGT", "TGCA")
    out: List[str] = []
    kept: List[str] = []
    for c in sorted(contigs, key=len, reverse=True):
        rc = c.translate(comp)[::-1]
        canon = min(c, rc)
        contained = False
        for big in kept:
            if c in big or rc in big:
                contained = True
                break
        if not contained:
            kept.append(c)
            out.append(c)
        _ = canon
    return out


def n50(contigs: Sequence[str]) -> int:
    lens = sorted((len(c) for c in contigs), reverse=True)
    total = sum(lens)
    acc = 0
    for ln in lens:
        acc += ln
        if 2 * acc >= total:
            return ln
    return 0


def genome_recovery(
    contigs: Sequence[str], genome: str, k: int = 31
) -> float:
    """Fraction of the genome's k-mers covered by the contigs (either
    strand) — the recovery metric of the assembly quality tests."""
    gk = set(_count_kmers([genome], k))
    if not gk:
        return 0.0
    comp = str.maketrans("ACGT", "TGCA")
    ck = set(_count_kmers(contigs, k))
    ck |= set(_count_kmers([c.translate(comp)[::-1] for c in contigs], k))
    return len(gk & ck) / len(gk)
