"""Accuracy evaluation vs simulated truth (calcAccuracy.pl equivalent).

The port's copy of ``megapath_tpu/utils/accuracy.py``, held equal to it
and to the reference binaries' goldens by ``tests/test_torch_extras.py``.

The reference scores sensitivity/FDR of classification output against a
simulated read set whose read names encode the source genome
(the reference's calcAccuracy.pl, cc/masonAccuracy.cpp). Reads are
truth-labeled by a name->taxid function; a read is a true positive when
its reported hit set contains the truth taxid (or an ancestor within
``rank_slack`` of it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Set

from megapath_tpu_torch.io.lsam import LsamRecord
from megapath_tpu_torch.taxonomy.taxdb import TaxDB


@dataclass
class AccuracyStats:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    unclassified: int = 0

    @property
    def sensitivity(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fdr(self) -> float:
        d = self.tp + self.fp
        return self.fp / d if d else 0.0


def evaluate(
    records: Iterable[LsamRecord],
    truth_of: Callable[[str], Optional[int]],
    db: TaxDB,
    score_threshold: int = 40,
    match_at_species: bool = True,
) -> AccuracyStats:
    st = AccuracyStats()
    for rec in records:
        truth = truth_of(rec.name)
        if truth is None:
            continue
        truth_sp = db.pop_to_species(truth) if match_at_species else truth
        hits = (
            {int(float(t)) for _, t in rec.hits}
            if rec.score >= score_threshold
            else set()
        )
        if not hits:
            st.unclassified += 1
            st.fn += 1
            continue
        hit_sp = {db.pop_to_species(t) if match_at_species else t for t in hits}
        if truth_sp in hit_sp:
            st.tp += 1
            if len(hit_sp) > 1:
                st.fp += len(hit_sp) - 1
        else:
            st.fn += 1
            st.fp += len(hit_sp)
    return st


# ---------------------------------------------------------------------------
# genCountTable equivalent: per-rank unique/non-unique read counts
# ---------------------------------------------------------------------------


def count_table(db: TaxDB, records: Iterable[LsamRecord]) -> str:
    """Rank-level unique/non-unique hit count table.

    Mirrors the reference's cc/genCountTable.cpp: each read's hit
    taxids walk up to their species/genus/family/superkingdom; a taxon
    whose rank-set for the read is a singleton gets a unique count,
    every member of a larger set gets a non-unique count. Missing
    genus/family ranks get synthetic placeholder nodes (so species
    still roll up). Rows print depth-first under each superkingdom,
    siblings ordered by unique count.
    """
    RANKS = ("superkingdom", "family", "genus", "species")
    uniq: Dict[int, int] = {}
    nonuniq: Dict[int, int] = {}
    sons: Dict[int, Set[int]] = {}
    ROOT = -2
    SYN_G, SYN_F = 1 << 31, 1 << 30  # synthetic-rank tag bits

    def lineage(tid: int):
        sp = g = f = sk = -1
        while tid not in (0, 1):
            r = db.rank_of(tid)
            if r == "species":
                sp = tid
            elif r == "genus":
                g = tid
            elif r == "family":
                f = tid
            elif r == "superkingdom":
                sk = tid
            tid = int(db.parent[tid]) if tid < len(db.parent) else 0
        return sp, g, f, sk

    for rec in records:
        st = {r: set() for r in RANKS}
        for _, t in rec.hits:
            sp, g, f, sk = lineage(int(float(t)))
            if sp < 0:
                continue
            g = g if g >= 0 else sp | SYN_G
            f = f if f >= 0 else g | SYN_F
            st["species"].add(sp)
            st["genus"].add(g)
            st["family"].add(f)
            st["superkingdom"].add(sk)
            sons.setdefault(g, set()).add(sp)
            sons.setdefault(f, set()).add(g)
            sons.setdefault(sk, set()).add(f)
            sons.setdefault(ROOT, set()).add(sk)
        for r in RANKS:
            s = st[r]
            if len(s) == 1:
                t = next(iter(s))
                uniq[t] = uniq.get(t, 0) + 1
            else:
                for t in s:
                    nonuniq[t] = nonuniq.get(t, 0) + 1

    out: List[str] = []

    def emit(tid: int) -> None:
        if tid >= 0 and (tid & (SYN_G | SYN_F)) == 0:
            names = {r: "-" for r in RANKS}
            t = tid
            while t not in (0, 1):
                r = db.rank_of(t)
                if r in names:
                    names[r] = db.name_of(t)
                t = int(db.parent[t]) if t < len(db.parent) else 0
            out.append(
                "\t".join(
                    [db.rank_of(tid)]
                    + [names[r] for r in RANKS]
                    + [str(uniq.get(tid, 0)), str(nonuniq.get(tid, 0))]
                )
            )
        kids = sorted(sons.get(tid, ()), key=lambda s: -uniq.get(s, 0))
        for s in kids:
            emit(s)

    emit(ROOT)
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# m8 coverage / mapping-length statistics (calculate_m8_cov,
# m8_to_mapLen_hist equivalents)
# ---------------------------------------------------------------------------


def _merge_intervals(iv: List[tuple]) -> tuple:
    """Sorted-merge; returns (merged list, total covered length)."""
    if not iv:
        return [], 0
    iv = sorted(iv)
    merged = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    cov = sum(b - a + 1 for a, b in merged)
    return [tuple(m) for m in merged], cov


def _g6(x: float) -> str:
    """C++ ``cout << double`` default formatting (6 significant
    digits, 'inf' for infinities)."""
    return f"{x:.6g}"


def m8_coverage(lines: Iterable[str]) -> str:
    """calculate_m8_cov, BYTE-IDENTICAL to the reference binary
    (the reference's cc/calculate_m8_cov.cpp; golden-pinned in
    tests/test_eval_golden.py): per subject, merged [ss,se] intervals
    (inclusive, swapped when reversed, each with a trailing ';'),
    covered-base total, then every input interval sorted ascending."""
    per: Dict[str, List[tuple]] = {}
    for line in lines:
        cols = line.split()
        if len(cols) < 12:
            continue
        ss, se = int(cols[8]), int(cols[9])
        if ss > se:
            ss, se = se, ss
        per.setdefault(cols[1], []).append((ss, se))
    out = []
    for sid in sorted(per):
        iv = sorted(per[sid])
        merged, cov = _merge_intervals(iv)
        ivs = "".join(f"{a},{b};" for a, b in merged)
        out.append(f"{sid}\t{ivs}\t{cov}")
        for a, b in iv:
            out.append(f"{a} {b}")
    return "\n".join(out) + ("\n" if out else "")


def _fa_lengths(path) -> Dict[str, int]:
    from megapath_tpu_torch.io.fastq import read_fastx

    return {r.name: len(r.seq) for r in read_fastx(path)}


def maplen_stats(
    lines: Iterable[str], ref_fa=None, contig_fa=None
) -> str:
    """m8_to_mapLen_hist, BYTE-IDENTICAL to the reference binary
    (the reference's cc/m8_to_mapLen_hist.cpp; golden-pinned in
    tests/test_eval_golden.py). Per target: a header (with the target
    length when ``ref_fa``/``contig_fa`` FASTAs are given), one row per
    FIRST hit of each query run — ``maplen qlen maplen/qlen
    cumulative_subject_coverage`` in descending (maplen, index) order —
    then the Mapping Ratio / Avg Mapping Length / NC50 summary (NC50 =
    first maplen whose cumulative sum reaches half the target length;
    without FASTAs lengths are 0, matching the C++'s inf ratios)."""
    tlen = _fa_lengths(ref_fa) if ref_fa else {}
    qlen = _fa_lengths(contig_fa) if contig_fa else {}
    calc_avg = bool(ref_fa and contig_fa)
    intervals: Dict[str, List[tuple]] = {}
    q_alens: Dict[str, List[tuple]] = {}  # (maplen, index)
    q_ids: Dict[str, List[str]] = {}
    last_q = None
    for line in lines:
        cols = line.split()
        if len(cols) < 12 or cols[0] == last_q:
            continue
        last_q = cols[0]
        qs, qe, ss, se = (int(cols[6]), int(cols[7]), int(cols[8]), int(cols[9]))
        if ss > se:
            ss, se = se, ss
        sid = cols[1]
        intervals.setdefault(sid, []).append((ss, se))
        rows_t = q_alens.setdefault(sid, [])
        rows_t.append((abs(qe - qs) + 1, len(rows_t)))
        q_ids.setdefault(sid, []).append(cols[0])
    out = []
    for sid in sorted(q_alens):  # std::map iterates keys sorted
        rows = sorted(q_alens[sid], reverse=True)  # (len, idx) desc
        head = f"Target: {sid}"
        if calc_avg:
            head += f"\t{tlen.get(sid, 0)}"
        out.append(head)
        v: List[tuple] = []
        total_map = 0.0
        total_len = 0.0
        nc50 = 0
        for ln, idx in rows:
            v.append(intervals[sid][idx])
            ql = qlen.get(q_ids[sid][idx], 0)
            total_len += ql
            total_map += ln
            _, cov = _merge_intervals(list(v))
            ratio = ln / ql if ql else float("inf")
            out.append(f"{ln}\t{ql}\t{_g6(ratio)}\t{cov}")
            if nc50 == 0 and total_map >= 0.5 * tlen.get(sid, 0):
                nc50 = ln
        mr = total_map / total_len if total_len else float("inf")
        out.append(
            f"Mapping Ratio: {_g6(mr)}\tAvg Mapping Length: "
            f"{_g6(total_map / len(v))}\tNC50: {nc50}"
        )
    return "\n".join(out) + ("\n" if out else "")
