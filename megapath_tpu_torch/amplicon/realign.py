"""Window realignment: reads vs candidate haplotypes via batched SSW.

Equivalent of the reference's realigner.cpp + ssw.c flow
(MegaPath: scripts/realignment/): per variant window, build
candidate haplotypes (de Bruijn consensus), score every read against
every haplotype with affine-gap local alignment, assign reads to their
best haplotype, and project read positions back to reference
coordinates through the haplotype<->reference alignment. The striped
SSE2 SW kernel becomes one batched device DP call over the
(reads x haplotypes) cross product.

The port's copy of ``megapath_tpu/amplicon/realign.py``, held equal to it
by ``tests/test_torch_amplicon.py``. Every DP call of the JAX version
(``sw_align`` at ``SSW_PARAMS``) goes through ``dna_dp``, that is
``ops.dp.sw_align_dna`` on the keyword-only ``device``: the plain version
on the CPU, the ``sw_subst.cu`` kernel under a match/mismatch table on a
card. The tracebacks stay on the host (``ops.dp.sw_traceback``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from megapath_tpu_torch.amplicon.debruijn import candidate_haplotypes
from megapath_tpu_torch.index.pack import encode_seq
from megapath_tpu_torch.ops.dp import DPParams, sw_align_dna, sw_traceback

# ssw defaults used by the reference realigner (realign_illumina_reads
# passes match=4, mismatch=6, gapO=8, gapE=2 scaled; we keep the
# classic SSW defaults here and expose params)
SSW_PARAMS = DPParams(match=4, mismatch=-6, gap_open=-8, gap_extend=-2)


@dataclass
class WindowRealignment:
    haplotypes: List[str]
    best_hap: np.ndarray  # int32 [n_reads] index into haplotypes
    scores: np.ndarray  # int32 [n_reads, n_haps]
    read_pos: np.ndarray  # int32 [n_reads] window-relative new start (-1 unaligned)
    cigars: List[str]


def dna_dp(
    reads: np.ndarray,  # uint8 [B, R]
    refs: np.ndarray,  # uint8 [B, W]
    read_lens: np.ndarray,  # int32 [B]
    ref_lens: np.ndarray,  # int32 [B]
    params: DPParams,
    *,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sw_align_dna`` on ``device`` over host arrays: the codes go to the
    device once, with their largest read here for its code check, and
    (score, end_ref, end_read) come back once, as int32 numpy arrays. A
    CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the DNA DP on {device}: CUDA is not available")
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
         for a, dt in ((reads, np.uint8), (refs, np.uint8),
                       (read_lens, np.int32), (ref_lens, np.int32))]
    top = max((int(a.max()) for a in (reads, refs) if a.size), default=0)
    out = torch.stack(tuple(sw_align_dna(*t, params, max_code=top))).cpu().numpy()
    return out[0], out[1], out[2]


def _pad_batch(seqs: Sequence[str], L: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.zeros((len(seqs), L), dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s[:L])
        out[i, : len(c)] = c
        lens[i] = len(c)
    return out, lens


def realign_window(
    ref_window: str,
    reads: Sequence[str],
    k: int = 21,
    min_edge_weight: int = 2,
    params: DPParams = SSW_PARAMS,
    compute_cigars: bool = True,
    *,
    device: torch.device,
) -> WindowRealignment:
    """Realign reads in one window against dBG candidate haplotypes."""
    haps = candidate_haplotypes(ref_window, reads, k=k, min_edge_weight=min_edge_weight)
    n_r, n_h = len(reads), len(haps)
    if n_r == 0:
        return WindowRealignment(haps, np.zeros(0, np.int32), np.zeros((0, n_h), np.int32), np.zeros(0, np.int32), [])

    Lr = max(len(r) for r in reads)
    Lh = max(len(h) for h in haps)
    reads_arr, read_lens = _pad_batch(reads, Lr)
    haps_arr, hap_lens = _pad_batch(haps, Lh)

    # cross product batch: read i vs hap j at row i*n_h + j
    R = np.repeat(reads_arr, n_h, axis=0)
    RL = np.repeat(read_lens, n_h)
    H = np.tile(haps_arr, (n_r, 1))
    HL = np.tile(hap_lens, n_r)
    score, end_ref, end_read = dna_dp(R, H, RL, HL, params, device=device)
    scores = score.reshape(n_r, n_h)
    ends_ref = end_ref.reshape(n_r, n_h)
    ends_read = end_read.reshape(n_r, n_h)

    best = scores.argmax(axis=1).astype(np.int32)

    # align each chosen haplotype to the reference window once, to map
    # haplotype coordinates back to window coordinates
    hap_to_ref: List[Optional[Tuple[int, int, str]]] = []
    ref_codes = encode_seq(ref_window)
    for h in haps:
        hc = encode_seq(h)
        _, h_ref, h_read = dna_dp(
            hc[None, :], ref_codes[None, :],
            np.array([len(hc)], np.int32), np.array([len(ref_codes)], np.int32),
            params, device=device,
        )
        he = int(h_ref[0])
        hj = int(h_read[0])
        si, sj, cig, _ = sw_traceback(hc[:hj], ref_codes[:he], he, hj, params)
        hap_to_ref.append((si - sj, he, cig))  # approx: ref offset of hap start

    read_pos = np.full(n_r, -1, np.int32)
    cigars: List[str] = []
    for i in range(n_r):
        j = int(best[i])
        if scores[i, j] <= 0:
            cigars.append("*")
            continue
        er, ej = int(ends_ref[i, j]), int(ends_read[i, j])
        if compute_cigars:
            hc = encode_seq(haps[j])
            rc = encode_seq(reads[i])
            si, sj, cig, _ = sw_traceback(rc[:ej], hc[:er], er, ej, params)
            cigars.append(cig)
            hap_start = si
        else:
            cigars.append("*")
            hap_start = er - ej
        ref_off = hap_to_ref[j][0]
        read_pos[i] = ref_off + hap_start
    return WindowRealignment(haps, best, scores, read_pos, cigars)


# ---------------------------------------------------------------------------
# Reference-faithful window realigner (realigner.cpp transliteration,
# with the SSW scoring batched on device)
# ---------------------------------------------------------------------------

_KMER = 32
_MAX_MM = 2


def realign_windows_batched(
    jobs: Sequence[Tuple[str, Sequence[str]]],
    k: int = 21,
    min_edge_weight: int = 2,
    params: DPParams = SSW_PARAMS,
    *,
    device: torch.device,
) -> List[WindowRealignment]:
    """Score ALL windows' (read x haplotype) products in ONE device DP
    call (the reference fans per-amplicon jobs out via GNU parallel,
    runMegaPath-Amplicon.sh:122-130; here the windows become rows of a
    single batch). Equivalent to per-window
    ``realign_window(..., compute_cigars=False)`` calls."""
    metas = []  # (n_r, n_h, haps)
    rows_reads: List[str] = []
    rows_haps: List[str] = []
    for ref_window, reads in jobs:
        haps = candidate_haplotypes(
            ref_window, reads, k=k, min_edge_weight=min_edge_weight
        )
        metas.append((len(reads), len(haps), haps))
        for r in reads:
            for h in haps:
                rows_reads.append(r)
                rows_haps.append(h)
    out: List[WindowRealignment] = []
    if rows_reads:
        Lr = max(len(r) for r in rows_reads)
        Lh = max(len(h) for h in rows_haps)
        R, RL = _pad_batch(rows_reads, Lr)
        H, HL = _pad_batch(rows_haps, Lh)
        all_scores = dna_dp(R, H, RL, HL, params, device=device)[0]
    ofs = 0
    for n_r, n_h, haps in metas:
        cnt = n_r * n_h
        scores = (
            all_scores[ofs : ofs + cnt].reshape(n_r, n_h)
            if cnt
            else np.zeros((n_r, max(n_h, 1)), np.int32)
        )
        ofs += cnt
        best = (
            scores.argmax(axis=1).astype(np.int32)
            if n_h
            else np.zeros(n_r, np.int32)
        )
        out.append(WindowRealignment(
            haps, best, scores, np.full(n_r, -1, np.int32), ["*"] * n_r
        ))
    return out


def _cigar_ops(cig: str) -> List[Tuple[str, int]]:
    out, n = [], 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((ch, n))
            n = 0
    return out


def _ops_str(ops: List[Tuple[str, int]]) -> str:
    return "".join(f"{n}{o}" for o, n in ops)


def _aligned_len(ops) -> int:
    """Read-consuming length (M/S/I/=/X), AlignedLength in realigner.cpp."""
    return sum(n for o, n in ops if o in "MSI=X")


def _merge_op(op, read_len, ops):
    """MergeCigarOp: clamp read-consuming ops to the remaining read."""
    o, n = op
    before = _aligned_len(ops)
    if o != "D":
        n = min(n, read_len - before)
    if n <= 0 or before == read_len:
        return
    if ops and ops[-1][0] == o:
        ops[-1] = (o, ops[-1][1] + n)
    else:
        ops.append((o, n))


def _positions_map(hap_len: int, cigar: str) -> np.ndarray:
    """SetPositionsMap: per-haplotype-position shift to ref coords."""
    pm = np.zeros(hap_len, np.int32)
    shift = 0
    pos = 0
    for o, n in _cigar_ops(cigar):
        if o in "=XM":
            pm[pos : pos + n] = shift
            pos += n
        elif o == "S":
            shift -= n
            pm[pos : pos + n] = shift
            pos += n
        elif o == "D":
            shift += n
        elif o == "I":
            for _ in range(n):
                pm[pos] = shift
                shift -= 1
                pos += 1
    return pm


def _left_trim(h2r_ops, r2h_pos):
    """LeftTrimHaplotypeToRefAlignment."""
    ops = list(h2r_ops)
    cur = 0
    while cur != r2h_pos:
        o, n = ops.pop(0)
        if o in "M=XSI" or o == "H":
            if n + cur > r2h_pos:
                ops.insert(0, (o, n - (r2h_pos - cur)))
            cur = min(n + cur, r2h_pos)
    if ops and ops[0][0] == "D":
        ops.pop(0)
    return ops


def _norm_match(o: str) -> str:
    return "M" if o in "=X" else o


def _splice_cigar(read_len, r2h_cigar, r2h_pos, h2r_ops):
    """CalculateReadToRefAlignment: read->hap x hap->ref -> read->ref."""
    r2h = [(_norm_match(o), n) for o, n in _cigar_ops(r2h_cigar)]
    h2r = [(_norm_match(o), n) for o, n in _left_trim(h2r_ops, r2h_pos)]
    out: List[Tuple[str, int]] = []
    if r2h and r2h[0][0] == "S":
        _merge_op(r2h.pop(0), read_len, out)
    while (r2h or h2r) and _aligned_len(out) < read_len:
        if r2h and not h2r:
            _merge_op(r2h.pop(0), read_len, out)
            continue
        if not r2h and h2r:
            break
        a = r2h.pop(0)
        b = h2r.pop(0)
        ao, al = a
        bo, bl = b
        both_m = ao in "MS" and bo in "MS"
        if both_m:
            n = min(al, bl)
            _merge_op(("S" if "S" in (ao, bo) else "M", n), read_len, out)
            if al - n > 0:
                r2h.insert(0, (ao, al - n))
            if bl - n > 0:
                h2r.insert(0, (bo, bl - n))
        elif ao == "D" and bo == "M":
            _merge_op(("D", al), read_len, out)
            if bl - al > 0:
                h2r.insert(0, (bo, bl - al))
        elif ao == "M" and bo == "D":
            _merge_op(("D", bl), read_len, out)
            r2h.insert(0, a)
        elif ao == "D" and bo == "D":
            _merge_op(("D", al + bl), read_len, out)
        elif ao == "I" and bo == "M":
            n = min(read_len - _aligned_len(out), al)
            _merge_op(("I", n), read_len, out)
            h2r.insert(0, b)
        elif ao == "M" and bo == "I":
            n = min(read_len - _aligned_len(out), bl)
            _merge_op(("I", n), read_len, out)
            if al - bl > 0:
                r2h.insert(0, (ao, al - bl))
        elif ao == "I" and bo == "I":
            _merge_op(("I", al + bl), read_len, out)
        else:
            return []
    return out


def _fast_align(hap: str, reads: Sequence[str], ref: str,
                ref_prefix: int, ref_suffix: int,
                match: int = 4, mismatch: int = 6):
    """FastAlignReadsToHaplotype: 32-mer anchored <=2-mismatch scan."""
    n = len(reads)
    score = np.zeros(n, np.int64)
    pos = np.full(n, -1, np.int64)
    cig = [""] * n
    hap_score = 0
    idx: Dict[str, List[Tuple[int, int]]] = {}
    for rid, r in enumerate(reads):
        if len(r) <= _KMER:
            continue
        for i in range(len(r) - _KMER + 1):
            idx.setdefault(r[i : i + _KMER], []).append((rid, i))
    coverage = np.zeros(len(hap), np.int64)
    is_ref = hap == ref
    for i in range(len(hap) - _KMER + 1):
        anchors = idx.get(hap[i : i + _KMER])
        if anchors is None:
            # the reference 'continue's on a k-mer miss BEFORE its
            # coverage check (realigner.cpp:179-181), so the zeroing
            # below only fires at positions whose k-mer is in the index
            continue
        for rid, rpos in anchors:
            tgt = max(0, i - rpos)
            r = reads[rid]
            if tgt + len(r) > len(hap):
                continue
            if pos[rid] != -1 and pos[rid] == tgt:
                continue
            seg = hap[tgt : tgt + len(r)]
            mm = 0
            nmatch = 0
            dead = False
            for c1, c2 in zip(seg, r):
                if c1 != c2 and c1 != "N" and c2 != "N":
                    mm += 1
                    if mm == _MAX_MM + 1:
                        dead = True
                        break
                else:
                    nmatch += 1
            new_score = 0 if dead else nmatch * match - mm * mismatch
            if not dead and mm <= _MAX_MM:
                old = int(score[rid])
                coverage[tgt : tgt + len(r)] += 1
                if old < new_score:
                    score[rid] = new_score
                    hap_score += new_score - old
                    pos[rid] = tgt
                    cig[rid] = f"{len(r)}="
        if (coverage[i] == 0 and i >= ref_prefix
                and i < len(hap) - ref_suffix and not is_ref):
            return np.zeros(n, np.int64), np.full(n, -1, np.int64), [""] * n, 0
    return score, pos, cig, hap_score


def _ssw_one(query: str, target: str, params: DPParams, *, device: torch.device):
    """Device DP + host traceback, SSW-style cigar with soft clips."""
    qc, tc = encode_seq(query), encode_seq(target)
    score, end_ref, end_read = dna_dp(
        qc[None, :], tc[None, :],
        np.array([len(qc)], np.int32), np.array([len(tc)], np.int32),
        params, device=device,
    )
    sc = int(score[0])
    if sc <= 0:
        return 0, -1, ""
    et, eq = int(end_ref[0]), int(end_read[0])
    # sw_traceback returns (start_ref, start_read, ...) — target first
    st, sq, cigar, _ = sw_traceback(qc[:eq], tc[:et], et, eq, params)
    ops = _cigar_ops(cigar)
    pre, post = sq, len(qc) - eq
    full = ([("S", pre)] if pre else []) + [
        (_norm_match(o), n) for o, n in ops
    ] + ([("S", post)] if post else [])
    return sc, st, _ops_str(full)


def realign_reads_window(
    reads: Sequence[str],
    positions: Sequence[int],
    cigars: Sequence[str],
    reference: str,
    haplotypes: Sequence[str],
    ref_start: int,
    ref_prefix: int,
    ref_suffix: int,
    params: DPParams = SSW_PARAMS,
    *,
    device: torch.device,
) -> Tuple[List[int], List[str]]:
    """The realigner.cpp AlignReads flow (scripts/realignment/realign/
    realigner.cpp:88-470): fast k-mer-anchored read->haplotype scores,
    SSW fallback for unanchored reads, haplotype->reference alignment,
    position-map projection and cigar splicing. Returns (new_positions,
    new_cigars); reads without a best haplotype keep their input."""
    n = len(reads)
    haps = list(haplotypes)
    rows = []
    for hi, hap in enumerate(haps):
        score, pos, cig, hap_score = _fast_align(
            hap, reads, reference, ref_prefix, ref_suffix,
            match=params.match, mismatch=-params.mismatch,
        )
        rows.append({
            "hap_index": hi, "score": score, "pos": pos, "cig": cig,
            "hap_score": hap_score,
        })

    # hap -> reference (SSW)
    for row in rows:
        hap = haps[row["hap_index"]]
        sc, ref_pos, cigar = _ssw_one(hap, reference, params, device=device)
        row["is_ref"] = cigar == f"{len(hap)}M" and hap in reference
        # faithful AlignmentIsRef tests the '=' full-match cigar; ours
        # normalizes to M, so require exact substring containment too
        row["h2r_cigar"] = cigar
        row["ref_pos"] = ref_pos
        row["pm"] = _positions_map(len(hap), cigar) if sc > 0 else None

    # SSW fallback for reads with no fast alignment on any haplotype
    thresh = 1  # CalculateSswAlignmentScoreThreshold clamps negative -> 1
    for rid in range(n):
        if any(row["score"][rid] > 0 for row in rows):
            continue
        for row in rows:
            if row["hap_score"] == 0:
                continue
            sc, p, cigar = _ssw_one(reads[rid], haps[row["hap_index"]], params,
                                    device=device)
            if sc > 0 and sc >= thresh and row["score"][rid] < sc:
                row["score"][rid] = sc
                row["pos"][rid] = p
                row["cig"][rid] = cigar

    rows.sort(key=lambda r: r["hap_score"])  # HaplotypeReadsAlignment <

    out_pos, out_cig = list(positions), list(cigars)
    for rid in range(n):
        best, bi = 0, -1
        for i, row in enumerate(rows):
            s = int(row["score"][rid])
            if s > best or (best > 0 and s == best and not row["is_ref"]):
                best, bi = s, i
        if bi < 0:
            continue
        row = rows[bi]
        if row["pm"] is None or row["ref_pos"] < 0:
            continue
        r2h_pos = int(row["pos"][rid])
        new_pos = (ref_start + row["ref_pos"] + r2h_pos
                   + int(row["pm"][r2h_pos]))
        spliced = _splice_cigar(
            len(reads[rid]), row["cig"][rid], r2h_pos,
            _cigar_ops(row["h2r_cigar"]),
        )
        if spliced:
            out_pos[rid] = new_pos
            out_cig[rid] = _ops_str(spliced)
    return out_pos, out_cig
