"""Where each read end aligns in a shard, worked out from the shard's text
and the reads alone.

The semantics are MegaPath's stage 2 (``runMegaPath.sh``: soap4 pair-end
alignment of each NT shard with ``-u 750 -F``, then ``-top 95`` over the
hits of all shards), stated plainly:

- A *locus* of a read end in a shard is a place in one of its sequences
  where the end, or its reverse complement, shares an exact match of at
  least ``seed_len`` bases (soap4-nt's ``mmpSeedMinLength``, 17) and
  where the best local alignment of the oriented end in the window from
  ``margin`` bases before to ``margin`` bases after the match's diagonal,
  inside that sequence, scores at least ``max(int(0.2 * length), 30)``.
  Local alignment is Smith-Waterman: match +1, mismatch -2, a gap of k
  bases ``gap_open + (k - 1) * gap_extend`` (-3, -1).
- Two loci of a pair's ends pair properly when they lie on one sequence,
  on opposite strands, the + strand's diagonal not past the - strand's,
  and the fragment from the + strand's diagonal to the end of the - strand
  read spans 1 to ``insert_high`` (750) bases.
- A pair with a proper pair of loci in the shard reports, of each end,
  the loci in a proper pair, each scored as its own score plus its best
  partner's, paired. A pair without one reports every locus of each end
  on its own score, unpaired (``-F``).
- Across shards, each end keeps the loci whose score is at least
  ``top_percentage`` of its best score over the shards (the product in
  float32).

Everything here is plain PyTorch and NumPy: a scan of the text for the
reads' k-mers, and Smith-Waterman along anti-diagonals.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

NEG = -(1 << 24)
SCORING = (1, -2, -3, -1)  # match, mismatch, gap_open, gap_extend


@dataclass(frozen=True)
class Rules:
    """The NT stage's numbers (soap4-nt2.ini, runMegaPath.sh's flags)."""

    seed_len: int = 17
    margin: int = 30
    cutoff_ratio: float = 0.2
    cutoff_lower_bound: int = 30
    insert_high: int = 750
    top_percentage: float = 0.95

    def threshold(self, length: int) -> int:
        return max(int(self.cutoff_ratio * length), self.cutoff_lower_bound)


def revcomp(reads: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The reverse complement of each row within its length (codes
    A, C, G, T = 0..3), zero past it."""
    L = reads.shape[1]
    src = lens.long()[:, None] - 1 - torch.arange(L, device=reads.device)[None]
    rc = 3 - reads.gather(1, src.clamp(min=0)).to(torch.int16)
    return torch.where(src >= 0, rc, torch.zeros_like(rc)).to(torch.uint8)


def local_scores(reads: torch.Tensor, rlens: torch.Tensor, texts: torch.Tensor,
                 tlens: torch.Tensor, scoring=SCORING, block: int = 1 << 15) -> torch.Tensor:
    """The best local alignment score of each read against its text
    (Smith-Waterman with affine gaps), int64 [B]. Rows are filled one
    anti-diagonal at a time; cells past a row's lengths count for
    nothing."""
    out = torch.zeros(len(reads), dtype=torch.int64, device=reads.device)
    for a in range(0, len(reads), block):
        b = min(a + block, len(reads))
        out[a:b] = _local_block(reads[a:b], rlens[a:b], texts[a:b], tlens[a:b], scoring)
    return out


def _local_block(reads, rlens, texts, tlens, scoring) -> torch.Tensor:
    match, mismatch, go, ge = scoring
    dev = reads.device
    B = len(reads)
    R = int(rlens.max()) if B else 0
    T = int(tlens.max()) if B else 0
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    if not R or not T:
        return best.long()
    i = torch.arange(R + 1, device=dev)  # column i holds read base i - 1; 0 is the border
    rd = torch.cat([torch.full((B, 1), 255, dtype=torch.uint8, device=dev),
                    reads[:, :R].to(torch.uint8)], 1)
    tx = texts[:, :T].to(torch.uint8)
    in_read = (i[None] >= 1) & (i[None] <= rlens.long()[:, None])
    zero = torch.zeros((B, R + 1), dtype=torch.int32, device=dev)
    neg = torch.full((B, R + 1), NEG, dtype=torch.int32, device=dev)
    H1, H2, E1, F1 = zero, zero, neg, neg  # anti-diagonals d - 1 and d - 2

    def prev(x, fill):  # x[:, i - 1]
        return torch.cat([torch.full((B, 1), fill, dtype=x.dtype, device=dev), x[:, :-1]], 1)

    for d in range(2, R + T + 1):
        j = d - i  # the text column of each cell of this anti-diagonal
        valid = in_read & ((j >= 1) & (j <= T))[None] & (j[None] <= tlens.long()[:, None])
        t = tx[:, (j - 1).clamp(0, T - 1)]
        s = torch.where(rd == t, match, mismatch).to(torch.int32)
        E = torch.maximum(E1 + ge, H1 + go)  # from (i, j - 1)
        F = torch.maximum(prev(F1, NEG) + ge, prev(H1, 0) + go)  # from (i - 1, j)
        H = torch.maximum(torch.maximum(prev(H2, 0) + s, E), F).clamp_min(0)
        H = torch.where(valid, H, zero)
        E = torch.where(valid, E, neg)
        F = torch.where(valid, F, neg)
        best = torch.maximum(best, H.max(1).values)
        H2, H1, E1, F1 = H1, H, E, F
    return best.long()


def kmer_codes(x: torch.Tensor, k: int) -> torch.Tensor:
    """The code of every k-mer along the last axis, int64 (2 bits a base)."""
    n = x.shape[-1] - k + 1
    c = torch.zeros(x.shape[:-1] + (max(n, 0),), dtype=torch.int64, device=x.device)
    for t in range(k):
        c = c * 4 + x[..., t:t + n].long()
    return c


def seed_hits(text: torch.Tensor, seq_bp: int, queries: torch.Tensor, qlens: torch.Tensor,
              k: int, chunk: int = 1 << 25) -> torch.Tensor:
    """Every (query row, diagonal) at which a k-mer of the row occurs
    exactly in ``text`` inside one sequence (sequences of ``seq_bp``
    each), with that sequence. The diagonal is the text position where
    the row's first base would lie. Returns int64 [M, 3] (row, diagonal,
    sequence), unique rows."""
    dev = text.device
    Q, L = queries.shape
    codes = kmer_codes(queries, k)
    off = torch.arange(codes.shape[1], device=dev)
    ok = off[None] <= qlens.long()[:, None] - k
    qc = codes[ok]
    qr = torch.arange(Q, device=dev)[:, None].expand_as(codes)[ok]
    qo = off[None].expand_as(codes)[ok]
    order = torch.argsort(qc)
    qc, qr, qo = qc[order], qr[order], qo[order]
    found = []
    n = len(text) - k + 1
    for a in range(0, max(n, 0), chunk):
        b = min(a + chunk, n)
        tc = kmer_codes(text[a:b + k - 1], k)
        lo = torch.searchsorted(qc, tc)
        cnt = torch.searchsorted(qc, tc, right=True) - lo
        at = torch.nonzero(cnt).flatten()
        if not len(at):
            continue
        rep = cnt[at]
        first = torch.repeat_interleave(lo[at], rep)
        step = torch.arange(int(rep.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(rep, 0) - rep, rep)
        q = first + step
        pos = torch.repeat_interleave(at + a, rep)
        inside = pos // seq_bp == (pos + k - 1) // seq_bp
        q, pos = q[inside], pos[inside]
        found.append(torch.stack([qr[q], pos - qo[q], pos // seq_bp], 1))
    if not found:
        return torch.zeros((0, 3), dtype=torch.int64, device=dev)
    return torch.unique(torch.cat(found), dim=0)


@dataclass
class Locus:
    strand: int  # 0: the end as read, 1: its reverse complement
    seq: int  # the sequence's index in the shard
    lo: int  # the window, in the shard's text coordinates
    hi: int
    diag: int  # the first diagonal of its seed matches
    raw: int  # the best local alignment score in the window
    score: int = 0  # as reported: raw, or raw plus the best partner's
    paired: bool = False


def shard_loci(text: torch.Tensor, seq_bp: int, reads: List[torch.Tensor],
               lens: List[torch.Tensor], rules: Rules = Rules()) -> List[List[List[Locus]]]:
    """The loci each pair reports in one shard, as the module's docstring
    states them: ``out[k][e]`` the loci of end e of the k-th pair of
    ``reads`` (two uint8 [K, L] tensors, one an end, on the text's
    device), with ``score`` and ``paired`` set."""
    dev = text.device
    K = len(lens[0])
    L = max(int(r.shape[1]) for r in reads)
    oriented, olens = [], []
    for e in (0, 1):
        r = reads[e][:, :L].to(dev)
        n = lens[e].to(dev)
        oriented += [r, revcomp(r, n)]
        olens += [n, n]
    # row (k * 2 + e) * 2 + strand
    Q = torch.stack(oriented, 1).reshape(4 * K, L)
    QL = torch.stack(olens, 1).reshape(4 * K)
    hits = seed_hits(text, seq_bp, Q, QL, rules.seed_len)
    # a locus: the diagonals of one row within one sequence at most
    # ``margin`` apart (``seed_hits`` sorts its rows)
    row, diag, seq = hits[:, 0], hits[:, 1], hits[:, 2]
    new = torch.ones(len(row), dtype=torch.bool, device=dev)
    if len(row) > 1:
        new[1:] = (row[1:] != row[:-1]) | (seq[1:] != seq[:-1]) | (
            diag[1:] - diag[:-1] > rules.margin)
    gid = torch.cumsum(new.long(), 0) - 1
    G = int(gid[-1]) + 1 if len(gid) else 0
    g_row = row[new]
    g_seq = seq[new]
    g_first = diag[new]
    g_last = torch.full((G,), -(1 << 62), dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, diag, "amax")
    g_len = QL[g_row].long()
    lo = torch.maximum(g_first - rules.margin, g_seq * seq_bp)
    hi = torch.minimum(g_last + g_len + rules.margin, (g_seq + 1) * seq_bp)
    W = int((hi - lo).max()) if G else 0
    win = (lo[:, None] + torch.arange(W, device=dev)[None]).clamp(0, len(text) - 1)
    raw = local_scores(Q[g_row], QL[g_row], text[win], (hi - lo).clamp(min=0))

    out: List[List[List[Locus]]] = [[[], []] for _ in range(K)]
    host = torch.stack([g_row, g_seq, lo, hi, g_first, raw, g_len]).cpu().numpy()
    for r, s, a, b, d, sc, ln in host.T:
        if sc < rules.threshold(int(ln)):
            continue
        k, e, strand = int(r) // 4, (int(r) // 2) % 2, int(r) % 2
        out[k][e].append(Locus(strand, int(s), int(a), int(b), int(d), int(sc)))
    for k in range(K):
        _pair(out[k], [int(lens[0][k]), int(lens[1][k])], rules)
    return out


def _pair(ends: List[List[Locus]], lens: List[int], rules: Rules) -> None:
    """Score one pair's loci as reported, in place: the loci in a proper
    pair, or (none) every locus on its own."""
    best = [dict(), dict()]  # end -> {locus index: best partner's raw}
    for i, a in enumerate(ends[0]):
        for j, b in enumerate(ends[1]):
            if a.seq != b.seq or a.strand == b.strand:
                continue
            p, m, me = (a, b, 1) if a.strand == 0 else (b, a, 0)
            span = m.diag + lens[me] - p.diag
            if m.diag < p.diag or not 1 <= span <= rules.insert_high:
                continue
            best[0][i] = max(best[0].get(i, 0), b.raw)
            best[1][j] = max(best[1].get(j, 0), a.raw)
    if best[0]:
        for e in (0, 1):
            ends[e][:] = [replace(x, score=x.raw + best[e][i], paired=True)
                          for i, x in enumerate(ends[e]) if i in best[e]]
    else:
        for e in (0, 1):
            ends[e][:] = [replace(x, score=x.raw) for x in ends[e]]


def top_set(per_shard: List[Dict[Tuple, int]], top_percentage: float) -> frozenset:
    """Of one read end's loci over the shards (``per_shard[s]``: locus key
    -> score), those the tail keeps: score at least ``top_percentage`` of
    the best (the product in float32), as (shard, key, score)."""
    best = max((v for d in per_shard for v in d.values()), default=0)
    if best <= 0:
        return frozenset()
    floor = int(np.float32(top_percentage) * np.float32(best))
    return frozenset((s, key, v) for s, d in enumerate(per_shard) for key, v in d.items()
                     if v >= floor)
