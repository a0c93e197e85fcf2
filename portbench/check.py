"""The comparison that decides ``correct``.

After the window, a sample of pairs drawn from the seed (``sample``) is
worked out by the plain reference (``portbench/reference/align.py``: the
loci of each read end found by a scan of each shard's text for its
k-mers, scored by a plain Smith-Waterman, paired and reported by the NT
stage's rules), and the hit tables of every batch the window completed
are held to it on those pairs. Two numbers, each a count of the sampled
pairs that differ in at least one completed batch (``Bench.checks``: a
pool batch comes round many times in a window, and a pair counts once):

- ``rows_wrong``: pairs with a row, in some shard's table, that is not
  what it says: its ``raw_score`` is not the plain local alignment score
  of the end (reverse-complemented on strand 1) against the text from
  ``start`` to ``stop``, or it is under the threshold; its ``seq`` is not
  the sequence that span lies in; or its ``score`` is neither its
  ``raw_score`` (unpaired) nor that plus the ``raw_score`` of a row of the
  other end on the same sequence and the other strand (paired). Exact:
  limit 0.
- ``top_locus_missed``: pairs at which, for some end and shard, no row
  lies in a locus the reference scores at 95% or more of the end's best
  in that shard, where the reference finds one; or a row lies at no
  locus of the reference. Each shard's best loci are what ``-top 95``
  chooses the best shard of a pair from.

``READINGS`` adds numbers the limits' look reads (``control.py``) and no
run compares: ``best_differ`` (an end's best score, best raw score or
best loci in some shard differ), ``best_shard_differ`` (its best score
over the shards, the first shard holding it, or the shards within 95%
of it differ), ``loci_differ`` (every locus with its scores) and
``top_loci_differ`` (the loci ``-top 95`` keeps over all shards).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import sys
import time

import numpy as np
import torch

from portbench.gen import Batch, Database
from portbench.reference.align import Rules, local_scores, revcomp, shard_loci, top_set

FIELDS = ("end", "seq", "score", "raw_score", "start", "stop", "strand", "paired")
# the limits of a configuration that states none of its own (its ``limits``
# replace these key by key)
LIMITS = {"rows_wrong": 0, "top_locus_missed": 4}
# further readings, for the limits' look (``control.py``), never compared
READINGS = tuple(LIMITS) + ("best_differ", "best_shard_differ", "loci_differ", "top_loci_differ")
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def sample(seed: int, n_pool: int, n_pairs: int, total: int) -> List[np.ndarray]:
    """``total`` pairs spread over the pool's batches, drawn from the
    seed: sorted distinct pair indices of each batch."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    k = min(n_pairs, -(-total // n_pool))
    return [np.sort(rng.choice(n_pairs, size=k, replace=False)) for _ in range(n_pool)]


def _row_hash(hits, rows: np.ndarray) -> np.ndarray:
    h = np.full(len(rows), 0x9E3779B97F4A7C15, np.uint64)
    for f in FIELDS:
        v = np.asarray(getattr(hits, f))[rows].astype(np.int64).view(np.uint64)
        h = (h ^ v) * _M1
        h ^= h >> np.uint64(29)
        h *= _M2
        h ^= h >> np.uint64(32)
    return h


def rows_of(hits, pairs: np.ndarray):
    """(rows of ``hits`` whose pair is in ``pairs`` (sorted), their index
    into ``pairs``)."""
    read = np.asarray(hits.read, np.int64)
    if not len(read) or not len(pairs):
        z = np.zeros(0, np.int64)
        return z, z
    pos = np.searchsorted(pairs, read)
    ok = pos < len(pairs)
    ok[ok] = pairs[pos[ok]] == read[ok]
    rows = np.flatnonzero(ok)
    return rows, pos[rows]


def digest(per_shard: Sequence, pairs: np.ndarray) -> bytes:
    """A digest of the sampled pairs' rows in every shard: equal
    multisets of rows give equal digests."""
    parts = []
    for hits in per_shard:
        rows, k = rows_of(hits, pairs)
        out = np.zeros((len(pairs), 2), np.uint64)
        out[:, 0] = np.bincount(k, minlength=len(pairs)).astype(np.uint64)
        np.add.at(out[:, 1], k, _row_hash(hits, rows))
        parts.append(out.tobytes())
    return b"".join(parts)


class Expected:
    """The reference's loci of the sample of each pool batch, and what it
    needs to judge a table's rows: each shard's text and the sampled
    reads, on the device."""

    def __init__(self, pairs: List[np.ndarray], loci: List[list], texts: List[torch.Tensor],
                 reads: List[tuple], seq_bp: int, rules: Rules):
        self.pairs, self.loci, self.texts, self.reads = pairs, loci, texts, reads
        self.seq_bp, self.rules = seq_bp, rules
        self.S = len(texts)
        self._seen: Dict[tuple, Dict[str, np.ndarray]] = {}
        # per pool batch, pair, end and shard: {locus key: (raw, score, paired)}
        self.want = [[[[{(x.strand, x.lo): (x.raw, x.score, x.paired) for x in loci[p][s][k][e]}
                        for s in range(self.S)] for e in (0, 1)]
                      for k in range(len(pairs[p]))] for p in range(len(pairs))]

    def differing(self, pool_index: int, per_shard: Sequence) -> Dict[str, np.ndarray]:
        """Which sampled pairs of one completed batch differ (bool [K] a
        number compared). Equal tables are judged once."""
        p = pool_index
        pairs = self.pairs[p]
        K = len(pairs)
        if len(per_shard) != self.S:
            every = np.ones(K, bool)
            return {k: every for k in READINGS}
        key = (p, digest(per_shard, pairs))
        if key not in self._seen:
            self._seen[key] = self._judge(p, per_shard)
        return self._seen[key]

    def _judge(self, p: int, per_shard: Sequence) -> Dict[str, np.ndarray]:
        pairs, K = self.pairs[p], len(self.pairs[p])
        wrong = np.zeros(K, bool)
        got = [[[dict() for _ in range(self.S)] for _ in (0, 1)] for _ in range(K)]
        for s, hits in enumerate(per_shard):
            rows, k = rows_of(hits, pairs)
            f = {n: np.asarray(getattr(hits, n))[rows] for n in FIELDS}
            bad = self._rows_wrong(p, s, k, f)
            wrong[k[bad]] = True
            for i in range(len(rows)):
                kk, e, t = int(k[i]), int(f["end"][i]), int(f["strand"][i])
                if e not in (0, 1):
                    continue
                a, b = int(f["start"][i]), int(f["stop"][i])
                where = [x for x in self.loci[p][s][kk][e]
                         if x.strand == t and x.lo <= a and b <= x.hi]
                lkey = (where[0].strand, where[0].lo) if where else ("not a locus", t, a, b)
                raw, sc, pr = int(f["raw_score"][i]), int(f["score"][i]), bool(f["paired"][i])
                old = got[kk][e][s].get(lkey)
                got[kk][e][s][lkey] = (raw, sc, pr) if old is None else (
                    max(old[0], raw), max(old[1], sc), old[2] or pr)
        missed = np.zeros(K, bool)
        loci = np.zeros(K, bool)
        top = np.zeros(K, bool)
        best = np.zeros(K, bool)
        shard = np.zeros(K, bool)
        tp = self.rules.top_percentage
        for kk in range(K):
            for e in (0, 1):
                g, w = got[kk][e], self.want[p][kk][e]
                for gs, ws in zip(g, w):
                    if any(isinstance(a[0], str) for a in gs):
                        missed[kk] = True  # a row at no locus of the reference
                    if ws and not (_top(ws, tp) & set(gs)):
                        missed[kk] = True
                loci[kk] |= g != w
                top[kk] |= (top_set([{a: v[1] for a, v in d.items()} for d in g], tp)
                            != top_set([{a: v[1] for a, v in d.items()} for d in w], tp))
                gb, wb = [_best(d) for d in g], [_best(d) for d in w]
                best[kk] |= gb != wb
                shard[kk] |= _over_shards(gb, tp) != _over_shards(wb, tp)
        return {"rows_wrong": wrong, "top_locus_missed": missed, "best_differ": best, "best_shard_differ": shard,
                "loci_differ": loci, "top_loci_differ": top}

    def _rows_wrong(self, p: int, s: int, k: np.ndarray, f: Dict[str, np.ndarray]) -> np.ndarray:
        """Which of one shard's sampled rows are not what they say."""
        n = len(k)
        if not n:
            return np.zeros(0, bool)
        text = self.texts[s]
        dev = text.device
        end, strand = f["end"].astype(np.int64), f["strand"].astype(np.int64)
        start, stop = f["start"].astype(np.int64), f["stop"].astype(np.int64)
        raw, score = f["raw_score"].astype(np.int64), f["score"].astype(np.int64)
        reads, lens = self.reads[p]
        e = np.clip(end, 0, 1)
        ln = lens[e, k]
        span = stop - start
        ok = ((end == e) & ((strand == 0) | (strand == 1)) & (start >= 0)
              & (stop <= len(text)) & (span >= 1) & (span <= 2 * ln + 2 * self.rules.margin))
        seq_bp = self.seq_bp
        ok &= (f["seq"] == start // seq_bp) & ((stop - 1) // seq_bp == start // seq_bp)
        ok &= raw >= np.array([self.rules.threshold(int(x)) for x in ln])
        # the plain score of every row that is well formed
        idx = np.flatnonzero(ok)
        if len(idx):
            ki, ei = torch.as_tensor(k[idx], device=dev), torch.as_tensor(e[idx], device=dev)
            r = reads[ei, ki]
            rl = torch.as_tensor(ln[idx], device=dev)
            r = torch.where(torch.as_tensor(strand[idx] == 1, device=dev)[:, None],
                            revcomp(r, rl), r)
            T = int(span[idx].max())
            at = torch.as_tensor(start[idx], device=dev)[:, None] + torch.arange(T, device=dev)
            t = text[at.clamp(max=len(text) - 1)]
            plain = local_scores(r, rl, t, torch.as_tensor(span[idx], device=dev)).cpu().numpy()
            ok[idx] &= plain == raw[idx]
        # a score is the row's own, or that plus a mate row's
        mates = {}
        for i in range(n):
            mates.setdefault((int(k[i]), int(e[i]), int(f["seq"][i]), int(strand[i])),
                             set()).add(int(raw[i]))
        for i in range(n):
            if not f["paired"][i]:
                ok[i] &= score[i] == raw[i]
            else:
                other = mates.get((int(k[i]), 1 - int(e[i]), int(f["seq"][i]),
                                   1 - int(strand[i])), ())
                ok[i] &= int(score[i] - raw[i]) in other
        return ~ok


def _best(loci: dict) -> tuple:
    """Of one end's loci in one shard (key -> (raw, score, paired)): the
    best score, the best raw score, and the loci that hold the best
    score."""
    if not loci:
        return (0, 0, frozenset())
    sc = max(v[1] for v in loci.values())
    return (sc, max(v[0] for v in loci.values()),
            frozenset(k for k, v in loci.items() if v[1] == sc))


def _top(loci: dict, top_percentage: float) -> set:
    """Of one end's loci in one shard (key -> (raw, score, paired)): those
    whose score is at least ``top_percentage`` of the best."""
    best = max(v[1] for v in loci.values())
    floor = int(np.float32(top_percentage) * np.float32(best))
    return {k for k, v in loci.items() if v[1] >= floor}


def _over_shards(bests: list, top_percentage: float) -> tuple:
    """Of one end's best per shard: the best score over the shards, the
    first shard that holds it (-1 with none), and the shards whose best is
    at least ``top_percentage`` of it (the product in float32)."""
    scores = [b[0] for b in bests]
    top = max(scores)
    if top <= 0:
        return (0, -1, ())
    floor = int(np.float32(top_percentage) * np.float32(top))
    return (top, scores.index(top), tuple(s for s, v in enumerate(scores) if v >= floor))


def reference(config: dict, database: Database, pool: Sequence[Batch],
              pairs: List[np.ndarray], device: torch.device) -> Expected:
    """The plain reference on the sampled pairs of each pool batch, shard
    by shard, from the shards' text as the benchmark drew it and the
    batches' reads."""
    rules = Rules(top_percentage=config["pipeline"]["top_percentage"])
    gbp = database.genome_bp
    texts = []
    for s in range(len(database.shard_genomes)):
        g = database.shard_genomes[s]
        texts.append(database.text[int(g[0]) * gbp:(int(g[-1]) + 1) * gbp].to(device))
    L = int(max(max(b.lens1.max(), b.lens2.max()) for b in pool))
    reads, loci = [], []
    for p, b in enumerate(pool):
        q = pairs[p]
        r = torch.as_tensor(np.stack([b.reads1[q, :L], b.reads2[q, :L]]), device=device)
        n = np.stack([b.lens1[q], b.lens2[q]]).astype(np.int64)
        reads.append((r, n))
        nd = torch.as_tensor(n, device=device)
        per_shard = []
        for s, text in enumerate(texts):
            t = time.perf_counter()
            per_shard.append(shard_loci(text, gbp, [r[0], r[1]], [nd[0], nd[1]], rules))
            print(f"[portbench] reference pool batch {p} shard {s}: "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
        loci.append(per_shard)
    return Expected(pairs, loci, texts, reads, gbp, rules)
