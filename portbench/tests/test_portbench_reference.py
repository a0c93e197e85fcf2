"""The plain reference's pieces against brute force: the local alignment
score, the k-mer scan and the NT stage's pairing rules."""

import numpy as np
import torch

from portbench.reference.align import (Locus, Rules, _pair, local_scores, revcomp,
                                       seed_hits, top_set)


def brute_local(a, b, match=1, mismatch=-2, go=-3, ge=-1):
    """Smith-Waterman with affine gaps, cell by cell (a gap of k bases
    scores go + (k - 1) * ge)."""
    NEG = -10**9
    H = np.zeros((len(a) + 1, len(b) + 1), int)
    E = np.full_like(H, NEG)
    F = np.full_like(H, NEG)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            E[i, j] = max(E[i, j - 1] + ge, H[i, j - 1] + go)
            F[i, j] = max(F[i - 1, j] + ge, H[i - 1, j] + go)
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
    return int(H.max())


def test_local_scores_equal_brute_force():
    rng = np.random.default_rng(11)
    reads, texts, rl, tl, want = [], [], [], [], []
    for _ in range(40):
        n, m = int(rng.integers(5, 30)), int(rng.integers(5, 45))
        a = rng.integers(0, 4, n)
        b = rng.integers(0, 4, m)
        if rng.random() < 0.7:  # plant the read with an indel and a substitution
            at = int(rng.integers(0, max(m - n, 1)))
            piece = list(a[: n // 2]) + [int(rng.integers(0, 4))] + list(a[n // 2:])
            piece[0] = (piece[0] + 1) % 4
            b = np.array((list(b[:at]) + piece + list(b[at:]))[:m])
        reads.append(np.pad(a, (0, 30 - n)))
        texts.append(np.pad(b, (0, 45 - len(b))))
        rl.append(n)
        tl.append(len(b))
        want.append(brute_local(a, b))
    got = local_scores(torch.as_tensor(np.array(reads), dtype=torch.uint8), torch.as_tensor(rl),
                       torch.as_tensor(np.array(texts), dtype=torch.uint8), torch.as_tensor(tl),
                       block=7)
    assert got.tolist() == want


def test_seed_hits_find_every_planted_match_and_no_other():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 4000).astype(np.uint8)
    q = np.zeros((3, 40), np.uint8)
    q[0, :30] = text[1210:1240]  # inside sequence 1 (of 1000 bp)
    q[1, :40] = text[2980:3020]  # across sequences 2 and 3: k-mers inside either count
    q[2, :30] = rng.integers(0, 4, 30)
    lens = torch.tensor([30, 40, 30])
    hits = seed_hits(torch.as_tensor(text), 1000, torch.as_tensor(q), lens, 17, chunk=777)
    got = {tuple(h) for h in hits.tolist()}
    assert got == {(0, 1210, 1), (1, 2980, 2), (1, 2980, 3)}


def test_revcomp_within_length():
    r = torch.tensor([[0, 1, 2, 3, 0], [0, 0, 1, 0, 0]], dtype=torch.uint8)
    assert revcomp(r, torch.tensor([4, 3])).tolist() == [[0, 1, 2, 3, 0], [2, 3, 3, 0, 0]]


def loc(strand, seq, diag, raw):
    return Locus(strand, seq, diag - 30, diag + 180, diag, raw)


def test_pairing_rules():
    # a proper pair on sequence 0 and a lone locus of end 0 on sequence 1
    ends = [[loc(0, 0, 1000, 150), loc(0, 1, 5000, 140)], [loc(1, 0, 1200, 147)]]
    _pair(ends, [150, 150], Rules())
    assert [(x.seq, x.score, x.paired) for x in ends[0]] == [(0, 297, True)]
    assert [(x.seq, x.score, x.paired) for x in ends[1]] == [(0, 297, True)]
    # the fragment too long (-u 750), or the - strand upstream: each end alone
    for d in (1000 + 601, 1000 - 50):
        ends = [[loc(0, 0, 1000, 150)], [loc(1, 0, d, 147)]]
        _pair(ends, [150, 150], Rules())
        assert [(x.score, x.paired) for e in ends for x in e] == [(150, False), (147, False)]


def test_top_set_keeps_95_percent_of_the_best():
    kept = top_set([{"a": 300, "b": 284}, {"c": 286}], 0.95)
    assert kept == {(0, "a", 300), (1, "c", 286)}
    assert top_set([{}, {}], 0.95) == frozenset()
