"""The engine's device pairing (``pairing_dev.pair_candidates_device``, the
insert-window join in torch ops over the kept clusters left on the device)
against the host pairing (``pairing.pair_candidates``) on the same clusters.

The device side gets the clusters as the decode leaves them: one row a
cluster, its read a read end of the seeded batch (first ends, then second
ends), in an order of its own. Every check is exact: each field, in order
and dtype, and the counters. This file imports no JAX, so its ``card``
case also runs on a card:
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_pairing_dev.py``.
"""

import numpy as np
import pytest
import torch

from megapath_tpu_torch.align import pairing_dev as pd
from megapath_tpu_torch.align.pairing import pair_candidates
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align.seeding import SeedPositions
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
P = AlignParams()
FIELDS = ("pair", "left_pos", "right_pos", "left_is_read2")


def sp(rows):
    """SeedPositions from (read, strand, pos) rows."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    return SeedPositions(rows[:, 0].astype(np.int32), rows[:, 1].astype(np.int8),
                         rows[:, 2], np.zeros(len(rows), np.int32))


def on_device(sp1, sp2, lens1, lens2, todo, rng, device):
    """The clusters of both ends as one batch's decode gives them: read ends
    local to ``todo`` (first ends [0, t), second ends [t, 2t)), rows in a
    shuffled order, the lengths of the seeded ends padded past 2t."""
    t = len(todo)
    loc1 = np.searchsorted(todo, sp1.read)
    loc2 = np.searchsorted(todo, sp2.read) + t
    read = np.concatenate([loc1, loc2]).astype(np.int64)
    strand = np.concatenate([sp1.strand, sp2.strand]).astype(np.int64)
    pos = np.concatenate([sp1.pos, sp2.pos]).astype(np.int64)
    perm = rng.permutation(len(read))
    lens = np.zeros(2 * t + 5, np.int32)
    lens[:t], lens[t:2 * t] = lens1[todo], lens2[todo]
    return [torch.from_numpy(a[perm]).to(device) for a in (read, strand, pos)], \
        torch.from_numpy(lens).to(device)


def run_case(sp1, sp2, lens1, lens2, params, todo=None, device=CPU, seed=0):
    """The host pairing and the device pairing of the same clusters, both
    counters checked; returns the host result."""
    n = len(lens1)
    want = pair_candidates(sp1, sp2, lens1, lens2, params)
    rng = np.random.default_rng(seed)
    full = todo is None
    todo = np.arange(n) if full else np.asarray(todo, np.int64)
    (read, strand, pos), lens_d = on_device(sp1, sp2, lens1, lens2, todo, rng, device)
    before = (pd.pair_rows_device, pd.pair_cands_device)
    got = pd.pair_candidates_device(
        read, strand, pos, lens_d, len(todo), params,
        None if full else torch.from_numpy(todo).to(device))
    rows, cands = (a - b for a, b in zip((pd.pair_rows_device, pd.pair_cands_device), before))
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert rows == len(read)
    assert cands == len(want)
    return want


def random_clusters(rng, n: int, k: int, locus_span: int = 0):
    """k clusters over n pairs: both ends, both strands, starts packed
    within 3,060 of each pair's locus (in [0, locus_span)) so that windows
    hold several right legs, chains run past divide_gap and starts tie or
    fall below 0; lengths across the 100 bp margin step."""
    locus = rng.integers(0, max(locus_span, 1), n)

    def draw(m):
        read = rng.integers(0, n, m)
        return np.stack([read, rng.integers(0, 2, m),
                         locus[read] + rng.integers(-60, 3000, m)], axis=1)
    m1 = int(rng.integers(k // 4, 3 * k // 4))
    lens1 = rng.choice([80, 100, 101, 150, 250], n).astype(np.int32)
    lens2 = rng.choice([80, 100, 101, 150, 250], n).astype(np.int32)
    return sp(draw(m1)), sp(draw(k - m1)), lens1, lens2


L150 = np.array([150, 150, 150], np.int32)
EDGE = P.with_(insert_low=300)  # rl 150: window [left + 120, left + 630]
# (name: first-end clusters, second-end clusters, lens1, lens2, params, todo)
CASES = {
    "no clusters": ([], [], L150, L150, P, None),
    "negative starts": ([(0, 0, -400), (0, 0, -380), (1, 1, -300)],
                        [(0, 1, -200), (0, 1, 300), (1, 0, -700)], L150, L150, P, None),
    "no left legs": ([(0, 1, 100), (1, 1, 200)], [(0, 1, 300), (1, 1, 250)], L150, L150, P, None),
    "no right legs": ([(0, 0, 100), (1, 0, 200)], [(0, 0, 300), (1, 0, 250)], L150, L150, P, None),
    "one assignment": ([(0, 0, 100), (2, 0, 50)], [(0, 1, 400), (2, 1, 60), (2, 1, 650)],
                       L150, L150, P, None),
    # anchors 100 -> 106 -> 117 -> 123 (each the first past the last + 5),
    # 103, 105, 110, 111 and the repeated 117s folded in
    "deep chains and duplicates": (
        [(1, 0, x) for x in (100, 103, 105, 106, 110, 111, 117, 117, 117, 123)],
        [(1, 1, 400), (1, 1, 400), (1, 1, 700), (1, 1, 760)], L150, L150, P, None),
    # rl 100: high = 750 - 100 + 25 = 675; rl 101: 750 - 101 + 30 = 679
    "margin step": ([(0, 0, 1000), (1, 0, 1000)],
                    [(0, 1, 1000 + x) for x in (675, 676, 679, 680)]
                    + [(1, 1, 1000 + x) for x in (675, 676, 679, 680)],
                    np.array([150, 150], np.int32), np.array([100, 101], np.int32), P, None),
    "window edges": ([(0, 0, 5000), (1, 1, 5000 + 120), (1, 1, 5000 + 630)],
                     [(0, 1, 5000 + x) for x in (119, 120, 630, 631)] + [(1, 0, 5000)],
                     L150, L150, EDGE, None),
    "pairs with no partner": ([(0, 0, 100), (1, 0, 100), (2, 1, 100)],
                              [(1, 1, 2000), (2, 1, 300), (0, 0, 300)], L150, L150, P, None),
    # a later round: the seeded ends are those of pairs 1 and 4 only
    "subset of pairs": ([(1, 0, 100), (4, 0, 50), (4, 1, 900)],
                        [(1, 1, 300), (4, 1, 200), (4, 0, 500)],
                        np.full(6, 150, np.int32), np.full(6, 120, np.int32), P, [1, 4]),
}
CASE_IDS = sorted(CASES) + [f"random {s}" for s in (1, 2, 3)] + ["random subset 4"]


@pytest.mark.parametrize("case", CASE_IDS)
def test_device_pairing_equals_host_pairing(case):
    if case.startswith("random"):
        s = int(case.split()[-1])
        rng = np.random.default_rng(s)
        n = 40
        sp1, sp2, lens1, lens2 = random_clusters(rng, n, 700)
        todo = None
        if "subset" in case:
            todo = np.sort(rng.choice(n, 25, replace=False))
            sp1 = sp(np.stack([sp1.read, sp1.strand, sp1.pos], 1)[np.isin(sp1.read, todo)])
            sp2 = sp(np.stack([sp2.read, sp2.strand, sp2.pos], 1)[np.isin(sp2.read, todo)])
        want = run_case(sp1, sp2, lens1, lens2, P, todo, seed=s)
        assert len(want) > 100 and want.left_is_read2.any() and not want.left_is_read2.all()
        return
    c1, c2, lens1, lens2, params, todo = CASES[case]
    want = run_case(sp(c1), sp(c2), lens1, lens2, params, todo)
    expect = {
        "no clusters": [], "no left legs": [], "no right legs": [],
        "negative starts": [(0, -400, -200, False), (0, -380, -200, False),
                            (1, -700, -300, True)],
        "one assignment": [(0, 100, 400, False), (2, 50, 60, False), (2, 50, 650, False)],
        "deep chains and duplicates": [(1, a, r, False) for a in (100, 106, 117, 123)
                                       for r in (400, 400, 700, 760) if r <= a + 630],
        "margin step": [(0, 1000, 1675, False), (1, 1000, 1675, False),
                        (1, 1000, 1676, False), (1, 1000, 1679, False)],
        "window edges": [(0, 5000, 5120, False), (0, 5000, 5630, False),
                         (1, 5000, 5120, True), (1, 5000, 5630, True)],
        "pairs with no partner": [],
        "subset of pairs": [(1, 100, 300, False), (4, 50, 200, False), (4, 500, 900, True)],
    }[case]
    assert list(zip(*(getattr(want, f).tolist() for f in FIELDS))) == expect


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_device_pairing_equals_host_pairing_on_the_card(card):
    """~1,000,000 clusters over 100,000 pairs, paired on the card and on
    the host, the whole batch and a later round's subset."""
    rng = np.random.default_rng(7)
    n = 100_000
    sp1, sp2, lens1, lens2 = random_clusters(rng, n, 1_000_000, locus_span=2_000_000_000)
    want = run_case(sp1, sp2, lens1, lens2, P, device=card, seed=7)
    assert len(want) > 100_000
    todo = np.sort(rng.choice(n, n // 10, replace=False))
    keep1, keep2 = np.isin(sp1.read, todo), np.isin(sp2.read, todo)
    sub1 = sp(np.stack([sp1.read, sp1.strand, sp1.pos], 1)[keep1])
    sub2 = sp(np.stack([sp2.read, sp2.strand, sp2.pos], 1)[keep2])
    assert len(run_case(sub1, sub2, lens1, lens2, P, todo, device=card, seed=8)) > 10_000
