"""The behaviour checks of ``tests/test_engine.py`` on the port's
``AlignEngine``, on host and on device seeding: proper pairs with their
positions and strands, mutated pairs, MegaPath mode 1 against mode 2,
cross-sequence pairs not summed, ``format_comment`` (against the JAX
package's too), the second seeding round, the right window's clip at
``insert_high`` and the single-end candidate cap. The world and the pairs
are the JAX tests' own, drawn from the same seeds; the port's index is
built by the port on the CPU."""

import numpy as np
import pytest
import torch

from megapath_tpu.align.output import format_comment as jformat_comment
from megapath_tpu.index.pack import PackedReference as JRef
from megapath_tpu_torch.align import AlignEngine, AlignParams, MmpParams, best_per_seq, format_comment
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, PackedReference, pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
SEEDING = pytest.mark.parametrize("device_seeding", [False, True], ids=["host", "device"])


def _rand(n, rng):
    return rng.integers(0, 4, size=n).astype(np.uint8)


@pytest.fixture(scope="module")
def world():
    """tests/test_engine.py's world: three sequences from seed 99."""
    rng = np.random.default_rng(99)
    seqs = {"ecoli_1": _rand(6000, rng), "salm_1": _rand(5000, rng), "virus_1": _rand(3000, rng)}
    ref = pack_fasta([FastqRecord(n, DECODE[c].tobytes().decode(), "", "") for n, c in seqs.items()])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)
    params = AlignParams(insert_high=500,
                         mmp=MmpParams(seed_min_length=12, reseed_len=13, good_seed_len=18))
    return ref, fm, params


def _engine(ref, fm, params, device_seeding):
    return AlignEngine(ref, fm, params, device=CPU, device_seeding=device_seeding)


def _make_pairs(ref, rng, n, read_len=80, insert=300, mutate=0):
    """tests/test_engine.py's proper +/- pairs: read1 forward at p, read2
    the reverse complement at p + insert - read_len."""
    reads1 = np.zeros((n, read_len), dtype=np.uint8)
    reads2 = np.zeros((n, read_len), dtype=np.uint8)
    truth = []
    for b in range(n):
        s = int(rng.integers(0, len(ref.names)))
        off0, off1 = int(ref.offsets[s]), int(ref.offsets[s + 1])
        p = int(rng.integers(off0, off1 - insert))
        r1 = ref.codes[p : p + read_len].copy()
        p2 = p + insert - read_len
        r2 = COMPLEMENT[ref.codes[p2 : p2 + read_len][::-1]]
        for _ in range(mutate):
            q = int(rng.integers(0, read_len))
            r1[q] = (r1[q] + 1 + rng.integers(0, 3)) % 4
            q = int(rng.integers(0, read_len))
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        reads1[b], reads2[b] = r1, r2
        truth.append((s, p, p2))
    lens = np.full(n, read_len, dtype=np.int32)
    return reads1, lens, reads2, lens.copy(), truth


@SEEDING
def test_proper_pairs_positions_and_strands(world, device_seeding):
    ref, fm, params = world
    engine = _engine(ref, fm, params, device_seeding)
    r1, l1, r2, l2, truth = _make_pairs(ref, np.random.default_rng(5), 12)
    table = best_per_seq(engine.align_pairs(r1, l1, r2, l2), 12, params.megapath_mode)
    for b, (s, _, _) in enumerate(truth):
        # both ends hit the right sequence with the paired (summed) score
        assert table[0][b].get(s) == 160, (b, table[0][b])
        assert table[1][b].get(s) == 160, (b, table[1][b])
    r1, l1, r2, l2, truth = _make_pairs(ref, np.random.default_rng(6), 6)
    hits = engine.align_pairs(r1, l1, r2, l2)
    for b, (_, p, p2) in enumerate(truth):
        m1 = (hits.read == b) & (hits.end == 0) & (hits.score == 160)
        m2 = (hits.read == b) & (hits.end == 1) & (hits.score == 160)
        assert m1.any() and m2.any()
        assert p in hits.start[m1].tolist() and p2 in hits.start[m2].tolist()
        assert 0 in hits.strand[m1].tolist() and 1 in hits.strand[m2].tolist()


@SEEDING
def test_mutated_pairs_score_drop(world, device_seeding):
    ref, fm, params = world
    engine = _engine(ref, fm, params, device_seeding)
    r1, l1, r2, l2, truth = _make_pairs(ref, np.random.default_rng(7), 8, mutate=2)
    table = best_per_seq(engine.align_pairs(r1, l1, r2, l2), 8, params.megapath_mode)
    for b, (s, _, _) in enumerate(truth):
        assert 120 <= table[0][b].get(s, 0) < 160, (b, table[0][b])


@SEEDING
def test_unpaired_read_mode1_vs_mode2(world, device_seeding):
    ref, fm, params = world
    rng = np.random.default_rng(8)
    n, read_len = 4, 80
    reads1 = np.zeros((n, read_len), dtype=np.uint8)
    reads2 = _rand(n * read_len, rng).reshape(n, read_len)  # junk mates
    for b in range(n):
        p = int(ref.offsets[b % 3]) + 100 + b * 37
        reads1[b] = ref.codes[p : p + read_len]
    lens = np.full(n, read_len, np.int32)
    hits = _engine(ref, fm, params, device_seeding).align_pairs(reads1, lens, reads2, lens.copy())
    t1 = best_per_seq(hits, n, megapath_mode=1)
    t2 = best_per_seq(hits, n, megapath_mode=2)
    for b in range(n):
        assert t1[0][b].get(b % 3) == 80  # unpaired single-end hit reported
        assert b % 3 not in t2[0][b]  # pair-required mode drops it


@SEEDING
def test_cross_sequence_pairs_not_summed(world, device_seeding):
    """read1 on one sequence, read2 on another: both ends align but are
    not properly paired, so the scores stay per end."""
    ref, fm, params = world
    read_len = 80
    p_a, p_b = int(ref.offsets[0]) + 500, int(ref.offsets[1]) + 700
    r1 = ref.codes[p_a : p_a + read_len][None, :]
    r2 = COMPLEMENT[ref.codes[p_b : p_b + read_len][::-1]][None, :]
    lens = np.array([read_len], np.int32)
    hits = _engine(ref, fm, params, device_seeding).align_pairs(r1, lens, r2, lens.copy())
    t = best_per_seq(hits, 1, megapath_mode=1)
    assert t[0][0].get(0) == 80 and t[1][0].get(1) == 80


def _jref(ref):
    return JRef(codes=ref.codes, names=ref.names, annotations=ref.annotations,
                offsets=ref.offsets, ambiguous=ref.ambiguous)


@pytest.mark.parametrize("scores,prev", [
    ({0: 100, 1: 96, 2: 80}, ""),
    ({0: 110}, "SCORE:120;120,OLD_REF_A;100,OLD_REF_B;"),
    ({0: 130, 2: 124}, "SCORE:120;120,OLD_REF_A;bad,X;;100,OLD_REF_B;"),
    ({}, "SCORE:x;50,A;"),
    ({1: 0}, ""),
    ({0: 10}, "IGNORE"),
])
def test_format_comment_equals_jax(world, scores, prev):
    ref, _, params = world
    from megapath_tpu.align.params import AlignParams as JParams

    got = format_comment(scores, ref, params, prev_comment=prev)
    assert got == jformat_comment(scores, _jref(ref), JParams(insert_high=500), prev_comment=prev)


def test_format_comment_top_filter_and_merge(world):
    ref, _, params = world
    c = format_comment({0: 100, 1: 96, 2: 80}, ref, params)
    assert c.startswith("SCORE:100;")
    assert "100," + ref.names[0] in c and "96," + ref.names[1] in c  # 96 >= 95
    assert ref.names[2] not in c  # 80 < 95
    c = format_comment({0: 110}, ref, params,
                       prev_comment="SCORE:120;120,OLD_REF_A;100,OLD_REF_B;")
    # prev best 120 dominates; 110 < 114 filtered; 120 kept, 100 dropped
    assert c.startswith("SCORE:120;") and "120,OLD_REF_A" in c
    assert "100,OLD_REF_B" not in c and ref.names[0] not in c
    empty = PackedReference(codes=np.zeros(0, np.uint8), names=[], annotations=[],
                            offsets=np.array([0]), ambiguous=np.zeros((0, 2), np.int64))
    assert format_comment({}, empty, AlignParams(), "IGNORE") == "IGNORE"


@SEEDING
def test_multiround_aligns_on_round2(world, device_seeding):
    """A center mutation defeats a strict first seeding round (longest
    exact stretch 40 < 60); the relaxed second round aligns the pairs."""
    ref, fm, params = world
    n = 6
    r1, l1, r2, l2, truth = _make_pairs(ref, np.random.default_rng(41), n)
    for b in range(n):
        r1[b, 40] = (r1[b, 40] + 1) % 4
        r2[b, 40] = (r2[b, 40] + 1) % 4
    strict = MmpParams(seed_min_length=60, reseed_len=61, good_seed_len=70)
    one_round = _engine(ref, fm, params.with_(mmp=strict), device_seeding)
    assert len(one_round.align_pairs(r1, l1, r2, l2)) == 0
    two_round = _engine(ref, fm, params.with_(mmp=strict, extra_rounds=(params.mmp,)),
                        device_seeding)
    table = best_per_seq(two_round.align_pairs(r1, l1, r2, l2), n, megapath_mode=1)
    for b, (s, _, _) in enumerate(truth):
        # 79 matches + 1 mismatch per end: 77 per end, 154 paired
        assert table[0][b].get(s) == 154 and table[1][b].get(s) == 154, (b, table[0][b])


@SEEDING
def test_right_window_clipped_at_insert_high(world, device_seeding):
    """Insert 520 > insert_high 500: the right leg's window is clipped,
    so its 20 overhanging bases leave the score."""
    ref, fm, params = world
    r1, l1, r2, l2, truth = _make_pairs(ref, np.random.default_rng(42), 4, insert=520)
    hits = _engine(ref, fm, params, device_seeding).align_pairs(r1, l1, r2, l2)
    table = best_per_seq(hits, 4, megapath_mode=1)
    for b, (s, _, _) in enumerate(truth):
        assert table[0][b].get(s) == 140 and table[1][b].get(s) == 140, (b, table[0][b])


@SEEDING
def test_single_end_candidate_cap(world, device_seeding):
    """A motif planted 10 times: 10 single-end candidates uncapped, at most
    ``max_se_candidates`` = 2 capped."""
    ref, _, params = world
    rng = np.random.default_rng(43)
    read_len = 80
    motif = _rand(read_len, rng)
    codes = ref.codes.copy()
    for q in (200 + 400 * k for k in range(10)):
        codes[q : q + read_len] = motif
    ref2 = PackedReference(codes=codes, names=ref.names, annotations=ref.annotations,
                           offsets=ref.offsets, ambiguous=ref.ambiguous)
    fm2 = build_fm_index(codes, sa_interval=4, lut_k=6, device=CPU)
    reads1 = motif[None, :].copy()
    reads2 = _rand(read_len, rng)[None, :]  # junk mate: no pairing
    lens = np.full(1, read_len, np.int32)
    for cap, check in ((None, lambda n: n == 10), (2, lambda n: n <= 2)):
        p = params if cap is None else params.with_(max_se_candidates=cap)
        h = _engine(ref2, fm2, p, device_seeding).align_pairs(reads1, lens, reads2, lens.copy())
        n = len(np.unique(h.start[(h.read == 0) & (h.end == 0)]))
        assert check(n), (cap, n)
