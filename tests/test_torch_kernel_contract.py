"""The Python around the port's redesigned kernels, on the CPU.

- ``dp_cuda.int16_range_error``: what the int16x2 DP kernel refuses, and
  that it takes every shape the engine makes.
- The DP kernel's cell arithmetic (``csrc/dp_full.cu``) as a numpy model:
  int16 values, F kept as F - go, the one-instruction E chain, never-match
  codes in place of masks, the running best keyed by H * 64 + (63 - row)
  per lane chunk, the group's (score, j, i) reduction and the backward
  pass as a forward pass over the reversed prefixes. It must equal the
  plain ``sw_align_full`` for every score set the wrapper admits, and the
  plain version must equal the JAX Pallas kernel on the tie and
  pair-length batches ``chip_smoke.py`` holds the kernel to.
- ``chip_smoke``'s work counters (DP cells and bytes, the walk's and the
  locate's bytes) and the plain walk's and locate's ``stats``.
Every check is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.ops import dp as jdp
from megapath_tpu.ops.dp_pallas import sw_align_full_pallas_t
from megapath_tpu_torch.align import seeding_dev as sd
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.ops import dp as tdp
from megapath_tpu_torch.ops.dp_cuda import int16_range_error, longest_span
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("score", "end_ref", "end_read", "start_ref", "start_read")
DEFAULT = tdp.DPParams()

# (R, W) of every DP the engine launches: deep DP and single-end at 100 and
# 150 bp, mate rescue at 80, 100 and 250 bp and at the longest read, the
# graft entry's step
ENGINE_SHAPES = [(100, 192), (150, 256), (80, 896), (100, 1024), (250, 1152),
                 (1023, 1920), (128, 256)]


@pytest.mark.parametrize("R,W", ENGINE_SHAPES)
def test_int16_range_takes_the_engines_shapes(R, W):
    assert int16_range_error(R, W, DEFAULT) is None


@pytest.mark.parametrize("R,W,params,why", [
    (1024, 1152, DEFAULT, "window length) * match = 1024"),
    (600, 2048, tdp.DPParams(match=2), "window length) * match = 1200"),
    (100, 192, tdp.DPParams(match=0), "match 0 < 1"),
    (100, 192, tdp.DPParams(mismatch=0), "must be < 0"),
    (100, 192, tdp.DPParams(gap_open=0, gap_extend=0), "must be < 0"),
    (100, 192, tdp.DPParams(gap_extend=1), "gap_extend 1"),
    (100, 192, tdp.DPParams(mismatch=-64), "match - mismatch = 65"),
    (100, 192, tdp.DPParams(gap_open=-2000), "gap_open -2000 < -1024"),
])
def test_int16_range_refuses_and_says_why(R, W, params, why):
    msg = int16_range_error(R, W, params)
    assert msg is not None and why in msg


@pytest.mark.parametrize("span,ok", [(250, True), (1023, True), (1024, False), (5000, False)])
def test_int16_range_bounds_padded_reads_by_their_lengths(span, ok):
    # the pipeline pads reads to max_read_len: R = 1024 with 250 bp reads
    # in the mate rescue's W = 1152 windows scores at most 250
    assert int16_range_error(1024, 1152, DEFAULT) is not None
    assert (int16_range_error(1024, 1152, DEFAULT, span) is None) == ok


def test_longest_span_clamps_as_the_kernel_does():
    rl = torch.tensor([250, 1500, -3, 90], dtype=torch.int32)
    wl = torch.tensor([1152, 40, 900, 2000], dtype=torch.int32)
    assert longest_span(rl, wl, 1024, 1152) == 250
    assert longest_span(rl, wl, 80, 1152) == 80  # read lengths clamped to R
    assert longest_span(rl[:0], wl[:0], 1024, 1152) == 0


# ----------------------------------------------------------------------
# a numpy model of dp_full.cu's cell arithmetic
# ----------------------------------------------------------------------
NO_ROW, NO_COL, NEG = 256, 257, -16384


def _wave(rc, sel, params, CH):
    """One pass: columns rc [C, n] against rows sel [C, G * CH] (codes
    0..257), as the kernel's lanes compute it; returns [C, 3] of (score,
    j + 1, i + 1). Every intermediate must fit int16."""
    m, mm, go, ge = params
    C, rows = sel.shape
    lanes = rows // CH
    H = np.zeros((C, rows), np.int64)
    F = np.zeros((C, rows), np.int64)  # F - go
    best = np.zeros((C, lanes), np.int64)
    bj = np.zeros((C, lanes), np.int64)
    bi = np.zeros((C, lanes), np.int64)
    k_match, k_mis = m - go - (511 << 6), mm - go
    for j in range(rc.shape[1]):
        e = np.full(C, NEG, np.int64)
        diag = np.zeros(C, np.int64)
        keys = np.zeros((C, rows), np.int64)
        for r in range(rows):
            x = ((sel[:, r] ^ rc[:, j] ^ 0x1FF) & 0x1FF) << 6
            sub = np.maximum(x + k_match, k_mis)
            t = np.maximum(diag + sub, F[:, r])
            diag = H[:, r].copy()
            h = np.maximum(np.maximum(t + go, e), 0)
            H[:, r] = h
            F[:, r] = np.maximum(F[:, r] + ge, h)
            e = np.maximum(e + ge, np.maximum(t + 2 * go, go))
            for v in (x + k_match, sub, t, h, F[:, r], e):
                assert v.min() >= -(1 << 15) and v.max() < (1 << 15)
            keys[:, r] = h * 64 + 63 - r % CH
        assert keys.max() < (1 << 16)
        colkey = keys.reshape(C, lanes, CH).max(axis=2)
        up = (colkey >> 6) > best
        best = np.where(up, colkey >> 6, best)
        bj = np.where(up, j + 1, bj)
        bi = np.where(up, np.arange(lanes)[None] * CH + 64 - (colkey & 63), bi)
    out = np.zeros((C, 3), np.int64)
    for c in range(C):  # the group's reduction: score, then low j, then low i
        out[c] = min(zip(best[c], bj[c], bi[c]), key=lambda v: (-v[0], v[1], v[2]))
    return out


def wave_model(reads, refs, read_lens, ref_lens, params, G, CH):
    """dp_full's five outputs as the kernel computes them."""
    reads, refs = reads.astype(np.int64), refs.astype(np.int64)
    C, R = reads.shape
    W = refs.shape[1]
    rows = G * CH
    rl = np.clip(read_lens, 0, R)[:, None]
    wl = np.clip(ref_lens, 0, W)[:, None]
    jj, uu = np.arange(R + G)[None], np.arange(rows)[None]
    padded = np.zeros((C, rows), np.int64)
    padded[:, :W] = refs
    # the forward pass, with the drain's columns past R
    readp = np.zeros((C, R + G), np.int64)
    readp[:, :R] = reads
    fw = _wave(np.where(jj < rl, readp, NO_COL), np.where(uu < wl, padded, NO_ROW),
               params, CH)
    er, ef = fw[:, 1:2], fw[:, 2:3]
    rev_read = np.take_along_axis(readp, np.clip(er - 1 - jj, 0, R - 1), 1)
    rev_win = np.take_along_axis(padded, np.clip(ef - 1 - uu, 0, rows - 1), 1)
    bw = _wave(np.where(jj < er, rev_read, NO_COL), np.where(uu < ef, rev_win, NO_ROW),
               params, CH)
    return fw[:, 0], ef[:, 0], er[:, 0], ef[:, 0] - bw[:, 2], er[:, 0] - bw[:, 1]


def _batches(seed):
    rng = np.random.default_rng(seed)
    return {
        "planted": cs.planted_batch(rng, 24, 40, 96),
        "edge": cs.edge_batch(rng, 40, 96, C=16),
        "ties": cs.tie_batch(rng, 40, 96, C=24),
        "pair_lens": cs.pair_lens_batch(rng, 40, 96, C=16),
    }


@pytest.mark.parametrize("params", [
    DEFAULT,
    tdp.DPParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
    tdp.DPParams(match=1, mismatch=-1, gap_open=-1, gap_extend=-1),
    tdp.DPParams(match=3, mismatch=-60, gap_open=-7, gap_extend=0),
])
@pytest.mark.parametrize("G,CH", [(8, 12), (16, 6), (32, 4)])
def test_wave_model_matches_plain(params, G, CH):
    for tag, batch in _batches(G + CH).items():
        assert int16_range_error(batch[0].shape[1], batch[1].shape[1], params) is None
        want = tdp.sw_align_full(*[torch.from_numpy(a) for a in batch], params)
        got = wave_model(*batch, params, G, CH)
        for f, g in zip(FIELDS, got):
            np.testing.assert_array_equal(g, getattr(want, f).numpy(), err_msg=f"{tag} {f}")


def test_wave_model_matches_plain_on_padded_reads():
    # match 30 leaves the int16 range at the padded width (min(R, W) = 40)
    # but not at the reads' own lengths (<= 34): the kernel's values stay
    # in range and its outputs equal the plain DP
    params = tdp.DPParams(match=30, mismatch=-3, gap_open=-5, gap_extend=-2)
    reads, refs, rl, wl = cs.padded_batch(np.random.default_rng(12), 24, 34, 40, 96)
    assert reads.shape == (24, 40) and rl.max() <= 34
    assert int16_range_error(40, 96, params) is not None
    span = longest_span(torch.from_numpy(rl), torch.from_numpy(wl), 40, 96)
    assert int16_range_error(40, 96, params, span) is None
    want = tdp.sw_align_full(*[torch.from_numpy(a) for a in (reads, refs, rl, wl)], params)
    got = wave_model(reads, refs, rl, wl, params, 8, 12)
    for f, g in zip(FIELDS, got):
        np.testing.assert_array_equal(g, getattr(want, f).numpy(), err_msg=f)


@pytest.mark.parametrize("make", [cs.tie_batch, cs.pair_lens_batch])
def test_plain_matches_pallas_on_ties_and_pair_lengths(make):
    batch = make(np.random.default_rng(31), 48, 164, C=16)
    want = sw_align_full_pallas_t(*batch, block_b=16, interpret=True)
    got = tdp.sw_align_full(*[torch.from_numpy(a) for a in batch])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    fwd = jdp.sw_align(*batch)
    for f in ("score", "end_ref", "end_read"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(fwd, f)))


def test_pair_lens_batch_makes_pairs_differ():
    _, _, rl, wl = cs.pair_lens_batch(np.random.default_rng(5), 100, 192)
    assert (rl[0::2] != rl[1::2]).all() and (wl[0::2] != wl[1::2]).all()


def test_walk_slot_limit_covers_the_engines_max_seeds():
    """The walk kernel stages at most ``seed_cuda.MAX_SEEDS`` slots a walker
    in shared memory (``kMaxSeeds`` in mmp_seed.cu); the engine asks for
    min(16, max(4, L // 16 + 2)) at every read length it takes."""
    import re

    from megapath_tpu_torch.ops import _build, seed_cuda

    src = (_build.CSRC / "mmp_seed.cu").read_text()
    assert int(re.search(r"kMaxSeeds = (\d+);", src).group(1)) == seed_cuda.MAX_SEEDS
    assert max(min(16, max(4, L // 16 + 2)) for L in range(1, 1024)) == seed_cuda.MAX_SEEDS


# ----------------------------------------------------------------------
# chip_smoke's work counters and the plain versions' stats
# ----------------------------------------------------------------------
def test_dp_work_counts_cells_and_bytes():
    rl = np.array([3, 0, 7, 9])  # 9 > R: clamped to R
    wl = np.array([5, 4, 11, -1])  # 11 > W, -1 < 0: clamped
    R, W = 8, 10
    assert cs.dp_work(rl, wl, R, W) == (3 * 5 + 0 + 7 * 10 + 0, 4 * (8 + 10 + 8 + 12))
    res = tdp.DPFullResult(*[torch.tensor(v) for v in (
        [2, 0, 5, 0], [4, 0, 9, 0], [3, 0, 6, 0], [1, 0, 2, 0], [0, 0, 1, 0])])
    cells, nbytes = cs.dp_work(rl, wl, R, W, res)
    assert cells == 85 + 3 * 4 + 6 * 9
    assert nbytes == 4 * (8 + 10 + 8 + 20)


def test_bound_takes_the_larger_time():
    ms, by = cs.bound(cells=int(cs.DP_CELLS_PER_S), nbytes=1000)
    assert by == "operations" and ms == pytest.approx(1000.0)
    ms, by = cs.bound(cells=0, nbytes=int(cs.HBM_BYTES_PER_S))
    assert by == "bytes" and ms == pytest.approx(1000.0)


@pytest.fixture(scope="module")
def walk():
    codes = np.random.default_rng(8).integers(0, 4, 30000).astype(np.uint8)
    dfm = sd.DeviceFM.from_host(build_fm_index(codes, sa_interval=4, lut_k=6, device="cpu"), "cpu")
    rng = np.random.default_rng(9)
    reads = np.zeros((24, 60), np.uint8)
    for b in range(24):
        p = int(rng.integers(0, len(codes) - 60))
        reads[b] = codes[p : p + 60]
        reads[b, int(rng.integers(0, 60))] ^= 1
    walkers, wlens = sd.build_walkers(torch.from_numpy(reads),
                                      torch.full((24,), 60, dtype=torch.int32))
    return dfm, walkers, wlens


@pytest.mark.parametrize("dial", ["default", "exact"])
def test_walk_stats_count_what_the_walk_did(walk, dial):
    dfm, walkers, wlens = walk
    mmp = AlignParams().mmp
    if dial == "exact":
        mmp = dataclasses.replace(mmp, kill_ratio=0.0, sibling_kill_steps=0)
    args = (dfm, walkers, wlens, mmp, 8, 244, 244)
    stats = {}
    got = sd.mmp_seed_device_plain(*args, stats=stats)
    want = sd.mmp_seed_device_plain(*args)
    for f in cs.SEED_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    n = walkers.shape[0]
    assert 0 < stats["iterations"] <= 244
    assert 0 < stats["fresh_steps"] and 0 < stats["ext_steps"]
    assert stats["fresh_steps"] + stats["ext_steps"] <= n * stats["iterations"]
    # the longest walker needs every one of those iterations
    short = sd.mmp_seed_device_plain(dfm, walkers, wlens, mmp, 8, stats["iterations"], 244)
    for f in cs.SEED_FIELDS:
        assert torch.equal(getattr(short, f), getattr(want, f)), f
    # each table entry counts once: at most the two rows an extending step
    # ranks in, at most one key a fresh step
    n_blocks = dfm.rows.shape[0]
    assert 0 < stats["occ_rows"] <= min(2 * stats["ext_steps"], n_blocks)
    assert 0 < stats["lut_keys"] <= min(stats["fresh_steps"], 4**dfm.lut_k)
    nbytes = cs.walk_bytes(n, 60, 8, stats)
    assert nbytes == (n * 64 + stats["occ_rows"] * 48 + stats["lut_keys"] * 8
                      + n * (16 * 8 + 4))


def test_locate_stats_count_lookups_and_steps(walk):
    dfm = walk[0]
    rows = torch.arange(0, dfm.n + 1, 97, dtype=torch.int32)
    stats = {}
    pos = sd.locate_device_plain(dfm, rows, stats=stats)
    assert torch.equal(pos, sd.locate_device_plain(dfm, rows))
    M = len(rows)
    assert M <= stats["mark_lookups"] <= M * (dfm.sa_interval + 1)
    assert stats["lf_steps"] == stats["mark_lookups"] - int((pos >= 0).sum())
    assert 0 < stats["longest"] <= dfm.sa_interval + 1
    # a mark row is needed only at a mark, a block's mark words at every
    # row tested, its checkpoints and BWT words only where an LF step ranks
    assert 0 < stats["mark_rows"] <= min(int((pos >= 0).sum()), dfm.mark_rows.shape[0])
    assert 0 < stats["mark_words"] <= min(stats["mark_lookups"], dfm.rows.shape[0])
    assert 0 < stats["occ_rows"] <= min(stats["lf_steps"], stats["mark_words"])
    assert cs.locate_bytes(M, stats) == (M * 12 + stats["mark_words"] * 16
                                         + stats["occ_rows"] * 48 + stats["mark_rows"] * 8)
    loads, floor_ms = cs.chain_floor(stats, 100.0)
    assert loads == stats["longest"] + 4
    assert floor_ms == pytest.approx(loads * 1e-4, rel=1e-12)
