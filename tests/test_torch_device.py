"""The port's device steps against ``megapath_tpu/align/device.py``.

Same shard and candidates, made with numpy from a seed, through the JAX
functions and their torch counterparts; exact equality (all integers).
"""

import numpy as np
import pytest
import torch

from megapath_tpu.align import device as jdev
from megapath_tpu.align import seeding_jax as jseed
from megapath_tpu.ops.dp import DPParams as JDPParams
from megapath_tpu_torch.align import device as tdev
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("score", "start_ref", "end_ref", "end_read", "start_read")


def _world(seed, C, L, W, n_text=3000):
    """A random shard and C candidates whose reads come from it (with a
    few substitutions), their windows starting a margin before the read;
    some windows hang off either end of the text."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n_text).astype(np.uint8)
    pos = rng.integers(-40, n_text - L + 40, C)
    reads = np.zeros((C, L), np.uint8)
    lens = rng.integers(L // 2, L + 1, C).astype(np.int32)
    for c in range(C):
        idx = np.clip(pos[c] + np.arange(lens[c]), 0, n_text - 1)
        r = text[idx].copy()
        for _ in range(int(rng.integers(0, 4))):
            q = int(rng.integers(0, lens[c]))
            r[q] = (r[q] + 1) % 4
        reads[c, : lens[c]] = r
    starts = (pos - 25).astype(np.int32)
    win_lens = rng.integers(0, W + 1, C).astype(np.int32)
    return rng, text, reads, lens, starts, win_lens


def test_gather_windows_off_text():
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, 500).astype(np.uint8)
    starts = np.array([-300, -64, -1, 0, 7, 436, 437, 499, 500, 900], np.int32)
    want = np.asarray(jdev.gather_windows(text, starts, 64))
    got = tdev.gather_windows(torch.from_numpy(text), torch.from_numpy(starts), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    assert (want[0] == jdev.OFF_TEXT_CODE).all()
    assert tdev.OFF_TEXT_CODE == jdev.OFF_TEXT_CODE


@pytest.mark.parametrize("seed,C,L,W", [(1, 32, 60, 128), (2, 16, 100, 192)])
def test_align_with_starts_matches_jax(seed, C, L, W):
    _, text, reads, lens, starts, win_lens = _world(seed, C, L, W)
    want = jdev.align_with_starts(
        text, reads, lens, starts, W, params=JDPParams(), win_lens=win_lens
    )
    t = torch.from_numpy
    got = tdev.align_with_starts(
        t(text), t(reads), t(lens), t(starts), W, win_lens=t(win_lens)
    )
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("seed", [3, 4])
def test_deep_dp_fused_right_leg_clip(seed):
    """The right leg's window is clipped to left hit + insert_high on the
    device; a small insert_high makes the clip bite on most rows."""
    C, L, W = 24, 60, 128
    rng, text, l_reads, l_lens, l_starts, _ = _world(seed, C, L, W)
    r_off = rng.integers(20, 140, C)
    r_starts = (l_starts + r_off).astype(np.int32)
    r_reads = np.zeros_like(l_reads)
    r_lens = l_lens.copy()
    for c in range(C):
        idx = np.clip(r_starts[c] + 25 + np.arange(r_lens[c]), 0, len(text) - 1)
        r_reads[c, : r_lens[c]] = text[idx]
    l_wl = np.minimum(l_lens + 50, W).astype(np.int32)
    r_full = (r_lens + 50).astype(np.int32)
    insert_high = 90
    jl, jr = jdev.deep_dp_fused(
        text, l_reads, l_lens, l_starts, l_wl, r_reads, r_lens, r_starts,
        r_full, W, insert_high, params=JDPParams(),
    )
    t = torch.from_numpy
    tl, tr = tdev.deep_dp_fused(
        t(text), t(l_reads), t(l_lens), t(l_starts), t(l_wl), t(r_reads),
        t(r_lens), t(r_starts), t(r_full), W, insert_high,
    )
    for got, want in ((tl, jl), (tr, jr)):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
            )
    # the clip changed some right-leg results against an unclipped run
    free = tdev.align_with_starts(
        t(text), t(r_reads), t(r_lens), t(r_starts), W,
        win_lens=t(np.clip(r_full, 0, W)),
    )
    assert (free.score != tr.score).any()


def _assert_fields(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("seed,C,L,W", [(5, 32, 60, 128), (6, 16, 100, 256)])
def test_align_step_matches_jax(seed, C, L, W):
    """The single-chip entry's step: gather + forward DP + threshold;
    (C, L, W) = (16, 100, 256) is the graft entry's shape at a small C."""
    _, text, reads, lens, starts, _ = _world(seed, C, L, W)
    want = jdev.align_step(text, reads, lens, starts, W, JDPParams())
    t = torch.from_numpy
    got = tdev.align_step(t(text), t(reads), t(lens), t(starts), W)
    _assert_fields(got, want, ("score", "end_ref", "end_read", "passed"))
    assert got.passed.dtype == torch.bool and got.passed.any()


def test_pair_align_step_matches_jax():
    C, L, W = 16, 60, 128
    rng, text, l_reads, l_lens, l_starts, _ = _world(7, C, L, W)
    _, _, r_reads, r_lens, r_starts, _ = _world(8, C, L, W)
    args = (l_reads, l_lens, l_starts, r_reads, r_lens, r_starts)
    want, want_keep = jdev.pair_align_step(text, *args, W, JDPParams(), 0.3, 20)
    got, keep = tdev.pair_align_step(
        torch.from_numpy(text), *map(torch.from_numpy, args), W,
        cutoff_ratio=0.3, cutoff_lb=20,
    )
    _assert_fields(got, want, ("score", "end_ref", "end_read", "passed"))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


def test_gather_windows_packed_matches_jax():
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 517).astype(np.uint8)
    words = jdev.pack_ref_words(text)
    np.testing.assert_array_equal(tdev.pack_ref_words(text), words)
    starts = np.array([-300, -64, -17, -1, 0, 5, 15, 16, 17, 450, 453, 516,
                       517, 900], np.int32)
    want = np.asarray(jdev.gather_windows_packed(words, len(text), starts, 64))
    got = tdev.gather_windows_packed(
        torch.from_numpy(words.view(np.int32)), len(text),
        torch.from_numpy(starts), 64,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # the packed gather equals the byte gather
    np.testing.assert_array_equal(
        want, np.asarray(jdev.gather_windows(text, starts, 64))
    )


def _walk_world(seed, n, L, W):
    """A shard, its packed words, a [reads; revcomp] walker matrix over
    n read ends (nb = n + 3 rows of padding), and windows about them."""
    rng, text, reads, lens, starts, _ = _world(seed, n, L, W)
    nb = n + 3
    pad = np.zeros((nb, L), np.uint8)
    pad[:n] = reads
    plens = np.zeros(nb, np.int32)
    plens[:n] = lens
    walkers, _ = jseed.build_walkers(pad, plens)
    return rng, text, jdev.pack_ref_words(text), np.array(walkers), plens, starts, nb


def test_deep_dp_fused_walk_matches_jax():
    n, L, W = 24, 60, 128
    rng, text, words, walkers, plens, starts, nb = _walk_world(9, n, L, W)
    C = 20
    l_idx = rng.integers(0, n, C).astype(np.int32)
    r_idx = rng.integers(0, n, C).astype(np.int32)
    l_starts = starts[l_idx]
    r_starts = (l_starts + rng.integers(20, 140, C)).astype(np.int32)
    l_wl = np.minimum(plens[l_idx] + 50, W).astype(np.int32)
    r_full = (plens[r_idx] + 50).astype(np.int32)
    args = (l_idx, l_starts, l_wl, r_idx, r_starts, r_full)
    jl, jr = jdev.deep_dp_fused_walk(
        words, len(text), walkers, plens, nb, *args, W, 90, params=JDPParams()
    )
    t = torch.from_numpy
    tl, tr = tdev.deep_dp_fused_walk(
        t(words.view(np.int32)), len(text), t(walkers), t(plens), nb,
        *map(t, args), W, 90,
    )
    for got, want in ((tl, jl), (tr, jr)):
        _assert_fields(got, want, FIELDS)
    assert (tr.score > 0).any() and (tl.score > 0).any()


def test_align_rows_walk_matches_jax():
    n, L, W = 24, 60, 192
    rng, text, words, walkers, plens, starts, nb = _walk_world(10, n, L, W)
    C = 32
    idx = rng.integers(0, n, C)
    strand = rng.integers(0, 2, C)
    rows = (idx + strand * nb).astype(np.int32)
    lens = plens[idx]
    wstart = starts[idx]
    wl = np.full(C, W, np.int32)
    want = jdev.align_rows_walk(
        words, len(text), walkers, rows, lens, wstart, wl, W, params=JDPParams()
    )
    t = torch.from_numpy
    got = tdev.align_rows_walk(
        t(words.view(np.int32)), len(text), t(walkers), t(rows), t(lens),
        t(wstart), t(wl), W,
    )
    _assert_fields(got, want, FIELDS)
    assert (got.score > 0).any()


def test_graft_entry_step_matches_jax():
    """The single-chip entry (__graft_entry__.entry: C = 256, L = 128,
    W = 256): the smoke's inputs are the entry's, and the port's
    align_step gives the entry's outputs."""
    import __graft_entry__
    from chip_smoke import graft_inputs

    fn, args = __graft_entry__.entry()
    want = fn(*args)
    (ref, reads, lens, starts), W = graft_inputs(torch.device("cpu"))
    for g, w in zip((ref, reads, lens, starts), args):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tdev.align_step(ref, reads, lens, starts, W)
    _assert_fields(got, want, ("score", "end_ref", "end_read", "passed"))
    assert int(got.passed.sum()) >= 128
