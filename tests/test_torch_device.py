"""The port's device steps against ``megapath_tpu/align/device.py``.

Same shard and candidates, made with numpy from a seed, through the JAX
functions and their torch counterparts; exact equality (all integers).
"""

import numpy as np
import pytest
import torch

from megapath_tpu.align import device as jdev
from megapath_tpu.ops.dp import DPParams as JDPParams
from megapath_tpu_torch.align import device as tdev

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
