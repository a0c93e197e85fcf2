"""The port's plain PyTorch DP against the JAX package's DP.

Same inputs, made with numpy from a seed, go through both; all outputs
are integers, so every check is exact (tolerance 0). The JAX side runs
as the JAX package's own tests run it on the CPU: ``sw_align`` through
XLA, the Pallas kernels (``sw_align_full_pallas_t``, the forward-only
``sw_align_pallas`` and the row-major ``sw_align_full_pallas``) in
interpret mode.
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_batch, planted_batch
from megapath_tpu.ops import dp as jdp
from megapath_tpu.ops.dp_pallas import (
    sw_align_full_pallas,
    sw_align_full_pallas_t,
    sw_align_pallas,
)
from megapath_tpu_torch.ops import dp as tdp
from megapath_tpu_torch.ops import dp_cuda
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("score", "end_ref", "end_read", "start_ref", "start_read")
SHAPES = [(16, 48, 164), (16, 100, 192)]


def _torch(batch):
    return [torch.from_numpy(a) for a in batch]


def _assert_full_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("B,R,W", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_sw_align_matches_jax(seed, B, R, W):
    batch = planted_batch(np.random.default_rng(seed), B, R, W)
    want = jdp.sw_align(*batch)
    got = tdp.sw_align(*_torch(batch))
    for f in ("score", "end_ref", "end_read"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("B,R,W", SHAPES)
@pytest.mark.parametrize("seed", [2, 3])
def test_sw_align_full_matches_pallas_t(seed, B, R, W):
    batch = planted_batch(np.random.default_rng(seed), B, R, W)
    want = sw_align_full_pallas_t(*batch, block_b=16, interpret=True)
    _assert_full_equal(tdp.sw_align_full(*_torch(batch)), want)


@pytest.mark.parametrize("R,W", [(48, 164), (100, 192)])
def test_edge_batch_matches_pallas_t(R, W):
    """Zero-length reads, win_len < W and = 0, off-text cells, planted
    twice, repeats, all mismatches: ties decide end and start."""
    batch = edge_batch(np.random.default_rng(4), R, W, C=16)
    want = sw_align_full_pallas_t(*batch, block_b=16, interpret=True)
    got = tdp.sw_align_full(*_torch(batch))
    _assert_full_equal(got, want)
    # the degenerate rows give 0 in all five outputs
    for row in (0, 2, 7):
        assert all(int(getattr(got, f)[row]) == 0 for f in FIELDS), row


def test_auto_on_cpu_runs_plain_and_launches_nothing():
    batch = _torch(edge_batch(np.random.default_rng(5), 100, 192, C=16))
    got = tdp.sw_align_full_auto(*batch)
    assert dp_cuda.launches == 0
    _assert_full_equal(got, tdp.sw_align_full(*batch))


def _assert_fwd_equal(got, want):
    for f in ("score", "end_ref", "end_read"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


@pytest.mark.parametrize("B,R,W", SHAPES)
@pytest.mark.parametrize("seed", [6, 7])
def test_sw_align_matches_pallas_fwd_kernel(seed, B, R, W):
    """The forward-only TPU kernel ``_dp_kernel`` (through
    ``sw_align_pallas``, as tests/test_dp_pallas.py runs it): all three
    outputs equal the plain ``sw_align``, score-0 rows included."""
    batch = planted_batch(np.random.default_rng(seed), B, R, W)
    want = sw_align_pallas(*batch, block_b=8, interpret=True)
    _assert_fwd_equal(tdp.sw_align(*_torch(batch)), want)


def test_edge_batch_matches_pallas_fwd_kernel():
    batch = edge_batch(np.random.default_rng(8), 100, 192, C=16)
    want = sw_align_pallas(*batch, block_b=8, interpret=True)
    _assert_fwd_equal(tdp.sw_align(*_torch(batch)), want)


@pytest.mark.parametrize("seed", [9, 10])
def test_sw_align_full_matches_row_major_pallas(seed):
    """The row-major TPU kernel ``_dp_full_kernel`` (through
    ``sw_align_full_pallas``, block 8) has the contract of
    ``_dp_full_kernel_t``: the plain ``sw_align_full`` (which the card's
    ``dp_full.cu`` is held to) equals it on all five outputs."""
    batch = planted_batch(np.random.default_rng(seed), 16, 48, 128)
    want = sw_align_full_pallas(*batch, block_b=8, interpret=True)
    _assert_full_equal(tdp.sw_align_full(*_torch(batch)), want)


def test_edge_batch_matches_row_major_pallas():
    batch = edge_batch(np.random.default_rng(11), 48, 128, C=16)
    want = sw_align_full_pallas(*batch, block_b=8, interpret=True)
    _assert_full_equal(tdp.sw_align_full(*_torch(batch)), want)


def test_sw_align_auto_on_cpu_runs_plain_and_launches_nothing():
    batch = _torch(edge_batch(np.random.default_rng(12), 100, 192, C=16))
    got = tdp.sw_align_auto(*batch)
    assert dp_cuda.fwd_launches == 0
    _assert_fwd_equal(got, tdp.sw_align(*batch))


def test_max_width_covers_the_engines_widest_window():
    """The engine takes reads up to L = 1023 (the walk's own bound); its
    widest DP window is then mate rescue's round_up(insert_high + L + 62,
    128) = 1920 rows, the single-end DP's round_up(L + 62, 64) = 1088.
    The CUDA kernel takes both."""
    from megapath_tpu_torch.align.engine import _round_up
    from megapath_tpu_torch.align.params import AlignParams

    L = 1023
    rescue = _round_up(int(AlignParams().insert_high + L + 62), 128)
    assert (rescue, _round_up(L + 62, 64)) == (1920, 1088)
    assert dp_cuda.MAX_WIDTH >= rescue
