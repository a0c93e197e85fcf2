"""ctypes wrappers of the hand-written CUDA seeding kernels.

``mmp_seed_cuda`` launches ``csrc/mmp_seed.cu`` (port of the XLA program
``seeding_jax.device_mmp_seed``) and ``locate_cuda`` launches
``csrc/locate.cu`` (port of ``seeding_jax.device_locate``). They take the
tables of ``align.seeding_dev.DeviceFM`` and return what the plain
versions in that module return. The kernels launch on the current
stream, synchronise nothing and allocate nothing; these wrappers check
their inputs, allocate the outputs and raise when a launch is refused.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from megapath_tpu_torch.align.params import MmpParams
from megapath_tpu_torch.align.seeding_dev import DeviceFM, DeviceSeeds, check_walk
from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp_cuda import check_tensor

# The most seed slots a walker the kernel takes (``kMaxSeeds`` in
# mmp_seed.cu); the engine asks for min(16, max(4, L // 16 + 2)).
MAX_SEEDS = 16

# Kernel launches since the last reset; chip_smoke.py zeroes them and
# reads them back to show that the main path went through the kernels.
walk_launches = 0  # mp_mmp_seed
locate_launches = 0  # mp_locate


def _check_tables(dfm: DeviceFM, dev: torch.device) -> None:
    check_tensor("rows", dfm.rows, torch.int32, 2, dev)
    check_tensor("counts", dfm.counts, torch.int32, 1, dev)
    check_tensor("mark_rows", dfm.mark_rows, torch.int32, 2, dev)
    check_tensor("sa_sampled", dfm.sa_sampled, torch.int32, 1, dev)
    if dfm.rows.shape[1] != 16 or dfm.mark_rows.shape[1] != 2 or dfm.counts.shape[0] != 5:
        raise ValueError("DeviceFM tables are not in the kernels' layout")
    # the kernels read a row as four uint4s and a mark row as one uint2
    if dfm.rows.data_ptr() % 16 or dfm.mark_rows.data_ptr() % 8:
        raise ValueError("DeviceFM rows must be 16-byte and mark rows 8-byte aligned")
    if dfm.lut_k:
        check_tensor("lut_lo", dfm.lut_lo, torch.int32, 1, dev)
        check_tensor("lut_hi", dfm.lut_hi, torch.int32, 1, dev)
        if dfm.lut_lo.shape[0] != 4**dfm.lut_k or dfm.lut_hi.shape[0] != 4**dfm.lut_k:
            raise ValueError(f"k-mer table is not 4^{dfm.lut_k} long")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def mmp_seed_cuda(
    dfm: DeviceFM,
    walkers: torch.Tensor,  # uint8 [W, L] on a CUDA device
    lens: torch.Tensor,  # int32 [W]
    params: MmpParams,
    max_seeds: int = 16,
    max_steps: Optional[int] = None,
    charge_limit: Optional[int] = None,
) -> DeviceSeeds:
    """The seed walk on the card: one thread per read end (rows w and
    W/2 + w) when W is even, one per walker otherwise."""
    dev = walkers.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA seed walk needs CUDA tensors, got {dev}")
    check_tensor("walkers", walkers, torch.uint8, 2, dev)
    check_tensor("lens", lens, torch.int32, 1, dev)
    _check_tables(dfm, dev)
    Wn, L = walkers.shape
    if lens.shape[0] != Wn:
        raise ValueError(f"row counts differ: walkers {Wn}, lens {lens.shape[0]}")
    check_walk(L, params)
    if not 1 <= max_seeds <= MAX_SEEDS:
        raise ValueError(f"max_seeds {max_seeds} outside 1..{MAX_SEEDS}: the kernel "
                         "stages a walker's slots in shared memory")
    limit = max_steps if max_steps is not None else 3 * L + 64
    out = torch.empty((4, Wn, max_seeds), dtype=torch.int32, device=dev)
    n_seeds = torch.empty(Wn, dtype=torch.int32, device=dev)
    if Wn == 0:
        return DeviceSeeds(*out, n_seeds)
    lib = _build.load()
    lut = (dfm.lut_lo.data_ptr(), dfm.lut_hi.data_ptr()) if dfm.lut_k else (None, None)
    with torch.cuda.device(dev):
        err = lib.mp_mmp_seed(
            walkers.data_ptr(), lens.data_ptr(), dfm.rows.data_ptr(), *lut,
            dfm.counts.data_ptr(), *(out[q].data_ptr() for q in range(4)),
            n_seeds.data_ptr(), Wn, L, max_seeds, dfm.n + 1, dfm.primary,
            dfm.lut_k, params.seed_min_length, params.reseed_len,
            params.sa_size_threshold, params.reseed_abs_diff,
            params.good_seed_len, getattr(params, "sibling_kill_steps", 0),
            params.reseed_rlt_ratio, int(params.kill_ratio > 0),
            params.kill_ratio, float(params.kill_base), int(limit),
            -1 if charge_limit is None else int(charge_limit), _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"mp_mmp_seed launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "walk_launches")
    return DeviceSeeds(*out, n_seeds)


def locate_cuda(dfm: DeviceFM, rows: torch.Tensor) -> torch.Tensor:
    """Text positions (int32) of full-BWT rows (int32, each in [0, n]) on
    the card; -1 where no mark lies within sa_interval + 1 steps. The
    kernel reads each step's mark from the occ row's mark words."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA locate needs CUDA tensors, got {dev}")
    check_tensor("rows", rows, torch.int32, 1, dev)
    _check_tables(dfm, dev)
    out = torch.empty_like(rows)
    M = rows.shape[0]
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.mp_locate(
            rows.data_ptr(), out.data_ptr(), dfm.rows.data_ptr(),
            dfm.counts.data_ptr(), dfm.mark_rows.data_ptr(),
            dfm.sa_sampled.data_ptr(), M, dfm.primary, dfm.sa_interval,
            _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"mp_locate launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "locate_launches")
    return out
