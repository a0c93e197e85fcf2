"""Device-resident alignment steps: window gather + forward/backward DP.

Port of ``megapath_tpu/align/device.py:20-200``. Every function takes
tensors that already lie on the engine's device and returns tensors on
it; the DP goes through ``ops.dp.sw_align_full_auto`` (the CUDA kernel
on a card, the plain version on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megapath_tpu_torch.ops.dp import (  # noqa: F401  (OFF_TEXT_CODE re-exported)
    OFF_TEXT_CODE,
    DPFullResult,
    DPParams,
    sw_align_full_auto,
)


def gather_windows(
    ref_codes: torch.Tensor, starts: torch.Tensor, width: int
) -> torch.Tensor:
    """[C] start positions -> uint8 [C, width] windows; cells before the
    text or past its end get OFF_TEXT_CODE (forced mismatch)."""
    n = ref_codes.shape[0]
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        width, dtype=torch.int64, device=starts.device
    )[None, :]
    valid = (idx >= 0) & (idx < n)
    win = ref_codes[idx.clamp(0, n - 1)]
    return torch.where(valid, win, OFF_TEXT_CODE).to(torch.uint8)


def align_with_starts(
    ref_codes: torch.Tensor,  # uint8 [N] device-resident shard text
    reads: torch.Tensor,  # uint8 [C, L]
    read_lens: torch.Tensor,  # int32 [C]
    win_starts: torch.Tensor,  # int32 [C]
    width: int,
    params: DPParams = DPParams(),
    win_lens: Optional[torch.Tensor] = None,  # int32 [C] effective lengths
) -> DPFullResult:
    """Window gather + forward DP + backward DP.

    ``win_lens`` bounds each row's usable window (soap4 clips the DNA
    window length per candidate, DV-DPfunctions.cpp:2954-2959); cells
    past it never hold the best cell. Defaults to the full ``width``.
    """
    if win_lens is None:
        win_lens = torch.full(
            (reads.shape[0],), width, dtype=torch.int32, device=reads.device
        )
    wins = gather_windows(ref_codes, win_starts, width)
    return sw_align_full_auto(reads, wins, read_lens, win_lens, params)


def deep_dp_fused(
    ref_codes: torch.Tensor,
    left_reads: torch.Tensor,  # [C, L] forward codes of the left leg
    left_lens: torch.Tensor,
    left_starts: torch.Tensor,  # int32 window starts (pos - margin)
    left_win_lens: torch.Tensor,
    right_reads: torch.Tensor,  # [C, L] revcomp codes of the right leg
    right_lens: torch.Tensor,
    right_starts: torch.Tensor,
    right_full_wl: torch.Tensor,  # readLen + 2*margin before clipping
    width: int,
    insert_high: int,
    params: DPParams = DPParams(),
) -> Tuple[DPFullResult, DPFullResult]:
    """Both deep-DP legs with no host round trip between them.

    The reference aligns the right end per left-passing candidate with
    the window clipped to leftHit + insert_high
    (DV-DPfunctions.cpp:2933-2959). The clip is computed here, on the
    device, from the left leg's start cell; the right leg runs for every
    candidate and the host gates the output by the left threshold, so the
    kept hits equal the reference's two-phase flow.
    """
    left = align_with_starts(
        ref_codes, left_reads, left_lens, left_starts, width, params,
        left_win_lens,
    )
    hit_left = left_starts.to(torch.int64) + left.start_ref
    bound = hit_left + insert_high - right_starts.to(torch.int64)
    wl_r = torch.minimum(right_full_wl.to(torch.int64), bound).clamp(0, width)
    right = align_with_starts(
        ref_codes, right_reads, right_lens, right_starts, width, params,
        wl_r.to(torch.int32),
    )
    return left, right
