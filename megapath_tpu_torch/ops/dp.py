"""Batched affine-gap local DP: the plain PyTorch versions and the dispatch.

Port of ``megapath_tpu/ops/dp.py``. The scoring contract is the same:
match +1, mismatch -2, gap open -3 for the first gap base, extend -1 per
further base, floor 0. Within one read column the vertical gap chain
E[i] = max(E[i-1]+ge, H[i-1]+go) may use H *without* its E term, because
go <= ge makes re-opening from a gap cell never optimal; E is then a
prefix max of (H_noE[i] + go - i*ge) and the column has no sequential
dependency.

``sw_align`` and ``sw_align_full`` are the plain versions: the CPU tests
run them, and ``chip_smoke.py`` holds the CUDA kernels against them.
``sw_align_full_auto`` (forward + backward, what the engine calls) and
``sw_align_auto`` (forward only, what ``align_step`` calls) decide by
the tensors' device: the plain version for CPU tensors, the hand-written
kernel (``ops/dp_cuda.py``) for CUDA tensors, and never one in place of
the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG = -(10**6)  # -inf surrogate that survives int32 adds
OFF_TEXT_CODE = 4  # a window cell past the text: never equals a read code


class DPParams(NamedTuple):
    match: int = 1
    mismatch: int = -2
    gap_open: int = -3  # first gap base
    gap_extend: int = -1


class DPResult(NamedTuple):
    score: torch.Tensor  # int32 [B] best local score
    end_ref: torch.Tensor  # int32 [B] ref index AFTER the last aligned base
    end_read: torch.Tensor  # int32 [B] read index AFTER the last aligned base


class DPFullResult(NamedTuple):
    score: torch.Tensor  # int32 [B]
    end_ref: torch.Tensor  # int32 [B] exclusive
    end_read: torch.Tensor  # int32 [B] exclusive
    start_ref: torch.Tensor  # int32 [B]
    start_read: torch.Tensor  # int32 [B]


def sw_align(
    reads: torch.Tensor,  # uint8/int32 [B, R] read codes
    refs: torch.Tensor,  # uint8/int32 [B, W] ref window codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    params: DPParams = DPParams(),
) -> DPResult:
    """Plain forward pass: score and exclusive end cell per candidate.

    Columns ``j >= read_len`` leave H and F untouched; rows
    ``>= ref_len`` are computed but never chosen. Ties go to the lowest
    ref row within a column and to the earliest column across columns.
    """
    B, R = reads.shape
    W = refs.shape[1]
    dev = reads.device
    go, ge = params.gap_open, params.gap_extend
    refs = refs.to(torch.int32)
    reads = reads.to(torch.int32)
    read_lens = read_lens.to(torch.int32)
    row = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    row_valid = row < ref_lens.to(torch.int32)[:, None]
    decay = row * ge
    # packed (score, row) key: one max gives the best score and, among
    # equal scores, the lowest row
    K = 1 << max(W - 1, 1).bit_length()
    row_key = (K - 1 - row).to(torch.int64)
    match = torch.tensor(params.match, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(params.mismatch, dtype=torch.int32, device=dev)

    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    Fg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    best_i = torch.zeros_like(best)
    best_j = torch.zeros_like(best)
    for j in range(R):
        sub = torch.where(refs == reads[:, j : j + 1], match, mismatch)
        F_new = torch.maximum(H + go, Fg + ge)
        M = F.pad(H[:, :-1], (1, 0)) + sub
        H_noE = torch.clamp_min(torch.maximum(M, F_new), 0)
        Ycum = torch.cummax(H_noE + go - decay, dim=1).values
        E = F.pad(Ycum[:, :-1], (1, 0), value=NEG) + decay - ge
        H_new = torch.maximum(H_noE, E)

        col_valid = (j < read_lens)[:, None]
        Hv = torch.where(row_valid & col_valid, H_new, 0)
        kbest = (Hv.to(torch.int64) * K + row_key).amax(dim=1)
        col_best = (kbest // K).to(torch.int32)
        col_arg = (K - 1 - kbest % K).to(torch.int32)
        better = col_best > best
        best = torch.where(better, col_best, best)
        best_i = torch.where(better, col_arg + 1, best_i)
        best_j = torch.where(better, j + 1, best_j)

        H = torch.where(col_valid, H_new, H)
        Fg = torch.where(col_valid, F_new, Fg)
    return DPResult(score=best, end_ref=best_i, end_read=best_j)


def sw_align_full(
    reads: torch.Tensor,
    refs: torch.Tensor,
    read_lens: torch.Tensor,
    ref_lens: torch.Tensor,
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Plain forward pass, then the forward pass again over the reversed
    prefixes ``read[:end_read][::-1]`` x ``window[:end_ref][::-1]``: its
    end cell is the distance from the forward end back to the start
    (``megapath_tpu/align/device.py:345-369``). A row with score 0 gets 0
    in all five outputs."""
    R = reads.shape[1]
    W = refs.shape[1]
    dev = reads.device
    fwd = sw_align(reads, refs, read_lens, ref_lens, params)
    jj = torch.arange(R, device=dev)[None, :]
    rsrc = fwd.end_read.to(torch.int64)[:, None] - 1 - jj
    rev_reads = torch.where(
        rsrc >= 0, torch.gather(reads, 1, rsrc.clamp(0, R - 1)), 0
    ).to(torch.uint8)
    ii = torch.arange(W, device=dev)[None, :]
    wsrc = fwd.end_ref.to(torch.int64)[:, None] - 1 - ii
    rev_refs = torch.where(
        wsrc >= 0, torch.gather(refs, 1, wsrc.clamp(0, W - 1)), OFF_TEXT_CODE
    ).to(torch.uint8)
    rev = sw_align(rev_reads, rev_refs, fwd.end_read, fwd.end_ref, params)
    return DPFullResult(
        score=fwd.score,
        end_ref=fwd.end_ref,
        end_read=fwd.end_read,
        start_ref=fwd.end_ref - rev.end_ref,
        start_read=fwd.end_read - rev.end_read,
    )


def sw_align_auto(
    reads: torch.Tensor,  # uint8 [C, R]
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPResult:
    """Forward DP by the tensors' device (``megapath_tpu/ops/dp.py:120``):
    the plain version on the CPU, the forward-only CUDA kernel on a card
    (which raises on what it does not take; there is no fallback)."""
    if reads.device.type == "cpu":
        return sw_align(reads, refs, read_lens, ref_lens, params)
    if reads.device.type == "cuda":
        from megapath_tpu_torch.ops.dp_cuda import sw_align_cuda

        return sw_align_cuda(reads, refs, read_lens, ref_lens, params)
    raise ValueError(f"no DP for tensors on {reads.device}")


def sw_align_full_auto(
    reads: torch.Tensor,  # uint8 [C, R]
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Forward + backward DP by the tensors' device: the plain version on
    the CPU, the CUDA kernel on a card (which raises on what it does not
    take; there is no fallback to the plain version)."""
    if reads.device.type == "cpu":
        return sw_align_full(reads, refs, read_lens, ref_lens, params)
    if reads.device.type == "cuda":
        from megapath_tpu_torch.ops.dp_cuda import sw_align_full_cuda

        return sw_align_full_cuda(reads, refs, read_lens, ref_lens, params)
    raise ValueError(f"no DP for tensors on {reads.device}")
