"""Device-resident alignment steps: window gather + forward/backward DP.

Port of ``megapath_tpu/align/device.py``. Every function takes tensors
that already lie on the engine's device and returns tensors on it; the
DP goes through ``ops.dp.sw_align_full_auto`` (forward + backward) or
``ops.dp.sw_align_auto`` (forward only): the CUDA kernel on a card, the
plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from megapath_tpu_torch.ops.dp import (  # noqa: F401  (OFF_TEXT_CODE re-exported)
    OFF_TEXT_CODE,
    DPFullResult,
    DPParams,
    sw_align_auto,
    sw_align_full_auto,
)


class AlignStepOut(NamedTuple):
    score: torch.Tensor  # int32 [C] per-candidate DP score
    end_ref: torch.Tensor  # int32 [C] window-relative alignment end
    end_read: torch.Tensor  # int32 [C]
    passed: torch.Tensor  # bool [C] score >= max(ratio*len, lb)


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


def align_step(
    ref_codes: torch.Tensor,  # uint8 [N] device-resident shard text
    reads: torch.Tensor,  # uint8 [C, L] candidate read codes (oriented)
    read_lens: torch.Tensor,  # int32 [C]
    win_starts: torch.Tensor,  # int32/int64 [C] window start positions
    width: int,
    params: DPParams = DPParams(),
    cutoff_ratio: float = 0.2,
    cutoff_lb: int = 30,
) -> AlignStepOut:
    """Gather + forward DP + threshold (``device.py:42-65``). The
    threshold is ``max(int(cutoff_ratio * len), cutoff_lb)`` with the
    product in float32, as the JAX program computes it."""
    wins = gather_windows(ref_codes, win_starts, width)
    wlens = torch.full(
        (reads.shape[0],), width, dtype=torch.int32, device=reads.device
    )
    res = sw_align_auto(reads, wins, read_lens, wlens, params)
    ratio = torch.tensor(cutoff_ratio, dtype=torch.float32, device=reads.device)
    thr = torch.clamp_min(
        (ratio * read_lens.to(torch.float32)).to(torch.int32), cutoff_lb
    )
    return AlignStepOut(
        score=res.score, end_ref=res.end_ref, end_read=res.end_read,
        passed=res.score >= thr,
    )


def pair_align_step(
    ref_codes: torch.Tensor,
    left_reads: torch.Tensor,  # [C, L] forward codes of the + leg
    left_lens: torch.Tensor,
    left_starts: torch.Tensor,
    right_reads: torch.Tensor,  # [C, L] revcomp codes of the - leg
    right_lens: torch.Tensor,
    right_starts: torch.Tensor,
    width: int,
    params: DPParams = DPParams(),
    cutoff_ratio: float = 0.2,
    cutoff_lb: int = 30,
) -> Tuple[AlignStepOut, torch.Tensor]:
    """Both pair legs in one batch (``device.py:372-396``); returns the
    per-leg results and the pair keep mask (both ends over threshold,
    DV-DPfunctions.cpp:3439-3440)."""
    out = align_step(
        ref_codes,
        torch.cat([left_reads, right_reads]),
        torch.cat([left_lens, right_lens]),
        torch.cat([left_starts, right_starts]),
        width, params, cutoff_ratio, cutoff_lb,
    )
    C = left_reads.shape[0]
    return out, out.passed[:C] & out.passed[C:]


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


def pack_ref_words(codes: np.ndarray) -> np.ndarray:
    """Host, once per shard: uint8 codes [n] -> uint32 words
    [(n+15)//16], char j at bits 2*(j%16) of word j//16."""
    n = len(codes)
    nw = (n + 15) // 16
    pad = np.zeros(nw * 16, np.uint32)
    pad[:n] = codes
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (pad.reshape(nw, 16) << shifts).sum(axis=1, dtype=np.uint32)


def gather_windows_packed(
    ref_words: torch.Tensor,  # int32 [(n+15)//16] (uint32 bits)
    n_text: int,
    starts: torch.Tensor,  # int32 [C]
    width: int,
) -> torch.Tensor:
    """[C] window starts -> uint8 [C, width] codes, gathered a packed
    word at a time (``device.py:217-248``); off-text cells get
    OFF_TEXT_CODE."""
    if width % 16:
        raise ValueError(f"packed window gather needs a 16-aligned width, got {width}")
    C = starts.shape[0]
    dev = starts.device
    nw = width // 16 + 1
    nwords = ref_words.shape[0]
    st = starts.to(torch.int64)
    cols = (st >> 4)[:, None] + torch.arange(nw, device=dev)[None, :]
    words = ref_words[cols.clamp(0, nwords - 1)].to(torch.int64) & 0xFFFFFFFF
    j = torch.arange(width, device=dev)
    # char j of the window is char (start & 15) + j of the word run
    q = (st & 15)[:, None] + j[None, :]
    w = torch.gather(words, 1, q >> 4)
    chars = (w >> (2 * (q & 15))) & 3
    idx = st[:, None] + j[None, :]
    ok = (idx >= 0) & (idx < n_text)
    return torch.where(ok, chars, OFF_TEXT_CODE).to(torch.uint8)


def deep_dp_fused_walk(
    ref_words: torch.Tensor,  # int32 packed shard text (uint32 bits)
    n_text: int,
    walkers: torch.Tensor,  # uint8 [2*nb, L]: [reads; revcomp] rows
    lens_all: torch.Tensor,  # int32 [>= nb]: read end i's length at i
    nb: int,
    left_idx: torch.Tensor,  # int32 [C] read rows of the left (+) legs
    left_starts: torch.Tensor,
    left_win_lens: torch.Tensor,
    right_idx: torch.Tensor,  # int32 [C] read rows of the right (-) legs
    right_starts: torch.Tensor,
    right_full_wl: torch.Tensor,
    width: int,
    insert_high: int,
    params: DPParams = DPParams(),
) -> Tuple[DPFullResult, DPFullResult]:
    """Both deep-DP legs against the seeding walk's resident state
    (``device.py:251-293``): the reads are rows of the walker matrix
    (row i = forward read i, row nb + i = its reverse complement), the
    windows come from the packed text, and the right leg's window is
    clipped to left hit + insert_high on the device
    (DV-DPfunctions.cpp:2933-2959). The host ships index arrays only.
    ``sw_align_full_auto`` on pre-gathered windows is the port's
    ``_align_with_starts_wins`` (``device.py:320-369``)."""
    li = left_idx.to(torch.int64)
    ri = right_idx.to(torch.int64)
    left = sw_align_full_auto(
        walkers[li], gather_windows_packed(ref_words, n_text, left_starts, width),
        lens_all[li].to(torch.int32), left_win_lens, params,
    )
    hit_left = left_starts.to(torch.int64) + left.start_ref
    bound = hit_left + insert_high - right_starts.to(torch.int64)
    wl_r = torch.minimum(right_full_wl.to(torch.int64), bound).clamp(0, width)
    right = sw_align_full_auto(
        walkers[ri + nb],
        gather_windows_packed(ref_words, n_text, right_starts, width),
        lens_all[ri].to(torch.int32), wl_r.to(torch.int32), params,
    )
    return left, right


def align_rows_walk(
    ref_words: torch.Tensor,
    n_text: int,
    walkers: torch.Tensor,  # uint8 [2*nb, L]: [reads; revcomp]
    rows: torch.Tensor,  # int32 [C] walker rows (idx + strand*nb)
    read_lens: torch.Tensor,  # int32 [C]
    win_starts: torch.Tensor,  # int32 [C]
    win_lens: torch.Tensor,  # int32 [C]
    width: int,
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Single-leg DP (single end, mate rescue) against the walker matrix
    and the packed text (``device.py:296-317``): the oriented read is a
    walker row, so the host ships row indices only."""
    return sw_align_full_auto(
        walkers[rows.to(torch.int64)],
        gather_windows_packed(ref_words, n_text, win_starts, width),
        read_lens, win_lens, params,
    )
