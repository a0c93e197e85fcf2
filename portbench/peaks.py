"""The card's peaks and the work a DP launch must do.

The peaks are of one NVIDIA H100 SXM at its full 700 W power limit: HBM3
at 3.35 TB/s (NVIDIA's data sheet). The DP's cell rate is a model, not a
published peak: 64 integer lanes a clock on each of 132 SMs at the
1.98 GHz maximum SM clock, over the 3 lane-instructions a cell needs at
least (DPX in its int16x2 form: one pair of cells in 6). A card set below
700 W runs below these rates, so every share is reported beside the
card's power limit.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS, LANES, SM_CLOCK_HZ, LANE_INSTR_PER_CELL = 132, 64, 1.98e9, 3
DP_CELLS_PER_S = LANES * SMS * SM_CLOCK_HZ / LANE_INSTR_PER_CELL


def dp_work(read_lens, ref_lens, R: int, W: int, end_read=None, end_ref=None) -> tuple:
    """(cells, bytes) a DP launch must cover: the forward cells
    sum(min(rl, R) * min(wl, W)) and, for the forward + backward kernel,
    the backward cells sum(end_read * end_ref) of its result; the bytes
    read once (reads, windows, the two lengths) and written once (3
    int32 outputs, or 5)."""
    rl = np.clip(np.asarray(read_lens, np.int64), 0, R)
    wl = np.clip(np.asarray(ref_lens, np.int64), 0, W)
    cells = int((rl * wl).sum())
    n_out = 3
    if end_read is not None:
        cells += int((np.asarray(end_read, np.int64) * np.asarray(end_ref, np.int64)).sum())
        n_out = 5
    return cells, len(rl) * (R + W + 8 + 4 * n_out)


def bound_s(cells: int, nbytes: int) -> tuple:
    """(seconds, what bounds it): the larger of the cells at the cell rate
    and the bytes at the memory rate."""
    by_ops, by_bytes = cells / DP_CELLS_PER_S, nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
