"""Suffix-array construction for the FM index (host-side index build).

The reference builds its suffix array with a native SA-IS library
(``megapath_tpu/index/suffix.py``, g++ at first use) and falls back to
numpy prefix doubling. The port does prefix doubling in PyTorch on the
device it is given: each round is two stable sorts and a scan over the
whole text, which a card does in milliseconds at shard sizes. A text has
one suffix array, so every correct builder gives the same one;
``tests/test_torch_index.py`` holds it equal to the reference's.

The text is the 2-bit code array; a virtual sentinel smaller than every
character terminates it (the suffix array covers positions 0..n-1, the
sentinel suffix is implicit and excluded).
"""

from __future__ import annotations

import numpy as np
import torch


def suffix_array(codes: np.ndarray, device: torch.device) -> np.ndarray:
    """Suffix array of ``codes`` (uint8, values 0..3) as int64 [n],
    sorted on ``device`` by prefix doubling."""
    n = len(codes)
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    rank = torch.from_numpy(np.asarray(codes, dtype=np.int64)).to(device)
    k = 1
    while True:
        # second key: the rank of suffix i+k, -1 past the end (a shorter
        # suffix sorts first, as the sentinel makes it)
        second = torch.full_like(rank, -1)
        if k < n:
            second[: n - k] = rank[k:]
        # lexicographic (rank, second): stable sort on the minor key, then
        # a stable sort on the major key
        order = torch.argsort(second, stable=True)
        order = order[torch.argsort(rank[order], stable=True)]
        f, s = rank[order], second[order]
        changed = torch.zeros_like(rank)
        changed[1:] = ((f[1:] != f[:-1]) | (s[1:] != s[:-1])).to(torch.int64)
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(changed, 0)
        if int(rank[order[-1]]) == n - 1:  # every suffix has its own rank
            return order.cpu().numpy()
        k *= 2


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over text+sentinel, returned WITHOUT the sentinel cell.

    Returns (bwt codes uint8 [n], primary): ``primary`` is the row of the
    full (n+1)-row BWT matrix that holds the sentinel (row 0 is the
    sentinel suffix), and bwt[i] for i >= primary is full row i+1.
    """
    n = len(codes)
    out = np.empty(n, dtype=np.uint8)
    out[0] = codes[-1]  # row 0: the sentinel suffix, preceded by the last char
    primary = int(np.flatnonzero(sa == 0)[0]) + 1
    chars = codes[sa - 1]  # rows 1..n; the cell at sa == 0 is dropped
    out[1:primary] = chars[: primary - 1]
    out[primary:] = chars[primary:]
    return out, primary
