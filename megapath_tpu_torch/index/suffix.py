"""Suffix-array construction for the FM index (host-side index build).

The reference builds its suffix array with a native SA-IS library
(``megapath_tpu/index/suffix.py``, g++ at first use) and falls back to
numpy prefix doubling. The port does prefix doubling in PyTorch on the
device it is given. The first key is the suffix's first 13 characters;
each round then sorts one int64 key, (rank of the suffix, rank of the
suffix k characters on), and doubles k, so a random text is sorted in
three sorts. Ranks are int32 (a shard is < 2^31 characters), which keeps
a 512 Mbp text within one card. A text has one suffix array, so every
correct builder gives the same one; ``tests/test_torch_index.py`` holds
it equal to the reference's.

The text is the 2-bit code array; a virtual sentinel smaller than every
character terminates it (the suffix array covers positions 0..n-1, the
sentinel suffix is implicit and excluded).
"""

from __future__ import annotations

import numpy as np
import torch

FIRST_KEY_CHARS = 13  # 5^13 < 2^31: one base-5 key, 0 past the end


def _dense_rank(key: torch.Tensor):
    """(rank int32 of each key among the distinct keys, the sorting
    permutation int64, whether every key is distinct)."""
    sorted_key, order = torch.sort(key)
    changed = torch.zeros(len(key), dtype=torch.bool, device=key.device)
    changed[1:] = sorted_key[1:] != sorted_key[:-1]
    del sorted_key
    r = torch.cumsum(changed, 0, dtype=torch.int32)
    rank = torch.empty_like(r)
    rank[order] = r
    return rank, order, int(r[-1]) == len(key) - 1


def suffix_array_t(codes: torch.Tensor) -> torch.Tensor:
    """Suffix array (int64) of a uint8 code tensor (values 0..3), on the
    tensor's device. Raises for n >= 2^31."""
    n = len(codes)
    dev = codes.device
    if n <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    if n >= 2**31:
        raise ValueError(f"suffix_array: text of {n} chars needs int64 ranks")
    K = min(FIRST_KEY_CHARS, n)
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for t in range(K):
        nxt = torch.zeros(n, dtype=torch.int64, device=dev)
        nxt[: n - t] = codes[t:].to(torch.int64) + 1  # 0: past the end
        key = key * 5 + nxt
    del nxt
    rank, order, done = _dense_rank(key)
    k = K
    while not done:
        # (rank of i, rank of i+k or -1 past the end): a shorter suffix
        # sorts first, as the sentinel makes it
        key = rank.to(torch.int64) * (n + 1)
        if k < n:
            key[: n - k] += rank[k:].to(torch.int64) + 1
        rank, order, done = _dense_rank(key)
        k *= 2
    return order


def suffix_array(codes: np.ndarray, device: torch.device) -> np.ndarray:
    """Suffix array of ``codes`` (uint8, values 0..3) as int64 [n],
    sorted on ``device`` by prefix doubling."""
    t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(device)
    return suffix_array_t(t).cpu().numpy()


def bwt_from_sa_t(codes: torch.Tensor, sa: torch.Tensor):
    """``bwt_from_sa`` on tensors, on their device."""
    n = len(codes)
    primary = int(torch.nonzero(sa == 0)[0, 0]) + 1
    chars = codes[sa - 1]  # rows 1..n; the cell at sa == 0 is dropped
    out = torch.empty(n, dtype=torch.uint8, device=codes.device)
    out[0] = codes[-1]  # row 0: the sentinel suffix, preceded by the last char
    out[1:primary] = chars[: primary - 1]
    out[primary:] = chars[primary:]
    return out, primary


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over text+sentinel, returned WITHOUT the sentinel cell.

    Returns (bwt codes uint8 [n], primary): ``primary`` is the row of the
    full (n+1)-row BWT matrix that holds the sentinel (row 0 is the
    sentinel suffix), and bwt[i] for i >= primary is full row i+1.
    """
    out, primary = bwt_from_sa_t(
        torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)),
        torch.from_numpy(np.asarray(sa, dtype=np.int64)),
    )
    return out.numpy(), primary
