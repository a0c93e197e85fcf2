"""Suffix-array construction for the FM index (host-side index build).

The reference builds its suffix array with a native SA-IS library
(``megapath_tpu/index/suffix.py``, g++ at first use) and falls back to
numpy prefix doubling. The port does prefix doubling in PyTorch on the
device it is given. The first key is the suffix's first 13 characters;
each round then sorts one int64 key, (rank of the suffix, rank of the
suffix k characters on), and doubles k, so a random text is sorted in
three sorts. A text has one suffix array, so every correct builder
gives the same one; ``tests/test_torch_index.py`` holds it equal to the
reference's.

Memory is what limits the build on a card, so the sort works in four
buffers allocated once: two int64 key buffers and two int32 position
buffers (24 bytes a character, with the text 25). On a card they are the
double buffers of CUB's radix sort (``ops/sort_cuda.py``); on the CPU
``torch.sort`` (the plain version) writes into them. Between sorts the
spare key buffer holds the dense ranks and their prefix sums as int32,
and the passes that would make an n-long temporary (the rank prefix sum,
the rank scatter, the BWT gather) run in chunks of ``CHUNK`` characters.
Ranks and positions are int32 (a shard is < 2^31 characters).

The text is the 2-bit code array; a virtual sentinel smaller than every
character terminates it (the suffix array covers positions 0..n-1, the
sentinel suffix is implicit and excluded).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

FIRST_KEY_CHARS = 13  # 5^13 < 2^31: one base-5 key, 0 past the end
CHUNK = 1 << 24  # characters a chunked pass takes at once


def chunks(n: int):
    """(start, end) of the chunked passes over n items."""
    return ((a, min(n, a + CHUNK)) for a in range(0, n, CHUNK))


def stage(stages: Optional[dict], name: str, t0: float, dev: torch.device) -> float:
    """Record stage ``name`` into ``stages`` (when given): its seconds since
    ``t0`` and, on a card, its peak allocated bytes (the peak counter is
    reset for the next stage). Returns the time now."""
    if stages is not None:
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        stages[name] = (time.perf_counter() - t0, peak)
    return time.perf_counter()


def _add_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst += src (int64 += a narrower type) in chunks, so no cast of
    ``src`` is ever longer than a chunk."""
    for a, b in chunks(len(dst)):
        dst[a:b].add_(src[a:b])


def _sort_pairs(keys: list, vals: list, src: int, end_bit: int) -> int:
    """Sort ``keys[src]`` with ``vals[src]``; returns the index of the
    buffers that hold the sorted pairs. A card sorts with CUB, the CPU
    with torch.sort; any correct sort gives the one suffix array."""
    dev = keys[src].device
    if dev.type == "cuda":
        from megapath_tpu_torch.ops.sort_cuda import sort_pairs_cuda

        return sort_pairs_cuda(keys, vals, src, end_bit)
    if dev.type != "cpu":
        raise ValueError(f"no pair sort for tensors on {dev}")
    sorted_keys, order = torch.sort(keys[src])
    keys[1 - src].copy_(sorted_keys)
    vals[1 - src].copy_(vals[src][order])
    return 1 - src


def _dense_rank(sorted_keys: torch.Tensor, order: torch.Tensor, spare: torch.Tensor):
    """Dense ranks of the sorted keys, scattered back to text positions.
    ``spare`` (int32 [2n], the free key buffer) receives the ranks in
    sorted order in its first half and by position in its second. Returns
    (rank by position, the number of distinct keys)."""
    n = len(order)
    r, rank = spare[:n], spare[n:]
    carry = torch.zeros((), dtype=torch.int32, device=order.device)
    for a, b in chunks(n):
        lo = max(a, 1)
        part = r[a:b]
        part[lo - a :] = sorted_keys[lo:b] != sorted_keys[lo - 1 : b - 1]
        if a == 0:
            part[0] = 0
        part.cumsum_(0)
        part += carry
        carry = part[-1].clone()
    for a, b in chunks(n):
        rank[order[a:b].long()] = r[a:b]
    return rank, int(carry) + 1


def suffix_array_t(codes: torch.Tensor, stages: Optional[dict] = None) -> torch.Tensor:
    """Suffix array (int32) of a uint8 code tensor (values 0..3), on the
    tensor's device. Raises for n >= 2^31. A ``stages`` dict receives each
    sort round's seconds and card peak (``stage``)."""
    n = len(codes)
    dev = codes.device
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    if n >= 2**31:
        raise ValueError(f"suffix_array: text of {n} chars needs int64 ranks")
    t0 = time.perf_counter()
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    K = min(FIRST_KEY_CHARS, n)
    key = keys[0]
    key.zero_()
    for t in range(K):
        key.mul_(5)
        _add_(key[: n - t], codes[t:])
        key[: n - t].add_(1)  # 0: past the end
    src, end_bit, k, rnd = 0, (5**K - 1).bit_length(), K, 0
    while True:
        torch.arange(n, dtype=torch.int32, device=dev, out=vals[src])
        s = _sort_pairs(keys, vals, src, end_bit)
        rank, distinct = _dense_rank(keys[s], vals[s], keys[1 - s].view(torch.int32))
        t0 = stage(stages, f"sort round {rnd} ({k} chars)", t0, dev)
        if distinct == n:
            break
        # (rank of i, rank of i+k or 0 past the end) over distinct + 1
        # values of the second: a shorter suffix sorts first, as the
        # sentinel makes it
        key = keys[s]
        key.copy_(rank)
        key.mul_(distinct + 1)
        if k < n:
            _add_(key[: n - k], rank[k:])
            key[: n - k].add_(1)
        src, end_bit = s, ((distinct - 1) * (distinct + 1) + distinct).bit_length()
        k *= 2
        rnd += 1
    sa = vals[s]
    del keys, rank, vals
    return sa


def suffix_array(codes: np.ndarray, device: torch.device) -> np.ndarray:
    """Suffix array of ``codes`` (uint8, values 0..3) as int64 [n],
    sorted on ``device`` by prefix doubling."""
    t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(device)
    return suffix_array_t(t).cpu().numpy().astype(np.int64)


def bwt_from_sa_t(codes: torch.Tensor, sa: torch.Tensor):
    """``bwt_from_sa`` on tensors, on their device (``sa`` int32 or
    int64), gathered in chunks."""
    n = len(codes)
    primary = int(torch.nonzero(sa == 0)[0, 0]) + 1
    out = torch.empty(n, dtype=torch.uint8, device=codes.device)
    out[0] = codes[-1]  # row 0: the sentinel suffix, preceded by the last char
    # suffix row j (full row j + 1) is preceded by codes[sa[j] - 1]; the
    # row at sa == 0 (j = primary - 1) holds the sentinel and is dropped
    for a, b in chunks(n):
        chars = codes[(sa[a:b].long() - 1).clamp_min(0)]
        lo, hi = a, min(b, primary - 1)
        if lo < hi:
            out[lo + 1 : hi + 1] = chars[: hi - lo]
        lo = max(a, primary)
        if lo < b:
            out[lo:b] = chars[lo - a :]
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
