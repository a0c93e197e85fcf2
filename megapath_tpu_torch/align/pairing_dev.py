"""Insert-window candidate pairing on the device: ``pairing.pair_candidates``
in torch ops over the kept clusters that ``seeding_dev.decode_seeds_device``
left on the engine's device.

The clusters come as the decode made them: one row a kept cluster, its
read a read end of the seeded batch (``[0, n_pairs)`` the first ends,
``[n_pairs, 2 n_pairs)`` the second), its strand and its start. Each row
falls in one of four classes, the two leg assignments' left legs (+ strand
first ends, + strand second ends) and their right legs (- strand second
ends, - strand first ends), and one stable sort by (class, pair, start)
lays out both assignments as ``pair_candidates`` sorts them. The
divide-gap compression of the left legs is the decode's anchor chain by
pointer doubling; the window join is two searches of each kept anchor's
partner run. Every size is exact: the candidate total is read back as a
scalar, and the candidates come back in one pull, equal to
``pair_candidates`` on the same clusters field for field, in its order
and dtypes.

The one-program step pairs in ``parallel/spmd_full.py`` (``orient``) at
static caps; this module serves the engine's passes, which pair at exact
sizes.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from megapath_tpu_torch.align.pairing import Candidates
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align.seeding_dev import (
    _chain_anchors,
    _first_of_runs,
    _lexsort,
    _seg_search,
)
from megapath_tpu_torch.ops import _build

# the kept clusters ``pair_candidates_device`` read and the candidates it
# produced, over every call (counted through ``_build.count``)
pair_rows_device = 0
pair_cands_device = 0


def _empty() -> Candidates:
    z = np.zeros(0)
    return Candidates(z.astype(np.int32), z.astype(np.int64), z.astype(np.int64), z.astype(bool))


def pair_candidates_device(
    read: torch.Tensor,  # int [K] read end of each kept cluster, [0, 2 n_pairs)
    strand: torch.Tensor,  # int [K] 0 = +, 1 = -
    pos: torch.Tensor,  # int64 [K] cluster start
    lens: torch.Tensor,  # int [>= 2 n_pairs] read-end lengths, first ends then second
    n_pairs: int,
    params: AlignParams,
    pairs: Optional[torch.Tensor] = None,  # int64 [n_pairs] ascending pair ids
) -> Candidates:
    """``pair_candidates`` on the clusters' device. Pair ``i`` of the
    result is ``pairs[i]`` (``i`` itself without ``pairs``); ``pairs``
    must ascend, so that the order by pair is the reference's."""
    mod = sys.modules[__name__]
    K = read.shape[0]
    _build.count(mod, "pair_rows_device", K)
    if K == 0:
        return _empty()
    i64 = torch.int64
    dev = read.device
    t = n_pairs
    read, strand, pos = read.to(i64), strand.to(i64), pos.to(i64)
    end = (read >= t).to(i64)
    pid = read - end * t
    # left legs: class 0 (first end, +), 1 (second end, +); the right legs
    # they pair with: class 2 (second end, -), 3 (first end, -)
    cls = torch.where(strand == 0, end, 3 - end)
    run = cls * t + pid
    order = _lexsort((pos, run))
    run, pos, cls, pid = run[order], pos[order], cls[order], pid[order]
    iota = torch.arange(K, dtype=i64, device=dev)
    first = _first_of_runs(run)
    seg = torch.cumsum(first.to(i64), 0) - 1
    seg_end = torch.searchsorted(run, run, right=True)

    # divide-gap compression: the anchor chains of each left run, nxt the
    # first start past the anchor + divide_gap
    nxt = _seg_search(pos, seg, iota, seg_end, pos + params.divide_gap, strict=True)
    left = cls < 2
    anchor = _chain_anchors(first, nxt, seg_end, left)

    # the window join: the right run of the same pair in the other
    # assignment class, starts in [left + length_low, left + length_high]
    partner = (cls + 2) * t + pid
    lo = torch.searchsorted(run, partner)
    hi = torch.searchsorted(run, partner, right=True)
    right_end = torch.where(left, 1 - cls, cls - 2)  # the partner's end
    rl = lens.to(i64)[right_end * t + pid]
    margin = torch.where(rl > 100, 30, 25)
    length_low = torch.clamp_min(params.insert_low - rl - margin, 0)
    length_high = params.insert_high - rl + margin
    s = _seg_search(pos, seg, lo, hi, pos + length_low, strict=False)
    e = _seg_search(pos, seg, lo, hi, pos + length_high, strict=True)
    counts = torch.where(anchor, torch.clamp_min(e - s, 0), 0)
    tot = int(counts.sum())
    _build.count(mod, "pair_cands_device", tot)
    if tot == 0:
        return _empty()
    aidx = torch.repeat_interleave(iota, counts, output_size=tot)
    within = torch.arange(tot, dtype=i64, device=dev) - (torch.cumsum(counts, 0) - counts)[aidx]
    ridx = s[aidx] + within
    pair = pid[aidx] if pairs is None else pairs.to(i64)[pid[aidx]]
    p, lp, rp, flip = torch.stack((pair, pos[aidx], pos[ridx], cls[aidx])).cpu().numpy()
    return Candidates(p.astype(np.int32), lp, rp, flip.astype(bool))
