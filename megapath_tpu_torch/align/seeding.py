"""MMP (maximal-mappable-prefix) seeding over the FM-index.

Batched re-expression of soap4's per-thread seed walks
(soap4/DV-DPfunctions.cpp mmp<0> :2226-2267 and mmp<2>
:2319-2377): a walker consumes the read back-to-front through FM
backward search, emitting a seed whenever the SA interval would empty,
with k-mer-LUT jump starts, narrowing-tracked reseed rollback, and
overlap restarts (i -= min(seed_len, seed_min_length)).

Key structural move: the reference's negative-strand walk (mmp<2>:
forward over the read, complemented) is EXACTLY the positive-strand
walk run on the reverse-complemented read. So both strands share one
state machine: walkers = [reads; revcomp(reads)], and all walkers step
in lockstep as dense batched rank queries — the TPU-friendly layout
(SURVEY.md §7 step 4) instead of per-read pointer chasing.

Seed coordinates: a seed at walk emission covers read indices
[len-i, len-i+seed_len) of the *walker's* sequence; for revcomp
walkers the decoded text position is already the leftmost coordinate
of the aligned revcomp read, matching mmpSeeding's
``SaValue - (read_len - seedlen - off)`` (DV-DPfunctions.cpp:2489).

This is the port's copy of ``megapath_tpu/align/seeding.py``. The reference
module cannot be imported without jax (``megapath_tpu.align`` loads the
engine, which loads jax), so the port carries its own numpy copy;
``tests/test_torch_seeding.py`` and ``tests/test_torch_engine.py`` hold
the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from megapath_tpu_torch.align.params import MmpParams
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import COMPLEMENT


@dataclass
class Seeds:
    """Flat seed table; walker w = read r strand s via w = r + s*n_reads."""

    walker: np.ndarray  # int32 [S]
    offset: np.ndarray  # int32 [S] seed start within the walker sequence
    length: np.ndarray  # int32 [S]
    sa_lo: np.ndarray  # int64 [S] full-row interval start
    sa_count: np.ndarray  # int32 [S] capped occurrence count

    def __len__(self) -> int:
        return len(self.walker)


def make_walkers(reads: np.ndarray, lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[reads; revcomp(reads)] with per-walker lengths."""
    n, L = reads.shape
    rc = np.zeros_like(reads)
    for i in range(n):  # revcomp within the valid length
        l = lens[i]
        rc[i, :l] = COMPLEMENT[reads[i, :l][::-1]]
    return np.concatenate([reads, rc], axis=0), np.concatenate([lens, lens])


def make_walkers_fast(reads: np.ndarray, lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized make_walkers (no per-read loop)."""
    n, L = reads.shape
    lens = np.asarray(lens, dtype=np.int32)
    # reverse each row within its valid length: idx j -> len-1-j
    j = np.arange(L)[None, :]
    src = lens[:, None] - 1 - j
    valid = src >= 0
    src = np.clip(src, 0, L - 1)
    rc = COMPLEMENT[np.take_along_axis(reads, src, axis=1)]
    rc = np.where(valid, rc, 0).astype(np.uint8)
    return np.concatenate([reads, rc], axis=0), np.concatenate([lens, lens])


def mmp_seed(
    walkers: np.ndarray,  # uint8 [W, L]
    lens: np.ndarray,  # int32 [W]
    fm: FMIndex,
    params: MmpParams,
    max_steps: Optional[int] = None,
) -> Seeds:
    """Run the batched MMP state machine; returns all emitted seeds."""
    Wn, L = walkers.shape
    lens = np.asarray(lens, dtype=np.int64)
    k = fm.lut_k
    use_lut = k and k > 0

    # natural-order k-mer value starting at each index (only j <= len-k valid)
    if use_lut:
        km = np.zeros((Wn, L), dtype=np.int64)
        acc = np.zeros((Wn, L), dtype=np.int64)
        for j in range(k):
            shifted = np.zeros((Wn, L), dtype=np.int64)
            shifted[:, : L - j] = walkers[:, j:]
            acc = acc * 4 + shifted
        km = acc  # km[:, j] = value of seq[j:j+k] (A-padded past end)

    n_rows = fm.n + 1
    i = np.zeros(Wn, dtype=np.int64)  # walk cursor
    lo = np.zeros(Wn, dtype=np.int64)
    hi = np.full(Wn, n_rows, dtype=np.int64)
    seed_len = np.zeros(Wn, dtype=np.int64)
    last_lo = np.zeros(Wn, dtype=np.int64)
    last_hi = np.full(Wn, n_rows, dtype=np.int64)
    last_len = np.zeros(Wn, dtype=np.int64)
    active = lens >= params.seed_min_length

    out_w: List[np.ndarray] = []
    out_off: List[np.ndarray] = []
    out_len: List[np.ndarray] = []
    out_lo: List[np.ndarray] = []
    out_cnt: List[np.ndarray] = []

    def emit(idx: np.ndarray, at_end: bool) -> None:
        """CHECK_AND_ADD_RANGE for walkers idx (interval would empty /
        walk exhausted). Mutates state in place."""
        if len(idx) == 0:
            return
        sl = seed_len[idx]
        diff = np.zeros(len(idx), dtype=np.int64)
        # reseed rollback (DV-DPfunctions.cpp:2202-2206)
        can = sl >= params.seed_min_length
        rb = (
            can
            & (sl >= params.reseed_len)
            & ((last_hi[idx] - last_lo[idx]) <= params.sa_size_threshold)
            & (
                ((sl - last_len[idx]) <= params.reseed_abs_diff)
                | (sl * params.reseed_rlt_ratio < last_len[idx])
            )
        )
        diff[rb] = (sl - last_len[idx])[rb]
        lo[idx[rb]] = last_lo[idx[rb]]
        hi[idx[rb]] = last_hi[idx[rb]]
        seed_len[idx[rb]] = last_len[idx[rb]]
        sl = seed_len[idx]

        keep = sl >= params.seed_min_length
        kidx = idx[keep]
        if len(kidx):
            n_emitted[kidx] += 1
            out_w.append(kidx.astype(np.int32))
            out_off.append((lens[kidx] - i[kidx]).astype(np.int32))
            out_len.append(sl[keep].astype(np.int32))
            out_lo.append(lo[kidx])
            cnt = np.minimum(hi[kidx] - lo[kidx], params.sa_size_threshold + 1)
            out_cnt.append(cnt.astype(np.int32))

        if not at_end:
            # restart with overlap: i -= diff + min(seed_len, minLen),
            # then the loop's ++i (we fold it into the step logic below)
            i[idx] -= diff + np.minimum(sl, params.seed_min_length) - 1
            lo[idx] = 0
            hi[idx] = n_rows
            seed_len[idx] = 0
            last_lo[idx] = 0
            last_hi[idx] = n_rows
            last_len[idx] = 0

    wsteps = np.zeros(Wn, dtype=np.int64)  # per-walker lockstep steps
    n_emitted = np.zeros(Wn, dtype=np.int64)  # stored seeds per walker
    # sibling-cull latches (one-shot probe at charged step T0)
    latched = np.zeros(Wn, dtype=bool)
    probe = np.zeros(Wn, dtype=bool)
    victim = np.zeros(Wn, dtype=bool)
    limit = max_steps if max_steps is not None else int(3 * L + 64)
    for _ in range(limit):
        # progress kill (matches seeding_jax.device_mmp_seed): retire
        # walkers whose step spend exceeds kill_ratio * chars + base —
        # junk walkers grind ~5 steps/char, productive ones ~1.
        if params.kill_ratio > 0:
            over = active & (wsteps > params.kill_ratio * i + params.kill_base)
            active[over] = False
        if getattr(params, "sibling_kill_steps", 0) > 0 and Wn % 2 == 0:
            # one-shot sibling-evidence cull (see MmpParams): latch at
            # charged step T0 (or retirement); a latched victim
            # freezes until its opposite-strand sibling latches, then
            # dies iff the sibling probed >= good_seed_len evidence.
            T0 = params.sibling_kill_steps
            newly = ~latched & ((wsteps >= T0) | ~active)
            probe[newly] = seed_len[newly] >= params.good_seed_len
            victim[newly] = (
                active[newly]
                & (n_emitted[newly] == 0)
                & (last_len[newly] == 0)
                & (seed_len[newly] < params.seed_min_length)
            )
            latched[newly] = True
            half = Wn // 2
            sib_latched = np.roll(latched, half)
            sib_probe = np.roll(probe, half)
            mine = active & latched & victim
            kill = mine & sib_latched & sib_probe
            active[kill] = False
            # victims freeze (uncharged) until the sibling latches;
            # on the host all active walkers charge together so the
            # pause resolves immediately, but keep the spec exact
            paused = mine & ~sib_latched
        else:
            paused = None
        if np.count_nonzero(active) == 0:
            break
        if paused is not None:
            act = np.flatnonzero(active & ~paused)
        else:
            act = np.flatnonzero(active)
        wsteps[act] += 1

        fresh = act[seed_len[act] == 0]
        ext = act[seed_len[act] != 0]

        # ---- fresh walkers: LUT k-jump (or single-char start) --------
        if len(fresh):
            rem = lens[fresh] - i[fresh]
            dead = fresh[rem < params.seed_min_length]
            active[dead] = False
            fresh = fresh[rem >= params.seed_min_length]
        if len(fresh):
            if use_lut:
                # k-mer at read index len - i - k (walk covers k chars)
                j0 = lens[fresh] - i[fresh] - k
                v = km[fresh, j0]
                nlo, nhi = fm.lut_interval(v)
                ok = nlo < nhi
                okf = fresh[ok]
                # success: consumed k chars total
                lo[okf] = nlo[ok]
                hi[okf] = nhi[ok]
                seed_len[okf] = k
                i[okf] += k
                # failure: empty LUT bucket; seed_len k-1 < minLen is
                # discarded and the cursor net-advances one char
                badf = fresh[~ok]
                i[badf] += 1
            else:
                jj = lens[fresh] - 1 - i[fresh]
                c = walkers[fresh, jj]
                nlo, nhi = fm.extend_backward(lo[fresh], hi[fresh], c)
                ok = nlo < nhi
                okf = fresh[ok]
                lo[okf] = nlo[ok]
                hi[okf] = nhi[ok]
                seed_len[okf] += 1
                i[okf] += 1
                i[fresh[~ok]] += 1

        # ---- extending walkers: one backward-search step -------------
        if len(ext):
            done = ext[i[ext] >= lens[ext]]
            emit(done, at_end=True)
            active[done] = False
            ext = ext[i[ext] < lens[ext]]
        if len(ext):
            jj = lens[ext] - 1 - i[ext]
            c = walkers[ext, jj]
            nlo, nhi = fm.extend_backward(lo[ext], hi[ext], c)
            ok = nlo < nhi
            oke = ext[ok]
            # CHECK_AND_SET_LAST: record state before a narrowing step
            narrow = (nhi[ok] - nlo[ok]) < (hi[oke] - lo[oke])
            upd = oke[(seed_len[oke] >= params.seed_min_length) & narrow]
            last_lo[upd] = lo[upd]
            last_hi[upd] = hi[upd]
            last_len[upd] = seed_len[upd]
            lo[oke] = nlo[ok]
            hi[oke] = nhi[ok]
            seed_len[oke] += 1
            i[oke] += 1
            emit(ext[~ok], at_end=False)

    # walkers that exhausted the loop with a live seed
    live = np.flatnonzero(active & (seed_len > 0) & (i >= lens))
    emit(live, at_end=True)

    if out_w:
        return Seeds(
            walker=np.concatenate(out_w),
            offset=np.concatenate(out_off),
            length=np.concatenate(out_len),
            sa_lo=np.concatenate(out_lo),
            sa_count=np.concatenate(out_cnt),
        )
    z = np.zeros(0, dtype=np.int32)
    return Seeds(z, z, z, z.astype(np.int64), z)


@dataclass
class SeedPositions:
    """Per-(read, strand) clustered candidate start positions."""

    read: np.ndarray  # int32 [C] read index
    strand: np.ndarray  # int8 [C] 0=+, 1=-
    pos: np.ndarray  # int64 [C] leftmost text coordinate of the aligned read
    coverage: np.ndarray  # int32 [C] merged seed coverage (paired_seedLength)


def decode_seeds(
    seeds: Seeds,
    fm: FMIndex,
    lens: np.ndarray,  # per-READ lengths [n_reads]
    n_reads: int,
    params: MmpParams,
    locate_fn=None,
    pre_pos: np.ndarray | None = None,
) -> SeedPositions:
    """SA intervals -> clustered/filtered candidate positions.

    Mirrors the decode+filter block of mmpSeeding
    (DV-DPfunctions.cpp:2475-2552): locate up to sa_size_threshold+1
    hits per seed, long-enough seeds count as unique, cluster positions
    within indel_fuzz, keep clusters with a unique-enough member or
    merged coverage >= good_seed_len, then drop clusters shorter than
    short_seed_ratio * best coverage of the read.
    """
    if len(seeds) == 0:
        z = np.zeros(0)
        return SeedPositions(
            z.astype(np.int32), z.astype(np.int8), z.astype(np.int64), z.astype(np.int32)
        )

    # flatten: one row per decoded SA position
    cnt = seeds.sa_count.astype(np.int64)
    tot = int(cnt.sum())
    seed_idx = np.repeat(np.arange(len(seeds)), cnt)
    within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    if pre_pos is not None:
        # positions already located on device in the same program as
        # the seed walk (device_seed_pipeline_loc), one row per
        # expanded SA position in this exact flat order
        assert len(pre_pos) == tot, (len(pre_pos), tot)
        text_pos = pre_pos
    else:
        rows = seeds.sa_lo[seed_idx] + within
        text_pos = (
            locate_fn(rows) if locate_fn is not None else fm.locate(rows)
        )

    walker = seeds.walker[seed_idx]
    read = walker % n_reads
    strand = (walker >= n_reads).astype(np.int8)
    offset = seeds.offset[seed_idx].astype(np.int64)
    length = seeds.length[seed_idx].astype(np.int64)
    start = text_pos - offset  # leftmost coord of the aligned walker seq

    rlen = np.asarray(lens, dtype=np.int64)[read]
    unique_enough = (length >= params.good_seed_len) | (length >= rlen // 2)
    multiplicity = np.where(unique_enough, 1, cnt[seed_idx])

    # sort by (walker, start) to form clusters
    order = np.lexsort((start, walker))
    walker_s = walker[order]
    start_s = start[order]
    off_s = offset[order]
    len_s = length[order]
    mult_s = multiplicity[order]

    n = len(order)
    # cluster ids: break on walker change or start > first-of-cluster +
    # indel_fuzz (anchor-chain). Vectorized as pointer jumping over a
    # composite (walker, start) key: next[i] = first index past the
    # anchor's fuzz window, then walk the orbit from each walker's
    # first row — one vectorized round per cluster DEPTH (max seeds per
    # walker, ~8) instead of one searchsorted per cluster.
    wchange = np.flatnonzero(np.r_[True, walker_s[1:] != walker_s[:-1], True])
    key = (walker_s.astype(np.int64) << 33) | (start_s - start_s.min())
    nxt = np.searchsorted(
        key, (walker_s.astype(np.int64) << 33)
        | (start_s - start_s.min() + params.indel_fuzz),
        side="right",
    )
    seg_end = wchange[
        np.searchsorted(wchange, np.arange(n, dtype=np.int64), side="right")
    ]
    parts: List[np.ndarray] = []
    active = wchange[:-1].astype(np.int64)
    while len(active):
        parts.append(active)
        active = nxt[active]
        active = active[active < seg_end[parts[-1]]]
    bounds_arr = np.sort(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
    n_clusters = len(bounds_arr)
    if n_clusters == 0:
        z = np.zeros(0)
        return SeedPositions(
            z.astype(np.int32), z.astype(np.int8), z.astype(np.int64), z.astype(np.int32)
        )
    cluster_of = np.zeros(n, dtype=np.int64)
    cluster_of[bounds_arr] = 1
    cluster_of = np.cumsum(cluster_of) - 1

    # has_unique per cluster
    uniq_flag = (
        (mult_s <= params.uniq_threshold) & (len_s >= params.seed_min_length)
    ).astype(np.int64)
    has_unique = np.maximum.reduceat(uniq_flag, bounds_arr) > 0

    # merged read-interval coverage per cluster (vectorized union):
    # sort members by (cluster, interval start); running max of ends
    # reset per cluster via the add-big-offset trick
    o2 = np.lexsort((off_s, cluster_of))
    cl2 = cluster_of[o2]
    s2 = off_s[o2].astype(np.int64)
    e2 = (off_s + len_s)[o2].astype(np.int64)
    BIG = int(e2.max(initial=0)) + 1
    shifted_e = e2 + cl2 * BIG
    cummax = np.maximum.accumulate(shifted_e)
    first_of_cluster = np.zeros(n, dtype=bool)
    first_of_cluster[np.flatnonzero(np.r_[True, cl2[1:] != cl2[:-1]])] = True
    prev_max = np.where(
        first_of_cluster, cl2 * BIG, np.r_[cl2[0] * BIG, cummax[:-1]]
    ) - cl2 * BIG
    add = np.maximum(0, e2 - np.maximum(s2, prev_max))
    cov = np.add.reduceat(add, np.flatnonzero(first_of_cluster))
    # reduceat groups are per (sorted) cluster == cluster index order
    coverage = cov.astype(np.int64)

    cl_walker = walker_s[bounds_arr]
    cl_read = (cl_walker % n_reads).astype(np.int64)
    cl_strand = (cl_walker >= n_reads).astype(np.int8)
    cl_pos = start_s[bounds_arr]

    # per-read max coverage (over ALL clusters, both strands)
    best_cov = np.zeros(n_reads, dtype=np.int64)
    np.maximum.at(best_cov, cl_read, coverage)

    keep = (has_unique | (coverage >= params.good_seed_len)) & (
        coverage >= params.short_seed_ratio * best_cov[cl_read]
    )
    return SeedPositions(
        read=cl_read[keep].astype(np.int32),
        strand=cl_strand[keep],
        pos=cl_pos[keep].astype(np.int64),
        coverage=coverage[keep].astype(np.int32),
    )


def _union_len(starts: np.ndarray, ends: np.ndarray) -> int:
    """Total length of the union of [start, end) intervals."""
    order = np.argsort(starts, kind="stable")
    total = 0
    cur_s, cur_e = 0, 0
    for s, e in zip(starts[order], ends[order]):
        if s >= cur_e:
            total += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return int(total)
