"""Device seeding: FM tables on the engine's device, the MMP seed walk,
the SA locate, the flatten and position expansion between them, and the
decode of the located rows into clustered candidate positions.

Port of ``megapath_tpu/align/seeding_jax.py``. The walk and the locate
each have a plain PyTorch version here (``mmp_seed_device_plain``,
``locate_device_plain``: the CPU path and the reference the card's
kernels are held to) and a hand-written CUDA kernel
(``csrc/mmp_seed.cu``, ``csrc/locate.cu`` through ``ops/seed_cuda.py``).
``mmp_seed_device`` and ``locate_device`` pick by the tensors' device:
the plain version on the CPU, the kernel on a card, never one for the
other.

The table layout is the port's own. The JAX package's paired and classic
occ rows, its two-phase walk and its staged compaction were choices for
the TPU's gather unit and its static shapes; the seeds are the same in
every layout, and the tests hold the port against both JAX layouts.
The flatten and expansion size their buffers from the counts (one sync
each), so there are no caps and no overflow fallbacks. The decode
(``decode_seeds_device``) runs in torch ops at those exact sizes, with the
sort and segment helpers that the one-program step
(``parallel/spmd_full.py``) runs at its static caps; its kept clusters
stay on the device for the pairing (``pairing_dev``).

The walk computes the reseed test and the progress kill in float32, as
the JAX device walk does. The host walk (``seeding.mmp_seed``) computes
the reseed test in float64, and the two can differ (ROADMAP §C).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from megapath_tpu_torch.align.params import MmpParams
from megapath_tpu_torch.align.seeding import SeedPositions
from megapath_tpu_torch.index.fm import OCC_BLOCK, WORD_CHARS, FMIndex
from megapath_tpu_torch.ops import _build

ROW_WORDS = 16  # occ row: 4 checkpoints | 8 packed BWT words | 4 mark words
WORDS_PER_BLOCK = OCC_BLOCK // WORD_CHARS
MARK_WORD = 4 + WORDS_PER_BLOCK  # the first of a row's 4 mark-bit words
U32 = 0xFFFFFFFF
I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
# (segment, value) search keys: value + 2**33 in the low 34 bits
_KEY_SHIFT = 34
_KEY_BIAS = 2**33

# the expanded SA rows ``decode_seeds_device`` clustered and the clusters
# it read back, over every call (counted through ``_build.count``)
decode_rows_device = 0
decode_kept_device = 0


def _i32_bits(a: np.ndarray) -> np.ndarray:
    """uint32 numpy array -> int32 array of the same bits (the kernels
    read them as uint32)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return t.to(torch.int64) & U32


def _pack_bits(bits: np.ndarray, n_words: int) -> np.ndarray:
    """bool [m] -> uint32 [n_words]: bit t of word q is bits[32 q + t]
    (zeros past m)."""
    packed = np.zeros(4 * n_words, np.uint8)
    b = np.packbits(bits, bitorder="little")
    packed[: len(b)] = b
    return packed.view("<u4").astype(np.uint32)


@dataclass
class DeviceFM:
    """One shard's FM tables on one torch device (int32 coordinates).

    ``rows``: one 64-byte row per 128-char BWT block, row b = the occ
    checkpoint at 128*b (4 counts) || the block's 8 packed BWT words ||
    the block's 128 mark bits (4 words); so a rank query, or an LF step
    with its mark test, is one row fetch. Mark bit j of row b is
    marked(r) for the full row r whose sentinel-free coordinate
    ``adj = r - (r > primary)`` is 128*b + j, the coordinate the LF step
    ranks in; row ``primary`` shares its adj with ``primary + 1`` (whose
    bit it is) and always holds text position 0, so it is marked.
    ``mark_rows``: one (bitmap word, rank checkpoint) pair per 32 full
    rows, as ``pack_mark_rank`` in the reference, for the rank at a mark.
    The k-mer table stays the host's ``lut_lo``/``lut_hi`` (big-endian
    key)."""

    n: int
    primary: int
    lut_k: int
    sa_interval: int
    rows: torch.Tensor  # int32 [n_blocks + 1, 16] (uint32 bits)
    counts: torch.Tensor  # int32 [5]
    lut_lo: Optional[torch.Tensor]  # int32 [4^k]
    lut_hi: Optional[torch.Tensor]
    mark_rows: torch.Tensor  # int32 [ceil((n + 1) / 32), 2] (uint32 bits)
    sa_sampled: torch.Tensor  # int32 [n_marked]

    @classmethod
    def from_host(cls, fm: FMIndex, device: torch.device) -> "DeviceFM":
        """The tables of ``fm``, packed on the host and copied to
        ``device``."""
        return HostFM.pack(fm).upload(device)

    @property
    def nbytes(self) -> int:
        """The bytes these tables hold on their device."""
        return sum(t.numel() * t.element_size() for t in (
            self.rows, self.counts, self.lut_lo, self.lut_hi, self.mark_rows,
            self.sa_sampled) if t is not None)


@dataclass
class HostFM:
    """``DeviceFM``'s tables packed on the host, before their upload.

    The packing reads the FM index's full-length arrays (``mark_rank`` is
    8 bytes a character) and costs far more than the upload, so an engine
    that rotates through its device keeps these after its first commit and
    re-commits with ``upload`` alone. The arrays the packing makes
    (``rows``, ``mark_rows``, the int32 ``sa_sampled``) hold ~1.25 bytes a
    character at sa_interval 8; the rest are views of the index's."""

    n: int
    primary: int
    lut_k: int
    sa_interval: int
    rows: np.ndarray  # int32 [n_blocks + 1, 16] (uint32 bits)
    counts: np.ndarray  # int32 [5]
    lut_lo: Optional[np.ndarray]  # int32 [4^k]
    lut_hi: Optional[np.ndarray]
    mark_rows: np.ndarray  # int32 [ceil((n + 1) / 32), 2] (uint32 bits)
    sa_sampled: np.ndarray  # int32 [n_marked]

    @classmethod
    def pack(cls, fm: FMIndex) -> "HostFM":
        """The kernels' layout of ``fm``'s tables (see ``DeviceFM``)."""
        n = int(fm.n)
        if n >= 2**31 - 1:
            raise ValueError(f"device seeding needs a shard < 2^31 - 1 chars (got {n})")
        primary = int(fm.primary)
        marked = marked_rows(fm.mark_rank, n)
        nb = fm.occ.shape[0]  # n_blocks + 1 checkpoints
        rows = np.zeros((nb, ROW_WORDS), np.uint32)
        rows[:, :4] = fm.occ
        words = np.asarray(fm.bwt_words, np.uint32).reshape(-1, WORDS_PER_BLOCK)
        rows[: len(words), 4:MARK_WORD] = words
        rows[: nb - 1, MARK_WORD:] = _pack_bits(
            np.delete(marked, primary), 4 * (nb - 1)).reshape(nb - 1, 4)
        lut_lo = lut_hi = None
        if fm.lut_k:
            lut_lo = _i32_bits(fm.lut_lo)
            lut_hi = _i32_bits(fm.lut_hi)
        return cls(
            n=n,
            primary=primary,
            lut_k=int(fm.lut_k),
            sa_interval=int(fm.sa_interval),
            rows=rows.view(np.int32),
            counts=np.asarray(fm.counts, np.int32),
            lut_lo=lut_lo,
            lut_hi=lut_hi,
            mark_rows=pack_mark_rows(fm.mark_rank, marked),
            sa_sampled=np.asarray(fm.sa_sampled, np.int32),
        )

    def upload(self, device: torch.device) -> DeviceFM:
        """These tables copied to ``device``, nothing packed again."""
        dev = torch.device(device)

        def put(a):
            return None if a is None else torch.from_numpy(a).to(dev)

        return DeviceFM(
            n=self.n, primary=self.primary, lut_k=self.lut_k, sa_interval=self.sa_interval,
            rows=put(self.rows), counts=put(self.counts), lut_lo=put(self.lut_lo),
            lut_hi=put(self.lut_hi), mark_rows=put(self.mark_rows),
            sa_sampled=put(self.sa_sampled),
        )


def marked_rows(mark_rank: np.ndarray, n: int) -> np.ndarray:
    """marked(r) for the full rows r in [0, n], from the prefix rank of
    marked rows [n + 2] (bool [n + 1])."""
    return np.not_equal(mark_rank[1 : n + 2], mark_rank[: n + 1])


def pack_mark_rows(mark_rank: np.ndarray, marked: np.ndarray) -> np.ndarray:
    """Prefix rank of marked rows [n + 2] and ``marked_rows`` [n + 1] ->
    int32 [ceil((n+1)/32), 2]: (bitmap word of rows 32q..32q+31, marks
    below row 32q), as ``seeding_jax.pack_mark_rank`` packs them."""
    nw = (len(marked) + 31) // 32
    out = np.empty((nw, 2), np.uint32)
    out[:, 0] = _pack_bits(marked, nw)
    out[:, 1] = mark_rank[0 : nw * 32 : 32]
    return out.view(np.int32)


class DeviceSeeds(NamedTuple):
    """Per-walker seed slots, as ``seeding_jax.DeviceSeeds`` (int32 here;
    slots past ``n_seeds`` hold zeros)."""

    offset: torch.Tensor  # int32 [W, S] read offset of the seed
    length: torch.Tensor  # int32 [W, S]
    sa_lo: torch.Tensor  # int32 [W, S] full-row interval start
    sa_count: torch.Tensor  # int32 [W, S] capped at sa_size_threshold + 1
    n_seeds: torch.Tensor  # int32 [W]


class FlatSeeds(NamedTuple):
    """The valid slots in row-major (walker, slot) order."""

    walker: torch.Tensor  # int32 [F]
    offset: torch.Tensor  # int32 [F]
    length: torch.Tensor  # int32 [F]
    sa_lo: torch.Tensor  # int32 [F]
    sa_count: torch.Tensor  # int32 [F]


def build_walkers(
    reads: torch.Tensor, lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[reads; revcomp(reads)] walker matrix (uint8 [2N, L]) and int32
    lengths [2N], on the reads' device (``seeding_jax.py:311-325``)."""
    N, L = reads.shape
    lens = lens.to(torch.int32)
    j = torch.arange(L, dtype=torch.int64, device=reads.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - j
    ok = src >= 0
    rc = torch.where(
        ok, 3 - torch.gather(reads.to(torch.int64), 1, src.clamp(0, L - 1)), 0
    ).to(torch.uint8)
    return torch.cat([reads, rc]), torch.cat([lens, lens])


def check_walk(L: int, params: MmpParams) -> None:
    """The JAX walk's limits (``seeding_jax.py:375-381``), kept so both
    walks take the same inputs."""
    if L > 1023:
        raise ValueError(f"device seeding caps read length at 1023 (got {L})")
    if params.sa_size_threshold + 1 > 1023:
        raise ValueError(
            f"sa_size_threshold {params.sa_size_threshold} overflows the "
            "10-bit seed-count field (max 1022)"
        )


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 tensors holding 32-bit values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def _low_bits(n: torch.Tensor) -> torch.Tensor:
    """(1 << n) - 1 for int64 tensors with 0 <= n < 63."""
    return torch.bitwise_left_shift(torch.ones_like(n), n) - 1


def _occ_in_rows(rows: torch.Tensor, rel: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Rank of char c among the first ``rel`` chars of each gathered occ
    row (int64 uint32 values [M, 16]), plus the row's checkpoint."""
    base = torch.gather(rows[:, :4], 1, c[:, None])[:, 0]
    w = rows[:, 4 : 4 + WORDS_PER_BLOCK]
    x = ~(w ^ (c * 0x55555555)[:, None]) & U32
    m = x & (x >> 1) & 0x55555555
    char_base = WORD_CHARS * torch.arange(WORDS_PER_BLOCK, device=rows.device)
    k = (rel[:, None] - char_base[None, :]).clamp(0, WORD_CHARS)
    mask = torch.where(k >= WORD_CHARS, U32, _low_bits(2 * k))
    return base + _popcount(m & mask).sum(dim=1)


def _occ_full(rows_u: torch.Tensor, primary: int, row: torch.Tensor, c: torch.Tensor):
    """#c among full-BWT rows [0, row)."""
    adj = row - (row > primary).to(torch.int64)
    return _occ_in_rows(rows_u[adj >> 7], adj & (OCC_BLOCK - 1), c)


def _occ_block(primary: int, row: torch.Tensor) -> torch.Tensor:
    """The occ row that ranks full-BWT row ``row``."""
    return (row - (row > primary).to(torch.int64)) >> 7


def mmp_seed_device_plain(
    dfm: DeviceFM,
    walkers: torch.Tensor,  # uint8 [W, L]
    lens: torch.Tensor,  # int32 [W]
    params: MmpParams,
    max_seeds: int = 16,
    max_steps: Optional[int] = None,
    charge_limit: Optional[int] = None,
    stats: Optional[dict] = None,
) -> DeviceSeeds:
    """The seed walk as a lockstep loop over all walkers, in plain torch:
    ``seeding_jax.device_mmp_seed`` (fresh walk, finalized, sibling cull
    on for an even walker count) with plain gathers in place of the TPU's
    one-hot fetches. ``max_steps`` bounds the iterations (default
    3L + 64); ``charge_limit`` retires a walker at that many charged
    steps unless it is at its read end. A ``stats`` dict receives the
    iterations the loop ran (the longest walker's), the counts of fresh
    and extending steps taken, and what the walk reads, each table entry
    once: the distinct occ rows the extending steps rank in
    (``occ_rows``) and the distinct k-mer keys the fresh steps look up
    (``lut_keys``)."""
    Wn, L = walkers.shape
    check_walk(L, params)
    dev = walkers.device
    i64 = torch.int64
    k = dfm.lut_k
    S = max_seeds
    n_rows = dfm.n + 1
    primary = dfm.primary
    min_len = params.seed_min_length
    T0 = getattr(params, "sibling_kill_steps", 0)
    sibling = T0 > 0 and Wn % 2 == 0
    limit = max_steps if max_steps is not None else 3 * L + 64
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    ratio_f = f32(params.reseed_rlt_ratio)
    kill_f, base_f = f32(params.kill_ratio), f32(params.kill_base)

    seq = walkers.to(i64)
    lens = lens.to(i64)
    rows_u = _u32(dfm.rows)
    counts = dfm.counts.to(i64)
    if k:
        # big-endian k-mer key starting at each column, A past the row end
        km = torch.zeros((Wn, L), dtype=i64, device=dev)
        for t in range(k):
            sh = torch.zeros_like(km)
            sh[:, : max(L - t, 0)] = seq[:, t:]
            km = km * 4 + sh
        lut_lo, lut_hi = dfm.lut_lo.to(i64), dfm.lut_hi.to(i64)

    zeros = lambda: torch.zeros(Wn, dtype=i64, device=dev)  # noqa: E731
    i, lo, seed_len, last_lo, last_len = zeros(), zeros(), zeros(), zeros(), zeros()
    hi = torch.full((Wn,), n_rows, dtype=i64, device=dev)
    last_hi = hi.clone()
    n_seeds, steps = zeros(), zeros()
    sib = torch.full((Wn,), -1, dtype=i64, device=dev)
    active = lens >= min_len
    out = torch.zeros((4, Wn, S), dtype=i64, device=dev)  # off, len, lo, cnt
    slot_cols = torch.arange(S, device=dev)[None, :]

    def emit(idx: torch.Tensor, end: torch.Tensor) -> None:
        """CHECK_AND_ADD_RANGE for the rows in ``idx``: rows in ``end``
        keep their cursor, the others restart with overlap."""
        nonlocal i, lo, hi, seed_len, last_lo, last_hi, last_len, n_seeds
        sl = seed_len
        rb = (
            idx
            & (sl >= min_len)
            & (sl >= params.reseed_len)
            & ((last_hi - last_lo) <= params.sa_size_threshold)
            & (
                ((sl - last_len) <= params.reseed_abs_diff)
                | (sl.to(torch.float32) * ratio_f < last_len.to(torch.float32))
            )
        )
        diff = torch.where(rb, sl - last_len, 0)
        elo = torch.where(rb, last_lo, lo)
        ehi = torch.where(rb, last_hi, hi)
        sl = torch.where(rb, last_len, sl)
        room = idx & (sl >= min_len) & (n_seeds < S)
        sel = room[:, None] & (slot_cols == n_seeds[:, None])
        vals = (lens - i, sl, elo, torch.clamp_max(ehi - elo, params.sa_size_threshold + 1))
        for q, v in enumerate(vals):
            out[q] = torch.where(sel, v[:, None], out[q])
        n_seeds = n_seeds + room.to(i64)
        mid = idx & ~end
        i = torch.where(mid, i - (diff + torch.clamp_max(sl, min_len) - 1), i)
        lo = torch.where(mid, 0, lo)
        hi = torch.where(mid, n_rows, hi)
        seed_len = torch.where(mid, 0, torch.where(idx & end, sl, seed_len))
        last_lo = torch.where(mid, 0, last_lo)
        last_hi = torch.where(mid, n_rows, last_hi)
        last_len = torch.where(mid, 0, last_len)

    iterations = n_fresh = n_ext = 0
    if stats is not None:
        seen_rows = torch.zeros(rows_u.shape[0], dtype=torch.bool, device=dev)
        seen_keys = torch.zeros(4**k if k else 1, dtype=torch.bool, device=dev)
    for _ in range(limit):
        if not bool(active.any()):
            break
        iterations += 1
        if charge_limit is not None:
            active = active & ((steps < charge_limit) | (i >= lens))
        if params.kill_ratio > 0:
            # float32, two roundings, as the JAX walk computes it
            bound = kill_f * i.to(torch.float32) + base_f
            active = active & ~(steps.to(torch.float32) > bound)
        if sibling:
            newly = (sib < 0) & ((steps >= T0) | ~active)
            probe = seed_len >= params.good_seed_len
            victim = active & (n_seeds == 0) & (last_len == 0) & (seed_len < min_len)
            sib = torch.where(newly, probe.to(i64) | (victim.to(i64) << 1), sib)
            other = torch.roll(sib, Wn // 2)
            mine = active & (sib >= 0) & (((sib >> 1) & 1) == 1)
            kill = mine & (other >= 0) & ((other & 1) == 1)
            pause = mine & (other < 0)
            active = active & ~kill
        else:
            pause = torch.zeros_like(active)
        act0 = active
        fresh = act0 & (seed_len == 0) & ~pause
        ext = act0 & (seed_len != 0) & ~pause
        die = fresh & ((lens - i) < min_len)
        fresh = fresh & ~die
        done = ext & (i >= lens)
        ext = ext & ~done
        steps = steps + (act0 & ~pause).to(i64)
        if stats is not None:
            n_fresh += int(fresh.sum())
            n_ext += int(ext.sum())
            seen_rows[_occ_block(primary, lo[ext])] = True
            seen_rows[_occ_block(primary, hi[ext])] = True

        jj = (lens - 1 - i).clamp(0, L - 1)
        c = torch.gather(seq, 1, jj[:, None])[:, 0]
        cc = counts[c]
        nlo = cc + _occ_full(rows_u, primary, lo, c)
        nhi = cc + _occ_full(rows_u, primary, hi, c)
        if k:
            j0 = (lens - i - k).clamp(0, L - 1)
            key = torch.gather(km, 1, j0[:, None])[:, 0]
            f_lo, f_hi = lut_lo[key], lut_hi[key]
            if stats is not None:
                seen_keys[key[fresh]] = True
        else:
            f_lo, f_hi = cc, counts[c + 1]
        nlo = torch.where(fresh, f_lo, nlo)
        nhi = torch.where(fresh, f_hi, nhi)
        ok = nlo < nhi
        # CHECK_AND_SET_LAST: the state before a narrowing step
        upd = ext & ok & (seed_len >= min_len) & ((nhi - nlo) < (hi - lo))
        last_lo = torch.where(upd, lo, last_lo)
        last_hi = torch.where(upd, hi, last_hi)
        last_len = torch.where(upd, seed_len, last_len)
        stepping = (fresh | ext) & ok
        jump = k if k else 1
        lo = torch.where(stepping, nlo, lo)
        hi = torch.where(stepping, nhi, hi)
        seed_len = torch.where(stepping, torch.where(fresh, jump, seed_len + 1), seed_len)
        i = torch.where(stepping, i + torch.where(fresh, jump, 1), i)
        active = act0 & ~die & ~done
        i = torch.where(fresh & ~ok, i + 1, i)  # empty bucket: net +1
        emit(done | (ext & ~ok), done)
        # a walker whose slots are full can store nothing more
        active = active & (n_seeds < S)

    # walkers that ran out of iterations with a live seed at the end
    live = active & (seed_len > 0) & (i >= lens)
    emit(live, live)
    if stats is not None:
        stats.update(iterations=iterations, fresh_steps=n_fresh, ext_steps=n_ext,
                     occ_rows=int(seen_rows.sum()),
                     lut_keys=int(seen_keys.sum()) if k else 0)
    o = out.to(torch.int32)
    return DeviceSeeds(o[0], o[1], o[2], o[3], n_seeds.to(torch.int32))


def mmp_seed_device(
    dfm: DeviceFM,
    walkers: torch.Tensor,
    lens: torch.Tensor,
    params: MmpParams,
    max_seeds: int = 16,
    max_steps: Optional[int] = None,
    charge_limit: Optional[int] = None,
) -> DeviceSeeds:
    """The seed walk by the tensors' device: the plain version on the
    CPU, the CUDA kernel on a card (no fallback)."""
    if walkers.device.type == "cpu":
        return mmp_seed_device_plain(
            dfm, walkers, lens, params, max_seeds, max_steps, charge_limit
        )
    if walkers.device.type == "cuda":
        from megapath_tpu_torch.ops.seed_cuda import mmp_seed_cuda

        return mmp_seed_cuda(
            dfm, walkers, lens, params, max_seeds, max_steps, charge_limit
        )
    raise ValueError(f"no seed walk for tensors on {walkers.device}")


def locate_device_plain(
    dfm: DeviceFM, rows: torch.Tensor, stats: Optional[dict] = None
) -> torch.Tensor:
    """Text positions (int32) of full-BWT rows by LF walk to a sampled
    row, at most sa_interval + 1 steps, in plain torch
    (``seeding_jax.device_locate``); -1 where no mark was reached. It reads
    the marks from ``mark_rows`` at every step, as the reference does, and
    not from the occ rows' mark words. A ``stats`` dict receives the
    counts of mark lookups and LF steps taken, the most LF steps a row
    took (``longest``), and what the walk needs to read, each table entry
    once: the distinct blocks whose mark bits a row other than ``primary``
    is tested in (``mark_words``, 16 bytes), the distinct blocks an LF
    step ranks in (``occ_rows``, 48 bytes: checkpoints and BWT words) and
    the distinct mark rows at the marks reached (``mark_rows``, 8 bytes:
    the rank there)."""
    i64 = torch.int64
    r = rows.to(i64)
    rows_u = _u32(dfm.rows)
    marks = _u32(dfm.mark_rows)
    counts = dfm.counts.to(i64)
    sampled = dfm.sa_sampled.to(i64)
    pos = torch.full_like(r, -1)
    steps = torch.zeros_like(r)
    n_marks = n_lf = 0
    if stats is not None:
        seen_marks = torch.zeros(marks.shape[0], dtype=torch.bool, device=r.device)
        seen_rows = torch.zeros(rows_u.shape[0], dtype=torch.bool, device=r.device)
        seen_words = torch.zeros(rows_u.shape[0], dtype=torch.bool, device=r.device)
    for _ in range(dfm.sa_interval + 1):
        adj = r - (r > dfm.primary).to(i64)
        if stats is not None:
            n_marks += int((pos < 0).sum())
            seen_words[(adj >> 7)[(pos < 0) & (r != dfm.primary)]] = True
        mk = marks[r >> 5]
        bit = r & 31
        hit = (pos < 0) & (((mk[:, 0] >> bit) & 1) == 1)
        if stats is not None:
            seen_marks[(r >> 5)[hit]] = True
        rank = mk[:, 1] + _popcount(mk[:, 0] & _low_bits(bit))
        rank = rank.clamp(0, max(len(sampled) - 1, 0))
        if len(sampled):
            pos = torch.where(hit, sampled[rank] + steps, pos)
        todo = pos < 0
        # LF step: the row's BWT char and its rank from one occ row
        blk = rows_u[adj >> 7]
        rel = adj & (OCC_BLOCK - 1)
        w = torch.gather(blk, 1, (4 + (rel >> 4))[:, None])[:, 0]
        c = (w >> (2 * (rel & 15))) & 3
        lf = counts[c] + _occ_in_rows(blk, rel, c)
        lf = torch.where(r == dfm.primary, 0, lf)
        if stats is not None:
            n_lf += int(todo.sum())
            seen_rows[(adj >> 7)[todo]] = True
        r = torch.where(todo, lf, r)
        steps = steps + todo.to(i64)
    if stats is not None:
        stats.update(mark_lookups=n_marks, lf_steps=n_lf,
                     longest=int(steps.max()) if len(steps) else 0,
                     mark_rows=int(seen_marks.sum()), occ_rows=int(seen_rows.sum()),
                     mark_words=int(seen_words.sum()))
    return pos.to(torch.int32)


def locate_device(dfm: DeviceFM, rows: torch.Tensor) -> torch.Tensor:
    """The locate by the tensors' device: the plain version on the CPU,
    the CUDA kernel on a card (no fallback)."""
    if rows.device.type == "cpu":
        return locate_device_plain(dfm, rows)
    if rows.device.type == "cuda":
        from megapath_tpu_torch.ops.seed_cuda import locate_cuda

        return locate_cuda(dfm, rows)
    raise ValueError(f"no locate for tensors on {rows.device}")


def flatten_seeds(seeds: DeviceSeeds) -> FlatSeeds:
    """The valid slots of (W, S) seed buffers in row-major order, as
    ``seeding_jax.flatten_seeds`` orders them, sized by the counts (one
    sync)."""
    S = seeds.offset.shape[1]
    cols = torch.arange(S, device=seeds.offset.device)[None, :]
    ws, js = torch.nonzero(cols < seeds.n_seeds[:, None], as_tuple=True)
    return FlatSeeds(
        ws.to(torch.int32), seeds.offset[ws, js], seeds.length[ws, js],
        seeds.sa_lo[ws, js], seeds.sa_count[ws, js],
    )


def expand_rows(sa_lo: torch.Tensor, sa_count: torch.Tensor) -> torch.Tensor:
    """Every SA row of every flat seed, seed by seed (int32), the order
    ``decode_seeds`` expands them in (one sync for the total)."""
    cnt = sa_count.to(torch.int64)
    tot = int(cnt.sum())
    dev = cnt.device
    idx = torch.repeat_interleave(
        torch.arange(len(cnt), device=dev), cnt, output_size=tot
    )
    start = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(tot, device=dev) - start[idx]
    return (sa_lo.to(torch.int64)[idx] + within).to(torch.int32)


def device_seed_pipeline_loc(
    dfm: DeviceFM,
    reads: torch.Tensor,  # uint8 [N, L] forward reads (both ends stacked)
    lens: torch.Tensor,  # int32 [N]
    params: MmpParams,
    max_seeds: int,
    max_steps: int,
    charge_limit: Optional[int] = None,
) -> Tuple[FlatSeeds, torch.Tensor, torch.Tensor]:
    """The whole seeding leg on the device (``seeding_jax.py:982-1027``):
    build [reads; revcomp] walkers, walk, flatten, expand every seed's SA
    rows and locate them. Returns (flat seeds, text positions int32 per
    expanded row, the walker matrix), all on the device; the walker
    matrix stays there for the DP's candidate gather."""
    walkers, wlens = build_walkers(reads, lens)
    seeds = mmp_seed_device(
        dfm, walkers, wlens, params, max_seeds, max_steps, charge_limit
    )
    flat = flatten_seeds(seeds)
    rows = expand_rows(flat.sa_lo, flat.sa_count)
    pos = (
        locate_device(dfm, rows) if len(rows)
        else torch.zeros(0, dtype=torch.int32, device=rows.device)
    )
    return flat, pos, walkers


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort``: the last key sorts first, ties keep index order."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _segment(op: str, vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max/min/sum`` over ``n`` segments: an empty
    segment holds the operation's identity (int32 min / max, 0)."""
    init = {"amax": I32_MIN, "amin": I32_MAX, "sum": 0}[op]
    out = torch.full((n,), init, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, seg, vals.to(torch.int64), op)


def _first_of_runs(*cols: torch.Tensor) -> torch.Tensor:
    """True at row 0 and wherever any column differs from the row before."""
    dev = cols[0].device
    later = torch.zeros(cols[0].shape[0] - 1, dtype=torch.bool, device=dev)
    for c in cols:
        later |= c[1:] != c[:-1]
    return torch.cat([torch.ones(1, dtype=torch.bool, device=dev), later])


def _seg_search(arr, seg, lo, hi, target, strict: bool) -> torch.Tensor:
    """The first j in [lo, hi) with arr[j] > target (``strict``) or
    arr[j] >= target, else hi; lo where lo >= hi. ``arr`` ascends within
    each run of equal ``seg`` (non-decreasing), and each window lies in
    one run: the search is over (seg, arr) keys."""
    n = arr.shape[0]
    key = (seg << _KEY_SHIFT) + (arr + _KEY_BIAS)
    tseg = seg[lo.clamp(0, n - 1)]
    g = torch.searchsorted(key, (tseg << _KEY_SHIFT) + (target + _KEY_BIAS), right=strict)
    return torch.where(lo >= hi, lo, torch.minimum(torch.maximum(g, lo), hi))


def _chain_anchors(first, nxt, seg_end, valid) -> torch.Tensor:
    """The rows the anchor chains reach: from each valid segment start,
    jump to ``nxt`` while it lies before the segment's end and is valid.
    The reference loops until no chain moves; here the jump table doubles
    each round, so ceil(log2(P + 1)) rounds reach every chain's end."""
    P = first.shape[0]
    sink = torch.full((1,), P, dtype=torch.int64, device=first.device)
    to = torch.where(valid & (nxt < seg_end), nxt, P)
    to = torch.where(valid[to.clamp(max=P - 1)] & (to < P), to, P)
    jump = torch.cat([to, sink])
    not_sink = torch.arange(P + 1, device=first.device) < P
    reached = torch.cat([first & valid, torch.zeros(1, dtype=torch.bool, device=first.device)])
    for _ in range(max(P, 1).bit_length()):
        hop = torch.zeros(P + 1, dtype=torch.bool, device=first.device)
        hop.index_fill_(0, torch.where(reached, jump, P), True)
        reached = (reached | hop) & not_sink
        jump = jump[jump]
    return reached[:P]


def decode_seeds_device(
    flat: FlatSeeds,
    pos: torch.Tensor,  # int32 [R] text position of every expanded SA row
    lens: torch.Tensor,  # per-read lengths (at least n_reads of them)
    n_reads: int,
    nb: int,
    params: MmpParams,
) -> Tuple[SeedPositions, torch.Tensor]:
    """``seeding.decode_seeds`` on the seeds' device: the output of
    ``device_seed_pipeline_loc`` over ``nb`` padded reads, of which the
    first ``n_reads`` are real, clustered and filtered where it lies, and
    only the kept clusters read back (one pull). The result equals
    ``decode_seeds`` on the same seeds and positions field for field, in
    its order and dtypes: the walker ids remapped as the host path maps
    them (walker rows nb.. become n_reads..), (walker, start) sorted
    stably as ``np.lexsort``, anchor chains of ``indel_fuzz`` marked by
    pointer doubling, and the coverage test in float64 as numpy computes
    it. Every size is exact, taken from the seeds and positions.

    Returns the host ``SeedPositions`` and the same kept clusters as they
    lie on the device, int64 [4, K] rows (read, strand, pos, coverage),
    for the pairing of the same pass (``pairing_dev``)."""
    R = pos.shape[0]
    dev = pos.device
    if len(flat.walker) == 0 or R == 0:
        z = np.zeros(0)
        return SeedPositions(
            z.astype(np.int32), z.astype(np.int8), z.astype(np.int64), z.astype(np.int32)
        ), torch.zeros((4, 0), dtype=torch.int64, device=dev)
    i64 = torch.int64
    cnt = flat.sa_count.to(i64)
    sidx = torch.repeat_interleave(
        torch.arange(len(cnt), device=dev), cnt, output_size=R
    )
    ws = flat.walker.to(i64)
    # pad walkers (length 0) never seed; walker rows nb..nb+n_reads-1, the
    # reverse complements, become walker ids n_reads..2 n_reads-1
    ws = torch.where(ws >= nb, ws - (nb - n_reads), ws)
    walker = ws[sidx]
    offset = flat.offset.to(i64)[sidx]
    length = flat.length.to(i64)[sidx]
    start = pos.to(i64) - offset
    rlen = lens.to(i64)[walker % n_reads]
    unique = (length >= params.good_seed_len) | (length >= rlen // 2)
    mult = torch.where(unique, 1, cnt[sidx])

    # clusters: the anchor chains of each walker's rows in start order
    order = _lexsort((start, walker))
    walker_s = walker[order]
    start_s = start[order]
    off_s = offset[order]
    len_s = length[order]
    iota = torch.arange(R, dtype=i64, device=dev)
    first = _first_of_runs(walker_s)
    seg_id = torch.cumsum(first.to(i64), 0) - 1
    seg_end = _segment("amax", iota + 1, seg_id, R)[seg_id]
    # nxt[i] = the first row of the walker's run with start > start + fuzz
    nxt = _seg_search(start_s, seg_id, iota, seg_end, start_s + params.indel_fuzz,
                      strict=True)
    every = torch.ones(R, dtype=torch.bool, device=dev)
    cid = torch.cumsum(_chain_anchors(first, nxt, seg_end, every).to(i64), 0) - 1

    # merged coverage: the union of each cluster's [off, off + len),
    # members in (cluster, off) order, a running max of the ends
    o2 = _lexsort((off_s, cid))
    cid2 = cid[o2]
    s2 = off_s[o2]
    e2 = (off_s + len_s)[o2]
    base = cid2 << 33
    run_max = torch.cummax(base + e2, 0).values - base
    prev = torch.where(_first_of_runs(cid2), 0, torch.cat([e2[:1], run_max[:-1]]))
    cov = _segment("sum", torch.clamp_min(e2 - torch.maximum(s2, prev), 0), cid2, R)

    uniq = (mult[order] <= params.uniq_threshold) & (len_s >= params.seed_min_length)
    has_unique = _segment("amax", uniq, cid, R) > 0
    cl_valid = iota <= cid[-1]
    cl_walker = _segment("amin", walker_s, cid, R)
    cl_pos = _segment("amin", start_s, cid, R)
    cl_read = torch.where(cl_valid, cl_walker % n_reads, 0)
    # the best coverage of each read over all its clusters, both strands
    best = _segment("amax", torch.where(cl_valid, cov, 0), cl_read, n_reads)
    keep = cl_valid & (has_unique | (cov >= params.good_seed_len)) & (
        cov.to(torch.float64)
        >= params.short_seed_ratio * best[cl_read].to(torch.float64)
    )
    idx = torch.nonzero(keep).squeeze(1)
    kept = torch.stack(
        (cl_read[idx], (cl_walker[idx] >= n_reads).to(i64), cl_pos[idx], cov[idx])
    )
    read, strand, cpos, ccov = kept.cpu().numpy()
    mod = sys.modules[__name__]
    _build.count(mod, "decode_rows_device", R)
    _build.count(mod, "decode_kept_device", len(read))
    return SeedPositions(
        read=read.astype(np.int32),
        strand=strand.astype(np.int8),
        pos=cpos,
        coverage=ccov.astype(np.int32),
    ), kept
