"""The full alignment engine run on the device, once for each (data,
shard) cell of a grid of torch devices.

Port of ``megapath_tpu/parallel/spmd_full.py``. The reference runs the
engine as one ``shard_map`` program over a (data x shard) mesh; here the
mesh is a grid of torch devices in one process (``Mesh``) and the step is
a Python loop over its cells that enqueues every cell's work before the
first read-back. No cell talks to another: cell (d, s) aligns data block d
against shard s, and the host gathers the [D, S, H] hit tables
(``SpmdHits``). A cell computes the rows ``AlignEngine.align_pairs``
computes for its block, in the reference step's order. Its stages:

  1. the MMP walk over [r1; r2; rc r1; rc r2] (``seeding_dev``: the
     ``mmp_seed`` kernel on a card), one-phase and unstaged as the port's
     engine walks (DV-DPfunctions.cpp:2404-2615)
  2. every SA row of every seed located (the ``locate`` kernel), up to
     sa_size_threshold + 1 rows a seed (:2475-2487)
  3. fuzz clustering with the unique and coverage filter (:2488-2552)
  4. divide-gap compression and the insert-window join in both
     orientations (``align.pairing``, :1968-2119), compacted to
     ``dp_factor * Bl`` candidates
  5. the two-leg deep DP with normalizeScore (:2790-3540,
     BGS-IO.cpp:1949-1964), each leg a forward DP and a forward DP over
     the reversed prefixes (``ops.dp.sw_align_auto``: the ``dp_fwd`` kernel
     on a card)
  6. single-end DP (200 a read end) and mate rescue, the rescue compacted
     to ``rescue_factor * Bl`` rows (DV-DPForSingleReads.cpp, DV-SemiDP.cpp)
  7. the hit table compacted to ``hit_factor * Bl`` rows

Every shape is fixed by the block's pair count Bl and the caps
(``SpmdCaps``), so no tensor is sized from a read-back; a cap that is too
small sets the cell's overflow flag and ``spmd_hits_to_batch`` raises. The
anchor chains are marked by pointer doubling (a fixed number of rounds) in
place of the reference's data-dependent loop.

What the reference needed for one ``shard_map`` shape has no role here:
the shard tables are per-shard tensors on their devices, not stacked and
leaf-padded (``stack_fms_exact``, ``StackedFMPad``, ``pad_ref_codes``,
``pad_seq_offsets``, ``pack_ref_rows``); each shard goes to each device
of its column once (``place_spmd_full_inputs``). ``fm_meta`` keeps
``stack_fms_exact``'s refusal of shards built with different parameters.
The reference's int32-only segmented binary search (``_seg_search``) is a
``torch.searchsorted`` over int64 (segment, value) keys. The sort and
segment helpers of stage 3 live in ``align.seeding_dev``, whose device
decode of the engine's seeds shares them. The staged walk
and its plans (``staged_walk``, ``plan_fast``) and the probe-only
``stage_stop`` are not ported; ``StageEvents`` times the stages instead.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from megapath_tpu_torch.align.device import gather_windows_packed, pack_ref_words
from megapath_tpu_torch.align.engine import BatchHits
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align.seeding_dev import (
    I32_MAX,
    DeviceFM,
    HostFM,
    _chain_anchors,
    _first_of_runs,
    _lexsort,
    _seg_search,
    _segment,
    build_walkers,
    locate_device,
    mmp_seed_device,
)
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import PackedReference
from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp import OFF_TEXT_CODE, DPParams, sw_align_auto
from megapath_tpu_torch.utils.timing import span

# over every call (counted through ``_build.count``): the SA rows the steps
# located and the real pairs of their batches, the level that served each
# batch only (``MegaPathPipeline._align_shards_spmd``); the host
# milliseconds ``place_spmd_full_inputs`` spent packing the shards' tables
# and putting them on their devices
step_rows = 0
step_pairs = 0
pack_ms = 0.0
upload_ms = 0.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def float32_floor(ratio: float, values: torch.Tensor) -> torch.Tensor:
    """int(ratio * values) with the product wholly in float32 (both
    operands rounded to float32, the product too), as the reference's
    programs compute their thresholds; int64. A float64 product of the
    float32 ratio differs at some values (0.95 times a multiple of 20)."""
    prod = torch.tensor(ratio, dtype=torch.float32) * values.to(torch.float32)
    return prod.to(torch.int32).to(torch.int64)


class FMMetaPad(NamedTuple):
    """The build parameters every shard of a grid shares. Each comes from
    the shards' tables (``fm_meta``); none has a default."""

    lut_k: int
    sa_interval: int


def fm_meta(fms: Sequence) -> FMMetaPad:
    """The shared build parameters of the shards' indexes (``FMIndex``,
    ``HostFM`` or ``DeviceFM``); shards built with different ones are
    refused, as the reference refuses them."""
    metas = {(int(fm.lut_k), int(fm.sa_interval)) for fm in fms}
    if len(metas) != 1:
        raise ValueError(f"shard FM build parameters differ: {sorted(metas)}")
    lut_k, sa_interval = metas.pop()
    return FMMetaPad(lut_k=lut_k, sa_interval=sa_interval)


def _check_meta(meta: FMMetaPad, fm, what: str) -> None:
    got = FMMetaPad(lut_k=int(fm.lut_k), sa_interval=int(fm.sa_interval))
    if got != meta:
        raise ValueError(f"{what}: tables built with {got}, the engine's meta is {meta}")


class SpmdCaps(NamedTuple):
    """Static shape caps, as multiples of the block's pair count Bl
    (fractions allowed; rows round up to a 1024 grain)."""

    pos_factor: float = 16  # located SA positions a block
    cand_factor: float = 8  # paired candidates an orientation
    se_factor: float = 4  # single-end DP rows
    hit_factor: float = 6  # compacted output hit rows
    dp_factor: float = 4  # compacted deep-DP candidates (both orientations)
    rescue_factor: float = 2  # compacted mate-rescue rows (passing anchors)


# The caps the pipeline tries first (the reference's measured occupancy on
# matching-heavy batches); an overflow escalates to the defaults.
LEAN_CAPS = SpmdCaps(
    pos_factor=8, cand_factor=4, se_factor=0.5, hit_factor=4,
    dp_factor=1.25, rescue_factor=0.25,
)


def _capn(factor: float, Bl: int) -> int:
    """factor * Bl rounded up to the 1024 grain (>= 1024)."""
    return max(1024, ((int(factor * Bl) + 1023) // 1024) * 1024)


class SpmdHits(NamedTuple):
    """The host's gather of a step: [D, S, H] numpy fields, the columns of
    ``BatchHits`` and ``valid``, valid rows packed to the front of each
    cell's H in their assembly order; ``overflow`` [D, S] (0 = ok)."""

    valid: np.ndarray  # bool
    read: np.ndarray  # int32 pair index within the data block
    end: np.ndarray
    seq: np.ndarray
    score: np.ndarray
    raw_score: np.ndarray
    start: np.ndarray  # shard-text coordinates
    stop: np.ndarray
    strand: np.ndarray
    paired: np.ndarray  # bool
    overflow: np.ndarray  # int32


class Mesh(NamedTuple):
    """A (data, shard) grid of torch devices in one process; a device may
    stand in several cells."""

    devices: Tuple[Tuple[torch.device, ...], ...]  # [data][shard]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "shard": len(self.devices[0])}


def grid_devices(device: torch.device, devices: Optional[Sequence] = None) -> list:
    """The devices of a grid: ``devices`` when given, else every device of
    ``device``'s type (every visible card on ``cuda``, the one CPU)."""
    if devices:
        return [torch.device(d) for d in devices]
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(devices: Sequence, n_shards: int) -> Mesh:
    """The reference's grid: the first rows * S devices, row-major, rows =
    len(devices) // S."""
    devs = [torch.device(d) for d in devices]
    rows = len(devs) // n_shards if n_shards else 0
    if rows == 0:
        raise ValueError(
            f"spmd backend needs >= {n_shards} devices for {n_shards} shards "
            f"(got {len(devs)}); use the host path or fewer shards"
        )
    return Mesh(tuple(
        tuple(devs[d * n_shards + s] for s in range(n_shards)) for d in range(rows)
    ))


class ShardTables(NamedTuple):
    """One shard's step inputs on one device."""

    dfm: DeviceFM
    ref_words: torch.Tensor  # int32 packed text (uint32 bits)
    n_text: int
    seq_off: torch.Tensor  # int64 [M + 1] sequence starts, then the text length


class SpmdInputs(NamedTuple):
    """Every cell's shard inputs ([D][S]: ``ShardTables`` here, the
    reduced steps' own in ``spmd`` and ``dist``); the cells of a column
    that share a device share one placement. ``placed`` holds each
    placement once, keyed by (shard, device)."""

    cells: Tuple[Tuple[object, ...], ...]
    placed: Dict[Tuple[int, str], object]


def place_columns(mesh: Mesh, put: Callable[[int, torch.device], object]) -> SpmdInputs:
    """``put(s, device)`` once for each shard s and each distinct device of
    its column; every cell of the column on that device shares the result."""
    S = mesh.shape["shard"]
    placed: Dict[Tuple[int, str], object] = {}
    for s in range(S):
        for row in mesh.devices:
            if (s, str(row[s])) not in placed:
                placed[(s, str(row[s]))] = put(s, row[s])
    cells = tuple(
        tuple(placed[(s, str(row[s]))] for s in range(S)) for row in mesh.devices
    )
    return SpmdInputs(cells=cells, placed=placed)


def run_cells(mesh: Mesh, cells, arrays: Sequence[torch.Tensor], fn) -> List[List[np.ndarray]]:
    """Enqueue ``fn(s, cell, *block)`` for every cell, data row by data row:
    ``block`` is row d's slice of each of ``arrays`` (host tensors whose
    first axis splits into the grid's D rows), put on each distinct device
    of the row once. Then each device's outputs (tensors of one shape) are
    read back at once. Returns the [D][S] outputs as numpy. Spans:
    ``nt.step.upload`` (a block's copies), ``nt.step.enqueue`` (a cell's
    ``fn``), ``nt.step.readback`` (where the host waits for the devices)."""
    D = mesh.shape["data"]
    Bl = arrays[0].shape[0] // D
    outs: Dict[str, List[Tuple[int, int, torch.Tensor]]] = {}
    for d, row in enumerate(mesh.devices):
        blk = slice(d * Bl, (d + 1) * Bl)
        uploaded: Dict[str, tuple] = {}
        for s, dev in enumerate(row):
            key = str(dev)
            if key not in uploaded:
                with span("nt.step.upload"):
                    uploaded[key] = tuple(a[blk].to(dev, non_blocking=True) for a in arrays)
            with span("nt.step.enqueue"):
                outs.setdefault(key, []).append((d, s, fn(s, cells[d][s], *uploaded[key])))
    got: List[List[np.ndarray]] = [[None] * len(row) for row in mesh.devices]
    with span("nt.step.readback"):
        for lst in outs.values():
            for (d, s, _), a in zip(lst, torch.stack([o for _, _, o in lst]).cpu().numpy()):
                got[d][s] = a
    return got


def place_spmd_full_inputs(
    mesh: Mesh, meta: FMMetaPad,
    shards: Sequence[Tuple[PackedReference, FMIndex]],
) -> SpmdInputs:
    """Pack each shard's tables on the host once and put them on each
    distinct device of its column once, so that a step ships only the
    reads. Spans ``nt.pack`` and ``nt.upload``; their host times add to
    the counters ``pack_ms`` and ``upload_ms`` (the upload's up to a
    synchronise of the cards)."""
    S = mesh.shape["shard"]
    if len(shards) != S:
        raise ValueError(f"{len(shards)} shards for a grid of {S} shard columns")
    mod = sys.modules[__name__]
    t = time.perf_counter()
    hosts = []
    with span("nt.pack"):
        for s, (ref, fm) in enumerate(shards):
            host = HostFM.pack(fm)
            _check_meta(meta, host, f"shard {s}")
            hosts.append((host, pack_ref_words(ref.codes).view(np.int32),
                          np.asarray(ref.offsets, np.int64), len(ref.codes)))
    _build.count(mod, "pack_ms", 1e3 * (time.perf_counter() - t))

    def put(s: int, dev: torch.device) -> ShardTables:
        host, words, offs, n_text = hosts[s]
        return ShardTables(dfm=host.upload(dev), ref_words=torch.from_numpy(words).to(dev),
                           n_text=n_text, seq_off=torch.from_numpy(offs).to(dev))

    t = time.perf_counter()
    with span("nt.upload"):
        inputs = place_columns(mesh, put)
        for dev in {d for row in mesh.devices for d in row if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
    _build.count(mod, "upload_ms", 1e3 * (time.perf_counter() - t))
    return inputs


class StageEvents:
    """The time of each stage of a step, summed over its cells: a CUDA
    event at each stage boundary on the cell's device (the host clock on
    the CPU). ``seconds()`` waits for the events."""

    def __init__(self):
        self._cells: List[List[Tuple[str, object]]] = []

    def cell(self, device: torch.device) -> Callable[[str], None]:
        """A marker for one cell: ``mark(name)`` ends stage ``name``."""
        marks: List[Tuple[str, object]] = []
        self._cells.append(marks)

        def mark(name: str) -> None:
            if device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(device))
                marks.append((name, ev))
            else:
                marks.append((name, time.perf_counter()))

        mark("start")
        return mark

    def seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for marks in self._cells:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                if isinstance(a, float):
                    dt = b - a
                else:
                    b.synchronize()
                    dt = a.elapsed_time(b) / 1e3
                out[name] = out.get(name, 0.0) + dt
        return out


def _full_dp(reads, wins, lens, wl, width: int, L: int, dp: DPParams):
    """Forward DP, then the forward DP over the reversed prefixes (its end
    is the distance back to the start): (score, start, end) in the window,
    int64."""
    dev = reads.device
    wl = wl.clamp(0, width).to(torch.int32)
    fwd = sw_align_auto(reads, wins, lens.to(torch.int32), wl, params=dp)
    jj = torch.arange(L, device=dev)[None, :]
    rsrc = fwd.end_read.to(torch.int64)[:, None] - 1 - jj
    rev_reads = torch.where(
        rsrc >= 0, torch.gather(reads, 1, rsrc.clamp(0, L - 1)), 0
    ).to(torch.uint8)
    ii = torch.arange(width, device=dev)[None, :]
    wsrc = fwd.end_ref.to(torch.int64)[:, None] - 1 - ii
    rev_wins = torch.where(
        wsrc >= 0, torch.gather(wins, 1, wsrc.clamp(0, width - 1)), OFF_TEXT_CODE
    ).to(torch.uint8)
    rev = sw_align_auto(rev_reads, rev_wins, fwd.end_read, fwd.end_ref, params=dp)
    end = fwd.end_ref.to(torch.int64)
    return fwd.score.to(torch.int64), end - rev.end_ref.to(torch.int64), end


N_OUT = 10  # valid, read, end, seq, score, raw_score, start, stop, strand, paired


def build_spmd_full_engine(
    mesh: Mesh,
    meta: FMMetaPad,
    read_len: int,
    params: AlignParams = AlignParams(),
    caps: SpmdCaps = SpmdCaps(),
):
    """The step over the grid: ``step(inputs, reads1, reads2, lens1,
    lens2, timer=None) -> SpmdHits``. ``inputs`` from
    ``place_spmd_full_inputs``; reads uint8 [B, L] and lengths [B] (numpy
    or CPU tensors) with B = D * Bl, block d = rows d * Bl .. (d+1) * Bl - 1.
    The step refuses shard tables that disagree with ``meta``. ``timer``,
    a ``StageEvents``, records each cell's stages; ``located``, a list,
    gets the [D, S] SA rows each cell located (int64, before any cap)
    appended, read back with the tables."""
    L = read_len
    if len(params.seeding_rounds) != 1:
        raise NotImplementedError("spmd_full supports single-round seeding")
    mmp = params.mmp
    max_seeds = int(min(16, max(4, L // 16 + 2)))
    chg = 3 * L + 64
    dp = DPParams(params.match, params.mismatch, params.gap_open, params.gap_extend)
    Wwin = _round_up(L + 2 * 30 + 2, 64)
    Wse = _round_up(L + 62, 64)
    Wrescue = _round_up(int(params.insert_high) + L + 62, 128)
    insert_high = int(params.insert_high)
    short_f = torch.tensor(mmp.short_seed_ratio, dtype=torch.float32)
    i64 = torch.int64

    def thr_of(lens):
        return float32_floor(params.cutoff_ratio, lens).clamp_min(params.cutoff_lower_bound)

    def local_step(cell: ShardTables, reads1, reads2, lens1, lens2, mark):
        dfm = cell.dfm
        dev = reads1.device
        Bl = reads1.shape[0]
        n2 = 2 * Bl
        lens1i = lens1.to(i64)
        lens2i = lens2.to(i64)
        P_cap = _capn(caps.pos_factor, Bl)
        C_cap = _capn(caps.cand_factor, Bl)
        SE_cap = _capn(caps.se_factor, Bl)
        flags: List[torch.Tensor] = []
        ar = lambda n: torch.arange(n, dtype=i64, device=dev)  # noqa: E731

        # ---- 1. seeding over [r1; r2; rc r1; rc r2] ------------------
        allr = torch.cat([reads1, reads2])
        all_lens = torch.cat([lens1, lens2]).to(torch.int32)
        walkers, wlens = build_walkers(allr, all_lens)  # [4Bl, L]
        seeds = mmp_seed_device(dfm, walkers, wlens, mmp, max_seeds, chg, chg)
        mark("walk")

        # ---- 2. multi SA-locate (up to sa_size_threshold + 1 a seed) --
        sv = ar(max_seeds)[None, :] < seeds.n_seeds.to(i64)[:, None]
        cnt = torch.where(sv, seeds.sa_count.to(i64), 0).reshape(-1)
        cum = torch.cumsum(cnt, 0)
        total = cum[-1]
        flags.append(total > P_cap)
        j = ar(P_cap)
        sidx = torch.searchsorted(cum, j, right=True).clamp(0, cnt.shape[0] - 1)
        pvalid = j < total
        within = j - (cum[sidx] - cnt[sidx])
        rows = torch.where(pvalid, seeds.sa_lo.reshape(-1).to(i64)[sidx] + within, 0)
        pos = locate_device(dfm, rows.to(torch.int32)).to(i64)
        mark("locate")
        walker = sidx // max_seeds
        s_off = seeds.offset.reshape(-1).to(i64)[sidx]
        s_len = seeds.length.reshape(-1).to(i64)[sidx]
        s_cnt = cnt[sidx]
        start = pos - s_off
        rlen = wlens.to(i64)[walker]
        unique = (s_len >= mmp.good_seed_len) | (s_len >= rlen // 2)
        mult = torch.where(unique, 1, s_cnt)

        # ---- 3. fuzz clustering + unique/coverage filter -------------
        # sort by (valid desc, walker, start); pads land at the end
        order = _lexsort((start, walker, ~pvalid))
        valid_s = pvalid[order]
        walker_s = torch.where(valid_s, walker[order], 1 << 24)
        start_s = start[order]
        off_s = s_off[order]
        len_s = s_len[order]
        mult_s = mult[order]
        iota = ar(P_cap)
        first = _first_of_runs(walker_s)
        seg_id = torch.cumsum(first.to(i64), 0) - 1
        seg_end = _segment("amax", iota + 1, seg_id, P_cap)[seg_id]
        # nxt[i] = first j in the walker's run with start > start + fuzz
        nxt = _seg_search(torch.where(valid_s, start_s, 0), seg_id, iota, seg_end,
                          start_s + mmp.indel_fuzz, strict=True)
        anchor = _chain_anchors(first, nxt, seg_end, valid_s) | ~valid_s
        cid = torch.cumsum(anchor.to(i64), 0) - 1

        # merged coverage of each cluster: the union of its [off, off +
        # len) intervals, members in (cluster, off) order (decode_seeds)
        o2 = _lexsort((off_s, cid))
        cid2 = cid[o2]
        s2 = off_s[o2]
        e2 = torch.where(valid_s[o2], (off_s + len_s)[o2], s2)
        first2 = _first_of_runs(cid2)
        # running max within each cluster: one cummax over (cluster, e2)
        base = (cid2 << 33) + 2**32
        run_max = torch.cummax(base + e2, 0).values - base
        prev = torch.where(first2, 0, torch.cat([e2[:1], run_max[:-1]]))
        add = torch.clamp_min(e2 - torch.maximum(s2, prev), 0)
        cov = _segment("sum", add, cid2, P_cap)
        uniq_flag = (mult_s <= mmp.uniq_threshold) & (len_s >= mmp.seed_min_length) & valid_s
        has_unique = _segment("amax", uniq_flag, cid, P_cap) > 0
        cl_valid = _segment("amax", valid_s, cid, P_cap) > 0
        cl_walker = _segment("amin", torch.where(valid_s, walker_s, 1 << 24), cid, P_cap)
        cl_pos = _segment("amin", torch.where(valid_s, start_s, 1 << 30), cid, P_cap)
        re = torch.where(cl_valid, cl_walker % n2, 0)
        best_cov = _segment("amax", torch.where(cl_valid, cov, 0), re, n2)
        # the coverage test in float32, as the reference's program
        cl_keep = cl_valid & (has_unique | (cov >= mmp.good_seed_len)) & (
            cov.to(torch.float32) >= short_f * best_cov[re].to(torch.float32)
        )
        cl_strand = cl_valid & (cl_walker >= n2)
        cl_pair = torch.where(re < Bl, re, re - Bl)
        cl_end = (re >= Bl).to(i64)
        mark("cluster")

        # ---- 4. divide-gap compress + insert-window join -------------
        iota_p = iota

        def orient(flip: int):
            # left leg: + strand of end ``flip``; right: - strand of the
            # other end (pair_candidates)
            lmask = cl_keep & ~cl_strand & (cl_end == flip)
            rmask = cl_keep & cl_strand & (cl_end == 1 - flip)
            lorder = _lexsort((cl_pos, cl_pair, ~lmask))
            lpair = cl_pair[lorder]
            lpos = cl_pos[lorder]
            lvalid = lmask[lorder]
            lfirst = _first_of_runs(lpair, lvalid)
            lseg_id = torch.cumsum(lfirst.to(i64), 0) - 1
            lseg_end = _segment("amax", iota_p + 1, lseg_id, P_cap)[lseg_id]
            nxtl = _seg_search(lpos, lseg_id, iota_p, lseg_end, lpos + params.divide_gap,
                               strict=True)
            lkeep = _chain_anchors(lfirst, nxtl, lseg_end, lvalid)

            rorder = _lexsort((cl_pos, cl_pair, ~rmask))
            rvalid = rmask[rorder]
            rpos_s = cl_pos[rorder]
            rpair_s = torch.where(rvalid, cl_pair[rorder], 0)
            rseg = torch.cumsum(_first_of_runs(rpair_s, rvalid).to(i64), 0) - 1
            ridx = torch.where(rvalid, iota_p, P_cap)
            rlo_p = _segment("amin", ridx, rpair_s, Bl)
            rhi_p = _segment("amax", torch.where(rvalid, iota_p + 1, 0), rpair_s, Bl)
            lp = lpair.clamp(0, Bl - 1)
            rlo = rlo_p[lp]
            rhi = torch.maximum(rhi_p[lp], rlo)

            # window bounds use the RIGHT read's length
            rl = (lens2i if flip == 0 else lens1i)[lpair]
            margin = torch.where(rl > 100, 30, 25)
            len_lo = torch.clamp_min(params.insert_low - rl - margin, 0)
            len_hi = params.insert_high - rl + margin
            s_ = _seg_search(rpos_s, rseg, rlo, rhi, lpos + len_lo, strict=False)
            e_ = _seg_search(rpos_s, rseg, rlo, rhi, lpos + len_hi, strict=True)
            cnts = torch.where(lkeep & lvalid, e_ - s_, 0)
            ccum = torch.cumsum(cnts, 0)
            ctotal = ccum[-1]
            jj = ar(C_cap)
            li = torch.searchsorted(ccum, jj, right=True).clamp(0, P_cap - 1)
            cvalid = jj < ctotal
            wi = jj - (ccum[li] - cnts[li])
            ri = (s_[li] + wi).clamp(0, P_cap - 1)
            return (
                cvalid,
                torch.where(cvalid, lpair[li], 0),
                torch.where(cvalid, lpos[li], 0),
                torch.where(cvalid, rpos_s[ri], 0),
                ctotal > C_cap,
            )

        v0, p0, lp0, rp0, ov0 = orient(0)
        v1, p1, lp1, rp1, ov1 = orient(1)
        flags += [ov0, ov1]
        C2f = 2 * C_cap
        cvalid_f = torch.cat([v0, v1])
        cflip_f = torch.cat([torch.zeros(C_cap, dtype=i64, device=dev),
                             torch.ones(C_cap, dtype=i64, device=dev)])
        # the real candidates packed to the front of dp_factor * Bl rows
        C2 = _capn(caps.dp_factor, Bl)
        n_cand = cvalid_f.sum()
        flags.append(n_cand > C2)
        iota_c = ar(C2f)
        cord = torch.argsort(torch.where(cvalid_f, iota_c, C2f + iota_c))[:C2]
        cvalid = cvalid_f[cord] & (ar(C2) < n_cand)
        cpair = torch.where(cvalid, torch.cat([p0, p1])[cord], 0)
        clpos = torch.where(cvalid, torch.cat([lp0, lp1])[cord], 0)
        crpos = torch.where(cvalid, torch.cat([rp0, rp1])[cord], 0)
        cflip = torch.where(cvalid, cflip_f[cord], 0)
        mark("pair")

        # ---- 5. deep DP (engine._deep_dp) ----------------------------
        all_l = all_lens.to(i64)
        left_idx = torch.where(cflip == 1, cpair + Bl, cpair)
        right_idx = torch.where(cflip == 1, cpair, cpair + Bl)
        lL = all_l[left_idx]
        lR = all_l[right_idx]
        margin_l = torch.where(lL > 100, 30, 25)
        margin_r = torch.where(lR > 100, 30, 25)
        starts_l = clpos - margin_l
        starts_r = crpos - margin_r

        def full_dp(reads_, lens_, starts_, wl_, width):
            wins = gather_windows_packed(cell.ref_words, cell.n_text, starts_, width)
            return _full_dp(reads_, wins, lens_, wl_, width, L, dp)

        s1v, st_l, e_l = full_dp(walkers[left_idx], lL, starts_l, lL + 2 * margin_l, Wwin)
        hit_left = starts_l + st_l
        bound = hit_left + insert_high - starts_r
        wl_r = torch.minimum(lR + 2 * margin_r, bound)
        s2v, st_r, e_r = full_dp(walkers[2 * Bl + right_idx], lR, starts_r, wl_r, Wwin)
        ok_l = cvalid & (s1v >= thr_of(lL))
        kept = ok_l & (s2v >= thr_of(lR))
        aligned = _segment("amax", kept, cpair, Bl) > 0

        def seq_of(p):
            return torch.searchsorted(cell.seq_off, p, right=True) - 1

        def in_one_seq(gs, ge):
            seq_s = seq_of(gs)
            return seq_s, (seq_s == seq_of(torch.maximum(ge - 1, gs))) & (gs >= 0)

        g_sl = starts_l + st_l
        g_el = starts_l + e_l
        g_sr = starts_r + st_r
        g_er = starts_r + e_r
        seq_l, okb_l = in_one_seq(g_sl, g_el)
        seq_r, okb_r = in_one_seq(g_sr, g_er)
        same = kept & okb_l & okb_r & (seq_l == seq_r)
        summed = s1v + s2v
        norm_l = torch.where(same, summed, s1v)
        norm_r = torch.where(same, summed, s2v)
        dl_valid = kept & okb_l
        dr_valid = kept & okb_r
        end_l = (cflip == 1).to(i64)
        end_r = (cflip != 1).to(i64)
        mark("deep DP")

        # ---- 6. single-end DP + mate rescue --------------------------
        semask = cl_keep & ~aligned[cl_pair]
        # host order: lexsort((pos, strand, end, pair)); rank < 200 a
        # (pair, end) group (DV-DPForSingleReads.cpp:200)
        seorder = _lexsort((cl_pos, cl_strand.to(i64), cl_end, cl_pair, ~semask))
        se_pair = cl_pair[seorder]
        se_end = cl_end[seorder]
        se_strand = cl_strand[seorder].to(i64)
        se_pos = cl_pos[seorder]
        se_ok = semask[seorder]
        gix = torch.cumsum(_first_of_runs(se_pair * 2 + se_end, se_ok).to(i64), 0) - 1
        first_of = _segment("amin", iota_p, gix, P_cap)
        rank = iota_p - first_of[gix]
        se_ok = se_ok & (rank < params.max_se_candidates)
        n_se = se_ok.sum()
        flags.append(n_se > SE_cap)
        pick = torch.argsort(torch.where(se_ok, ar(P_cap), 1 << 30), stable=True)[:SE_cap]
        a_valid = se_ok[pick]
        a_pair = torch.where(a_valid, se_pair[pick], 0)
        a_end = torch.where(a_valid, se_end[pick], 0)
        a_strand = torch.where(a_valid, se_strand[pick], 0)
        a_pos = torch.where(a_valid, se_pos[pick], 0)

        a_re = a_pair + a_end * Bl
        a_rl = all_l[a_re]
        a_ws = a_pos - torch.where(a_rl > 100, 30, 25)
        sa, st_a, e_a = full_dp(walkers[a_re + a_strand * n2], a_rl, a_ws,
                                torch.full((SE_cap,), Wse, dtype=i64, device=dev), Wse)
        a_passed = a_valid & (sa >= thr_of(a_rl))
        a_gs = a_ws + st_a
        a_ge = a_ws + e_a
        a_seq, a_okb = in_one_seq(a_gs, a_ge)
        anchor_ok = a_passed & a_okb

        # mate rescue (engine._mate_rescue): one insert-window DP for
        # each passing anchor, the anchors packed to rescue_factor * Bl
        # rows first (their order kept)
        R_cap = _capn(caps.rescue_factor, Bl)
        n_resc = anchor_ok.sum()
        flags.append(n_resc > R_cap)
        iota_se = ar(SE_cap)
        rord = torch.argsort(torch.where(anchor_ok, iota_se, SE_cap + iota_se))[:R_cap]
        r_ok = anchor_ok[rord] & (ar(R_cap) < n_resc)
        rs_pair = torch.where(r_ok, a_pair[rord], 0)
        rs_end = torch.where(r_ok, a_end[rord], 0)
        rs_strand = torch.where(r_ok, a_strand[rord], 0)
        rs_gs = torch.where(r_ok, a_gs[rord], 0)
        rs_ge = torch.where(r_ok, a_ge[rord], 0)
        rs_seq = torch.where(r_ok, a_seq[rord], 0)

        m_idx = rs_pair + (1 - rs_end) * Bl
        ml = all_l[m_idx]
        m_margin = torch.where(ml > 100, 30, 25)
        m_ws = torch.where(rs_strand == 0, rs_gs - m_margin, rs_ge - insert_high - m_margin)
        m_strand = 1 - rs_strand
        sm, st_m, e_m = full_dp(walkers[m_idx + m_strand * n2], ml, m_ws,
                                torch.full((R_cap,), Wrescue, dtype=i64, device=dev),
                                Wrescue)
        m_passed = r_ok & (sm >= thr_of(ml))
        m_gs = m_ws + st_m
        m_ge = m_ws + e_m
        m_seq, m_okb = in_one_seq(m_gs, m_ge)
        m_valid = m_passed & m_okb
        m_same = m_valid & (rs_seq == m_seq)
        rs_sa = torch.where(r_ok, sa[rord], 0)
        m_summed = torch.where(m_same, sm + rs_sa, sm)

        # rescued anchors carry the summed pair score (normalizeScore):
        # each anchor's rescue row is its rank among the passing anchors
        arank = torch.cumsum(anchor_ok.to(i64), 0) - 1
        rank_c = arank.clamp(0, R_cap - 1)
        a_m_same = anchor_ok & (arank < R_cap) & m_same[rank_c]
        a_norm = torch.where(a_m_same, sa + sm[rank_c], sa)
        mark("single-end DP + rescue")

        # ---- 7. assemble, and pack the valid rows to the front -------
        valid = torch.cat([dl_valid, dr_valid, anchor_ok, m_valid])
        cols = [
            valid,
            torch.cat([cpair, cpair, a_pair, rs_pair]),
            torch.cat([end_l, end_r, a_end, 1 - rs_end]),
            torch.cat([seq_l, seq_r, a_seq, m_seq]),
            torch.cat([norm_l, norm_r, a_norm, m_summed]),
            torch.cat([s1v, s2v, sa, sm]),
            torch.cat([g_sl, g_sr, a_gs, m_gs]),
            torch.cat([g_el, g_er, a_ge, m_ge]),
            torch.cat([torch.zeros(C2, dtype=i64, device=dev),
                       torch.ones(C2, dtype=i64, device=dev), a_strand, m_strand]),
            torch.cat([same, same, a_m_same, m_same]),
        ]
        Ht = valid.shape[0]
        # the lean caps can make the assembled table smaller than the hit cap
        H_cap = min(_capn(caps.hit_factor, Bl), Ht)
        n_hits = valid.sum()
        flags.append(n_hits > H_cap)
        iota_h = ar(Ht)
        ordr = torch.argsort(torch.where(valid, iota_h, Ht + iota_h))[:H_cap]
        table = torch.stack([c.to(torch.int32)[ordr] for c in cols])
        table[0] &= (ar(H_cap) < n_hits).to(torch.int32)
        overflow = torch.stack(flags).any().to(torch.int32).reshape(1)
        # the located rows ride the same read-back, as two int32 words
        located = torch.stack([total & I32_MAX, total >> 31]).to(torch.int32)
        mark("compact")
        return torch.cat([table.reshape(-1), overflow, located])

    def step(inputs: SpmdInputs, reads1, reads2, lens1, lens2,
             timer: Optional[StageEvents] = None,
             located: Optional[List[np.ndarray]] = None) -> SpmdHits:
        D, S = mesh.shape["data"], mesh.shape["shard"]
        for row in inputs.cells:
            for s, cell in enumerate(row):
                _check_meta(meta, cell.dfm, f"shard {s}")
        host = [torch.as_tensor(np.ascontiguousarray(a)) for a in (reads1, reads2, lens1, lens2)]
        B = host[0].shape[0]
        if B % D or host[0].shape[1] != L or host[1].shape[1] != L:
            raise ValueError(f"reads {tuple(host[0].shape)}, {tuple(host[1].shape)}: the "
                             f"step takes [D * Bl, {L}] with D = {D}")
        r1, r2 = host[0].to(torch.uint8), host[1].to(torch.uint8)
        l1, l2 = host[2].to(torch.int32), host[3].to(torch.int32)

        def cell_step(s, cell, *block):
            mark = timer.cell(block[0].device) if timer is not None else (lambda name: None)
            return local_step(cell, *block, mark)

        # enqueue every cell's work, then read back once a device
        fields = run_cells(mesh, inputs.cells, (r1, r2, l1, l2), cell_step)
        H = (fields[0][0].shape[0] - 3) // N_OUT
        arr = np.stack([np.stack(r) for r in fields])  # [D, S, N_OUT * H + 3]
        tab = arr[:, :, :-3].reshape(D, S, N_OUT, H)
        cols = [tab[:, :, k] for k in range(N_OUT)]
        cols[0] = cols[0].astype(bool)
        cols[9] = cols[9].astype(bool)
        if located is not None:
            located.append(arr[:, :, -2].astype(np.int64) + (arr[:, :, -1].astype(np.int64) << 31))
        return SpmdHits(*cols, overflow=arr[:, :, -3].astype(np.int32))

    return step


def spmd_hits_to_batch(out: SpmdHits, n_pairs_per_row: int) -> List[BatchHits]:
    """[D, S, H] step output -> one ``BatchHits`` a shard with global read
    indices (read + d * Bl), the data rows in order. Raises when a cell's
    cap overflowed."""
    if int(out.overflow.max()) != 0:
        raise RuntimeError("spmd_full cap overflow — raise SpmdCaps factors")
    D, S, H = out.valid.shape
    read_g = out.read.astype(np.int64) + (
        np.arange(D, dtype=np.int64) * n_pairs_per_row)[:, None, None]
    hits: List[BatchHits] = []
    for s in range(S):
        m = out.valid[:, s, :]
        hits.append(BatchHits(
            read=read_g[:, s, :][m].astype(np.int32),
            end=out.end[:, s, :][m].astype(np.int8),
            seq=out.seq[:, s, :][m].astype(np.int32),
            score=out.score[:, s, :][m].astype(np.int32),
            raw_score=out.raw_score[:, s, :][m].astype(np.int32),
            start=out.start[:, s, :][m].astype(np.int64),
            stop=out.stop[:, s, :][m].astype(np.int64),
            strand=out.strand[:, s, :][m].astype(np.int8),
            paired=out.paired[:, s, :][m].astype(bool),
        ))
    return hits


def spmd_payload_stats(
    out: SpmdHits, n_pairs_per_row: int, n_real_pairs: Optional[int] = None
) -> dict:
    """The hit payload one step brings back to the host, per pair and
    shard: H rows x 10 int32 fields allocated, the valid rows useful.
    ``n_real_pairs`` leaves the block padding out of the denominator."""
    D, S, H = out.valid.shape
    n_rows = int(out.valid.sum())
    n_pairs = n_real_pairs if n_real_pairs else D * n_pairs_per_row
    bytes_per_row = 10 * 4  # 10 int32 fields with valid
    return {
        "pairs": n_pairs,
        "shards": S,
        "hit_rows": n_rows,
        "rows_per_pair_per_shard": round(n_rows / max(n_pairs * S, 1), 3),
        "useful_bytes_per_pair_per_shard": round(
            n_rows * bytes_per_row / max(n_pairs * S, 1), 1),
        "alloc_bytes_per_pair_per_shard": round(
            D * S * H * bytes_per_row / max(n_pairs * S, 1), 1),
    }
