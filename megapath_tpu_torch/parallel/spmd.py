"""The reduced alignment engine run for each (data, shard) cell of a grid
of torch devices, and the merge of its hits across the shards.

Port of ``megapath_tpu/parallel/spmd.py``. The reference runs the step as
one ``shard_map`` program over a (data x shard) mesh; here the mesh is a
``spmd_full.Mesh`` of torch devices in one process, and the step enqueues
every cell's work before the first read-back, as ``spmd_full``'s step
does (``spmd_full.run_cells``). Cell (d, s) aligns data block d against
shard s:

  1. the MMP walk over [r1; r2; rc r1; rc r2] with ``max_seeds`` slots a
     walker (``seeding_dev.mmp_seed_device``: the ``mmp_seed`` kernel on a
     card), one-phase with max_steps = charge_limit = 3L + 64, as
     ``spmd_full`` walks. The reference walks two-phase with 2 (3L + 64) +
     128 steps when its occ blocks are under 128 rows; the outputs are the
     same (``tests/test_torch_spmd.py``).
  2. one SA row located a seed slot (``locate_device``: the ``locate``
     kernel); invalid slots locate row 0 and are masked after
  3. the best insert-window pair of each orientation over the [Bl, 6, 6]
     table of seed-length sums (the first index on ties)
  4. the four legs' windows, gathered from the text cut to ``true_n``, and
     one forward DP over their 4 Bl rows (``ops.dp.sw_align_auto``: the
     ``dp_fwd`` kernel)
  5. the per-shard threshold, the pair score and the left leg's species

The host reads each device's cells back once and merges them
(``merge_shards``): the reference's ``all_gather`` over 'shard' is a stack
of a data row's cell outputs, its ``psum`` over 'data' a sum over the rows.
Ties go to the lowest shard id. The thresholds are products taken wholly
in float32, as the reference's program takes them. Positions are int64,
where the reference's int32 fragment lengths can wrap (only where the
pair is already masked).

The reference stacks the shards' leaves for its one program shape; here
each shard keeps its own tables (``StackedFM`` holds them shard by shard)
and goes to each distinct device of its column once
(``place_spmd_inputs``). The shards still share one text length, because
the reference's windows clip to n - 1 and mask against ``true_n``:
``pad_and_index_shards`` pads them as the reference does. The reference's
``FMMeta.blk`` (its occ block layout) has no counterpart in the port's
``DeviceFM``, whose rows always cover 128 characters.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from megapath_tpu_torch.align.device import gather_windows
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align.seeding_dev import (
    DeviceFM,
    HostFM,
    build_walkers,
    locate_device,
    mmp_seed_device,
)
from megapath_tpu_torch.index.fm import FMIndex, build_fm_index
from megapath_tpu_torch.ops.dp import DPParams, sw_align_auto
from megapath_tpu_torch.parallel.spmd_full import (
    Mesh,
    SpmdInputs,
    float32_floor,
    place_columns,
    run_cells,
)

NEG = -(1 << 30)  # an invalid candidate position


class FMMeta(NamedTuple):
    """The build parameters every shard shares."""

    n: int
    lut_k: int
    sa_interval: int


class StackedFM(NamedTuple):
    """Each shard's FM tables in shard order: ``HostFM`` (packed on the
    host, uploaded at placement) or ``DeviceFM`` (on a device already,
    copied only to another device)."""

    tables: Tuple[Union[HostFM, DeviceFM], ...]


def stack_fms(fms: Sequence[Union[FMIndex, HostFM, DeviceFM]]) -> Tuple[StackedFM, FMMeta]:
    """The shards' tables for the step, an ``FMIndex`` packed once
    (``HostFM.pack``). Refuses shards of different text lengths and
    shards built with different parameters, as the reference does."""
    ns = {int(fm.n) for fm in fms}
    if len(ns) != 1:
        raise ValueError(
            f"SPMD shards must share a text length (got {sorted(ns)}); "
            "use pad_and_index_shards"
        )
    if len({(int(fm.lut_k), int(fm.sa_interval)) for fm in fms}) != 1:
        raise ValueError("shard FM build parameters differ")
    tables = tuple(HostFM.pack(fm) if isinstance(fm, FMIndex) else fm for fm in fms)
    t = tables[0]
    return StackedFM(tables), FMMeta(n=int(t.n), lut_k=int(t.lut_k),
                                     sa_interval=int(t.sa_interval))


def pad_and_index_shards(
    shard_codes: Sequence[np.ndarray],
    sa_interval: int = 16,
    lut_k: int = 8,
    seed: int = 7,
    device: torch.device = torch.device("cuda"),
) -> Tuple[List[FMIndex], np.ndarray, np.ndarray]:
    """Pad shard texts to a common length with random junk, as the
    reference pads them (``default_rng(seed)``, one draw a shard in shard
    order; a spurious exact >= 17-mer match into the pad has probability
    ~4^-17, and candidates in the pad are masked against ``true_n``), and
    build each shard's FM index on ``device``. Returns (fms, padded_codes
    uint8 [S, N], true_n int32 [S])."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"pad_and_index_shards on {device}: CUDA is not available; pass "
                           "device=torch.device('cpu') to build on the host")
    rng = np.random.default_rng(seed)
    n = max(len(c) for c in shard_codes)
    padded, fms, true_n = [], [], []
    for c in shard_codes:
        pad = rng.integers(0, 4, n - len(c)).astype(np.uint8)
        full = np.concatenate([np.asarray(c, np.uint8), pad])
        padded.append(full)
        fms.append(build_fm_index(full, sa_interval=sa_interval, lut_k=lut_k, device=device))
        true_n.append(len(c))
    return fms, np.stack(padded), np.asarray(true_n, np.int32)


def make_mesh_for(devices: Sequence, n_shards: int = 2) -> Mesh:
    """(data x shard) grid with the shard axis sized to the index shards;
    leftover devices fold into the data axis."""
    devs = [torch.device(d) for d in devices]
    rows = len(devs) // n_shards
    if rows == 0:
        raise ValueError(f"need at least {n_shards} devices for {n_shards} shards")
    return Mesh(tuple(
        tuple(devs[d * n_shards + s] for s in range(n_shards)) for d in range(rows)
    ))


def table_on(table: Union[HostFM, DeviceFM], device: torch.device) -> DeviceFM:
    """A shard's tables on ``device``: a ``HostFM`` uploaded, a
    ``DeviceFM`` as it is if it lies there, else its tensors copied."""
    if isinstance(table, HostFM):
        return table.upload(device)
    return dataclasses.replace(table, **{
        k: None if getattr(table, k) is None else getattr(table, k).to(device)
        for k in ("rows", "counts", "lut_lo", "lut_hi", "mark_rows", "sa_sampled")})


def as_host(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or tensor as a contiguous ``dtype`` tensor (a tensor
    stays on its device; numpy is shared, not copied, where it can be)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dtype).contiguous()


class ShardCell(NamedTuple):
    """One shard's step inputs on one device."""

    dfm: DeviceFM
    text: torch.Tensor  # uint8 [true_n]: the padded text cut to its true length
    seq_off: torch.Tensor  # int64 [M + 1] sequence starts, then the text length
    seq_sp: torch.Tensor  # int64 [M] species of each sequence


def place_spmd_inputs(mesh: Mesh, sfm: StackedFM, *, ref_codes, true_n, seq_offsets,
                      seq_species) -> SpmdInputs:
    """Put each shard's tables, text (``ref_codes`` [S, N], cut to its
    ``true_n``), ``seq_offsets`` [S, M + 1] and ``seq_species`` [S, M] on
    each distinct device of its column once; a step ships only the reads.
    ``ref_codes`` may be numpy or a tensor (one on the device is not
    copied)."""
    S = mesh.shape["shard"]
    if len(sfm.tables) != S:
        raise ValueError(f"{len(sfm.tables)} shards for a grid of {S} shard columns")
    codes = as_host(ref_codes, torch.uint8)
    tn = [int(t) for t in np.asarray(true_n)]
    for s, t in enumerate(sfm.tables):
        if codes.shape[1] != t.n or not 0 <= tn[s] <= t.n:
            raise ValueError(f"shard {s}: text of {codes.shape[1]} chars, true_n {tn[s]}, "
                             f"its tables cover {t.n}")
    offs = as_host(seq_offsets, torch.int64)
    species = as_host(seq_species, torch.int64)

    def put(s: int, dev: torch.device) -> ShardCell:
        return ShardCell(dfm=table_on(sfm.tables[s], dev), text=codes[s, : tn[s]].to(dev),
                         seq_off=offs[s].to(dev), seq_sp=species[s].to(dev))

    return place_columns(mesh, put)


class SpmdAlignOut(NamedTuple):
    """The merged hits of a step, numpy on the host."""

    best_score: np.ndarray  # int32 [B] best paired score over shards
    best_shard: np.ndarray  # int32 [B] (-1 without a hit)
    best_pos: np.ndarray  # int32 [B] left-leg text position of the best
    all_scores: np.ndarray  # int32 [B, S] per-shard best paired score
    all_species: np.ndarray  # int32 [B, S] species of that hit (-1 none)
    kept: np.ndarray  # bool [B, S] -top retention vs the global best
    species_counts: np.ndarray  # int32 [T] winner-species histogram


def merge_shards(scores: torch.Tensor, species: torch.Tensor, pos: torch.Tensor,
                 n_species: int, top_percentage: float, highest_wins: bool = False) -> tuple:
    """The reference's cross-shard merge of [B, S] int64 tensors (score 0 =
    no hit): (best_score, best_shard, best_pos, kept, species_counts [T]),
    the histogram of the winners' species over all B rows (a pair without a
    hit votes for the dropped bin ``n_species``).

    ``spmd``'s rule (``highest_wins`` False): ties go to the lowest shard
    id, and ``best_shard`` is -1 where no shard scored. ``dist``'s rule:
    ties go to the highest shard id, and ``best_shard`` is not masked (a
    row without a hit gives S - 1)."""
    S = scores.shape[1]
    best = scores.max(dim=1).values
    ids = torch.arange(S, dtype=torch.int64, device=scores.device)[None, :]
    is_best = scores == best[:, None]
    if highest_wins:
        best_shard = torch.where(is_best, ids, -1).max(dim=1).values
    else:
        best_shard = torch.where(is_best & (scores > 0), ids, S).min(dim=1).values
        best_shard = torch.where(best > 0, best_shard, -1)
    col = best_shard.clamp_min(0)[:, None]
    best_pos = torch.where(best > 0, pos.gather(1, col)[:, 0], -1)
    kept = (scores > 0) & (scores >= float32_floor(top_percentage, best)[:, None])
    win_sp = torch.where(best > 0, species.gather(1, col)[:, 0], n_species)
    votes = win_sp[(win_sp >= 0) & (win_sp <= n_species)]
    hist = torch.bincount(votes, minlength=n_species + 1)[:n_species]
    return best, best_shard, best_pos, kept, hist


def grid_reads(mesh: Mesh, arrays, dtypes, widths) -> List[torch.Tensor]:
    """The step's host inputs as tensors of ``dtypes``; B must split into
    the grid's data rows and each 2-D input have its width."""
    D = mesh.shape["data"]
    host = [as_host(a, t).cpu() for a, t in zip(arrays, dtypes)]
    B = host[0].shape[0]
    for a, w in zip(host, widths):
        if a.shape[0] != B or B % D or (w is not None and (a.dim() != 2 or a.shape[1] != w)):
            raise ValueError(f"inputs of shapes {[tuple(h.shape) for h in host]}: the step "
                             f"takes D * Bl rows with D = {D} and widths {widths}")
    return host


def build_spmd_engine_step(
    mesh: Mesh,
    meta: FMMeta,
    read_len: int,
    n_species: int,
    params: AlignParams = AlignParams(),
    max_seeds: int = 6,
):
    """The seed -> pair -> DP -> merge step over the grid: ``step(inputs,
    reads1, reads2, lens1, lens2) -> SpmdAlignOut``, ``inputs`` from
    ``place_spmd_inputs``, reads uint8 [B, L] and lengths [B] (numpy or
    CPU tensors), B = D * Bl, data block d = rows d * Bl .. (d + 1) * Bl - 1.
    The step refuses shard tables that disagree with ``meta``."""
    D, S = mesh.shape["data"], mesh.shape["shard"]
    L = read_len
    mmp = params.mmp
    margin = params.margin(L)
    width = L + 2 * margin
    chg = 3 * L + 64
    dp = DPParams(params.match, params.mismatch, params.gap_open, params.gap_extend)
    i64 = torch.int64

    def best_pair(cl, ll, cr, lr, len_r):
        """Left leg forward at cl, right leg reverse-complement at cr
        downstream: fragment (cr + len_r) - cl within the insert window
        (DV-DPfunctions.cpp); the pair of the largest seed-length sum."""
        Bl = cl.shape[0]
        frag = (cr[:, None, :] + len_r[:, None, None]) - cl[:, :, None]
        okp = ((cl[:, :, None] > NEG // 2) & (cr[:, None, :] > NEG // 2)
               & (frag >= params.insert_low) & (frag <= params.insert_high))
        qual = torch.where(okp, ll[:, :, None] + lr[:, None, :], -1).reshape(Bl, -1)
        bi = torch.argmax(qual, dim=1)  # the first index on ties
        has = qual.gather(1, bi[:, None])[:, 0] > -1
        pl = cl.gather(1, (bi // max_seeds)[:, None])[:, 0]
        pr = cr.gather(1, (bi % max_seeds)[:, None])[:, 0]
        return has, pl, pr

    def local_step(s: int, cell: ShardCell, reads1, reads2, lens1, lens2) -> torch.Tensor:
        dfm = cell.dfm
        dev = reads1.device
        Bl = reads1.shape[0]

        # ---- 1. MMP seeding over [r1; r2; rc r1; rc r2] -----------------
        walkers, wlens = build_walkers(torch.cat([reads1, reads2]), torch.cat([lens1, lens2]))
        seeds = mmp_seed_device(dfm, walkers, wlens, mmp, max_seeds, chg, chg)

        # ---- 2. SA locate, one row a seed slot --------------------------
        cnt = seeds.sa_count.to(i64)
        slots = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]
        svalid = ((slots < seeds.n_seeds.to(i64)[:, None]) & (cnt >= 1)
                  & (cnt <= mmp.sa_size_threshold))
        rows = torch.where(svalid, seeds.sa_lo, 0).reshape(-1).to(torch.int32)
        pos = locate_device(dfm, rows).to(i64).reshape(svalid.shape)
        # candidate read start in the shard text; the pad and off the text dropped
        cand = pos - seeds.offset.to(i64)
        ok = svalid & (pos >= 0) & (cand >= -margin) & (cand < cell.text.shape[0])
        cand = torch.where(ok, cand, NEG).reshape(4, Bl, max_seeds)
        seed_len = torch.where(ok, seeds.length.to(i64), 0).reshape(4, Bl, max_seeds)

        # ---- 3. pairing: walker blocks r1 fwd, r2 fwd, rc r1, rc r2 -----
        # orientation 0: r1 fwd + rc r2; orientation 1: r2 fwd + rc r1
        has0, p0l, p0r = best_pair(cand[0], seed_len[0], cand[3], seed_len[3], lens2.to(i64))
        has1, p1l, p1r = best_pair(cand[1], seed_len[1], cand[2], seed_len[2], lens1.to(i64))

        # ---- 4. window gather + one DP over the four legs ---------------
        dp_reads = torch.cat([walkers[:Bl], walkers[3 * Bl:], walkers[Bl:2 * Bl],
                              walkers[2 * Bl:3 * Bl]])
        dp_lens = torch.cat([lens1, lens2, lens2, lens1])
        starts = torch.cat([p0l, p0r, p1l, p1r]).clamp_min(0) - margin
        wins = gather_windows(cell.text, starts, width)
        res = sw_align_auto(dp_reads, wins, dp_lens,
                            torch.full((4 * Bl,), width, dtype=torch.int32, device=dev),
                            params=dp)
        thr = float32_floor(params.cutoff_ratio, dp_lens).clamp_min(params.cutoff_lower_bound)
        sc = res.score.to(i64)
        leg = torch.where(sc >= thr, sc, 0).reshape(4, Bl)
        pair0 = torch.where(has0 & (leg[0] > 0) & (leg[1] > 0), leg[0] + leg[1], 0)
        pair1 = torch.where(has1 & (leg[2] > 0) & (leg[3] > 0), leg[2] + leg[3], 0)
        score = torch.maximum(pair0, pair1)
        left = torch.where(score > 0, torch.where(pair0 >= pair1, p0l, p1l), -1)

        # ---- 5. species of the hit on this shard ------------------------
        seq_idx = torch.searchsorted(cell.seq_off, left.clamp_min(0), right=True) - 1
        seq_idx = seq_idx.clamp(0, cell.seq_sp.shape[0] - 1)
        species = torch.where(score > 0, cell.seq_sp[seq_idx], -1)
        return torch.stack([score, left, species]).to(torch.int32)

    def step(inputs: SpmdInputs, reads1, reads2, lens1, lens2) -> SpmdAlignOut:
        for row in inputs.cells:
            for s, cell in enumerate(row):
                got = FMMeta(n=int(cell.dfm.n), lut_k=int(cell.dfm.lut_k),
                             sa_interval=int(cell.dfm.sa_interval))
                if got != meta:
                    raise ValueError(f"shard {s}: tables built with {got}, the step's meta "
                                     f"is {meta}")
        host = grid_reads(mesh, (reads1, reads2, lens1, lens2),
                          (torch.uint8, torch.uint8, torch.int32, torch.int32), (L, L, None, None))
        B = host[0].shape[0]
        # enqueue every cell's work, then read back once a device
        got = np.stack([np.stack(r) for r in run_cells(mesh, inputs.cells, host, local_step)])
        # [D, S, 3, Bl] -> the [B, S] gathers of score, left position, species
        score, left, species = torch.from_numpy(got).to(i64).permute(2, 0, 3, 1).reshape(3, B, S)
        best, best_shard, best_pos, kept, hist = merge_shards(
            score, species, left, n_species, params.top_percentage)
        i32 = lambda t: t.to(torch.int32).numpy()  # noqa: E731
        return SpmdAlignOut(i32(best), i32(best_shard), i32(best_pos), i32(score),
                            i32(species), kept.numpy(), i32(hist))

    return step


def spmd_report(
    out: SpmdAlignOut,
    species_tids: Sequence[int],
    taxdb,
    lens1: np.ndarray,
    lens2: np.ndarray,
    cutoff: int = 40,
) -> str:
    """The report tail over the step's merged hit arrays.

    Equivalent of fastq2lsam | taxLookupAcc | genKrakenReport on the
    distributed output: each pair contributes one classified line per
    end (the step reports proper pairs; both ends carry the summed pair
    score and the LCA of the -top-retained species set,
    genKrakenReport.cpp:148-156 thresholding).
    """
    from megapath_tpu_torch.taxonomy.report import KrakenReport

    kept = np.asarray(out.kept)
    species = np.asarray(out.all_species)
    best = np.asarray(out.best_score).astype(np.int64)
    tid_of = np.asarray(list(species_tids) + [0], dtype=np.int64)
    B = kept.shape[0]

    # grouped LCA over the kept (read, species) rows, keyed on
    # row * (species.max() + 2) + species (taxdb.lca_grouped)
    lcas = np.zeros(B, np.int64)
    rows, cols = np.nonzero(kept & (species >= 0))
    if len(rows):
        key = rows.astype(np.int64) * (species.max() + 2) + species[rows, cols]
        order = np.argsort(key)
        rs, ss = rows[order], species[rows, cols][order]
        uniq = np.r_[True, (rs[1:] != rs[:-1]) | (ss[1:] != ss[:-1])]
        rs, ss = rs[uniq], ss[uniq]
        pres = np.unique(rs)
        lcas[pres] = taxdb.lca_grouped(tid_of[ss], rs)

    # one line a read end: both carry the pair's score and the LCA;
    # unaligned pairs are unclassified
    line_scores = np.repeat(best, 2)
    line_lcas = np.repeat(lcas, 2)
    eff = np.where(line_lcas > 0, line_scores, -1)
    rpt = KrakenReport(taxdb)
    rpt.add_lsam_batch(eff, line_lcas, cutoff)
    return rpt.format()
