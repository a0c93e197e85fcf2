"""The alignment at given candidate positions for each (data, shard) cell
of a grid of torch devices, and the merge of its hits across the shards.

Port of ``megapath_tpu/parallel/dist.py``. The reference shards the packed
reference texts over its mesh's 'shard' axis and the read batches over
'data', and merges the per-shard best hits with an ``all_gather`` over
'shard' (the associative merge the reference's comment chain computes
shard after shard, runMegaPath.sh:191-227) and a ``psum`` over 'data'.
Here the mesh is a ``spmd_full.Mesh`` of torch devices in one process;
cell (d, s) gathers shard s's windows at its column of the candidate
positions, runs one forward DP over data block d (``ops.dp.sw_align_auto``:
the ``dp_fwd`` kernel on a card), thresholds the scores and maps each hit's
end to its sequence's species. The host reads each device's cells back
once and merges them as the reference does (``spmd.merge_shards``): ties
go to the HIGHEST shard id and ``best_shard`` is not masked, so a read
without a hit gives S - 1, unlike ``spmd``'s step (ROADMAP §C keeps both).

``make_mesh`` here is the reference's (a shard axis of 2 for an even
device count); the package-level ``parallel.make_mesh`` is
``spmd_full.make_mesh``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from megapath_tpu_torch.align.device import gather_windows
from megapath_tpu_torch.ops.dp import DPParams, sw_align_auto
from megapath_tpu_torch.parallel import spmd_full
from megapath_tpu_torch.parallel.spmd import as_host, grid_reads, merge_shards
from megapath_tpu_torch.parallel.spmd_full import (
    Mesh,
    SpmdInputs,
    float32_floor,
    place_columns,
    run_cells,
)


def make_mesh(n_devices: Optional[int] = None, shard_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """(data, shard) grid of the first ``n_devices`` of ``devices`` (every
    visible card by default; CPU places when given). The shard axis
    defaults to 2 when the count is even, else 1."""
    devs = spmd_full.grid_devices(torch.device("cuda"), devices)
    if not devs:
        raise RuntimeError("dist.make_mesh: CUDA is not available; pass devices= (CPU "
                           "places) to run on the host")
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices asked for, {len(devs)} given")
    if shard_axis is None:
        shard_axis = 2 if n % 2 == 0 and n >= 2 else 1
    if n % shard_axis:
        raise ValueError(f"{n} devices do not split into shard columns of {shard_axis}")
    return spmd_full.make_mesh(devs[:n], shard_axis)


class DistAlignOut(NamedTuple):
    """The merged hits of a step, numpy on the host."""

    best_score: np.ndarray  # int32 [B] best over all shards
    best_shard: np.ndarray  # int32 [B] shard of the best hit (S - 1 without one)
    best_pos: np.ndarray  # int32 [B] window start of the best hit (-1 none)
    all_scores: np.ndarray  # int32 [B, S] per-shard best score (0 = none)
    all_species: np.ndarray  # int32 [B, S] species of that hit (-1 = none)
    kept: np.ndarray  # bool [B, S] hit >= top_percentage * global best
    species_counts: np.ndarray  # int32 [T] winner-species read counts


class DistCell(NamedTuple):
    """One shard's step inputs on one device."""

    ref: torch.Tensor  # uint8 [N] the shard's packed text row
    seq_off: torch.Tensor  # int64 [M + 1] sequence starts, padded with the text length
    seq_sp: torch.Tensor  # int64 [M] species of each sequence


def shard_arrays(mesh: Mesh, *, ref_shards, seq_offsets, seq_species) -> SpmdInputs:
    """Put each shard's text row (``ref_shards`` [S, N]), ``seq_offsets``
    [S, M + 1] and ``seq_species`` [S, M] on each distinct device of its
    column once; a step ships only the reads and the candidates."""
    S = mesh.shape["shard"]
    refs = as_host(ref_shards, torch.uint8)
    offs = as_host(seq_offsets, torch.int64)
    species = as_host(seq_species, torch.int64)
    if not refs.shape[0] == offs.shape[0] == species.shape[0] == S:
        raise ValueError(f"{refs.shape[0]} shard rows for a grid of {S} shard columns")
    return place_columns(mesh, lambda s, dev: DistCell(
        ref=refs[s].to(dev), seq_off=offs[s].to(dev), seq_sp=species[s].to(dev)))


def build_dist_align_step(
    mesh: Mesh,
    width: int,
    n_species: int,
    params: DPParams = DPParams(),
    cutoff_lb: int = 30,
    cutoff_ratio: float = 0.2,
    top_percentage: float = 0.95,
):
    """The step over the grid: ``step(inputs, reads, read_lens, cand_pos)
    -> DistAlignOut``, ``inputs`` from ``shard_arrays``, reads uint8 [B, L],
    read_lens [B] and cand_pos [B, S] (each shard's window start; numpy or
    CPU tensors), B = D * Bl."""
    S = mesh.shape["shard"]
    i64 = torch.int64

    def local_step(s: int, cell: DistCell, reads, read_lens, cand_pos) -> torch.Tensor:
        pos = cand_pos[:, s].contiguous()
        wins = gather_windows(cell.ref, pos, width)
        wlens = torch.full((reads.shape[0],), width, dtype=torch.int32, device=reads.device)
        res = sw_align_auto(reads, wins, read_lens, wlens, params=params)
        thr = float32_floor(cutoff_ratio, read_lens).clamp_min(cutoff_lb)
        sc = res.score.to(i64)
        score = torch.where(sc >= thr, sc, 0)
        # the hit's last text position -> its sequence -> species
        hit_pos = pos + res.end_ref.to(i64) - 1
        seq_idx = torch.searchsorted(cell.seq_off, hit_pos, right=True) - 1
        seq_idx = seq_idx.clamp(0, cell.seq_sp.shape[0] - 1)
        species = torch.where(score > 0, cell.seq_sp[seq_idx], -1)
        return torch.stack([score, species, pos]).to(torch.int32)

    def step(inputs: SpmdInputs, reads, read_lens, cand_pos) -> DistAlignOut:
        host = grid_reads(mesh, (reads, read_lens, cand_pos),
                          (torch.uint8, torch.int32, torch.int64), (None, None, S))
        if host[0].dim() != 2:
            raise ValueError(f"reads of shape {tuple(host[0].shape)}: the step takes [B, L]")
        B = host[0].shape[0]
        # enqueue every cell's work, then read back once a device
        got = np.stack([np.stack(r) for r in run_cells(mesh, inputs.cells, host, local_step)])
        # [D, S, 3, Bl] -> the [B, S] gathers of score, species, window start
        score, species, pos = torch.from_numpy(got).to(i64).permute(2, 0, 3, 1).reshape(3, B, S)
        best, best_shard, best_pos, kept, hist = merge_shards(
            score, species, pos, n_species, top_percentage, highest_wins=True)
        i32 = lambda t: t.to(torch.int32).numpy()  # noqa: E731
        return DistAlignOut(i32(best), i32(best_shard), i32(best_pos), i32(score),
                            i32(species), kept.numpy(), i32(hist))

    return step
