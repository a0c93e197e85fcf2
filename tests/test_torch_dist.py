"""The port's candidate-position step (``megapath_tpu_torch.parallel.dist``)
against the JAX package's.

On ``chip_smoke.small_dist_world`` (``tests/test_parallel.py``'s world: 2
shards of 2,048 bp, 16 reads of 64 bp planted at their home shard, W 128;
then four edge rows) the JAX step runs once on ``make_mesh(8)`` (4 x 2 of
conftest's virtual devices), and the port's on 2 x 2 and 1 x 2 grids of
places on the one CPU (its plain DP): every ``DistAlignOut`` field equal,
with its dtype and shape; the JAX outputs equal the committed record
(``tests/fixtures/torch_spmd_records.json``). The edge rows: a read with no
hit (``best_shard`` S - 1, unmasked; ``best_pos`` -1), a tie at 64 across
both shards (the highest shard wins), and a best of 60 against 56 (one
below int(float32(0.95) * float32(60)) = 57, dropped) and against 57
(kept). Every check is exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fixtures import make_torch_spmd_records as rec
from megapath_tpu_torch.parallel import dist, spmd
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIX = pathlib.Path(__file__).parent / "fixtures"
GRIDS = {"2x2": 4, "1x2": 2}
KEYS = ("ref_shards", "seq_offsets", "seq_species")


@pytest.fixture(scope="module")
def world():
    return cs.small_dist_world()


@pytest.fixture(scope="module")
def jax_out():
    """The JAX step (one compile)."""
    return rec.jax_dist_out()


@pytest.fixture(scope="module")
def port_runs(world):
    out = {}
    for grid, n in GRIDS.items():
        mesh = dist.make_mesh(n, devices=[CPU] * n)
        inputs = dist.shard_arrays(mesh, **{k: world[k] for k in KEYS})
        step = dist.build_dist_align_step(mesh, width=world["width"],
                                          n_species=world["n_species"])
        out[grid] = step(inputs, world["reads"], world["read_lens"], world["cand_pos"]), mesh
    return out


def test_reference_outputs_equal_the_record(jax_out):
    want = json.loads((FIX / "torch_spmd_records.json").read_text())["small"]
    assert cs.small_worlds_digest() == want["input_sha256"], "numpy's generator drifted"
    assert cs.out_record(jax_out) == want["dist"]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("field", dist.DistAlignOut._fields)
def test_step_fields_equal_the_reference(jax_out, port_runs, grid, field):
    got = getattr(port_runs[grid][0], field)
    want = np.asarray(getattr(jax_out, field))
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_planted_reads_win_at_home(port_runs, world, grid):
    """``tests/test_parallel.py``'s reading of its 16 planted rows."""
    out = port_runs[grid][0]
    home = world["home"]
    B = len(home)
    assert (out.best_score[:B] == 64).all()
    np.testing.assert_array_equal(out.best_shard[:B], home)
    assert out.kept[np.arange(B), home].all()


@pytest.mark.parametrize("grid", list(GRIDS))
def test_edge_rows(port_runs, grid):
    """No hit: best_shard S - 1 (not masked), best_pos -1. A tie: the
    highest shard. 60 against 56: dropped; against 57: kept. A float64
    product of the float32 ratio gives 56 and would keep the first."""
    out = port_runs[grid][0]
    assert out.all_scores[16:].tolist() == [[0, 0], [64, 64], [60, 56], [60, 57]]
    assert out.best_shard[16:].tolist() == [1, 1, 0, 0]
    assert out.best_pos[16] == -1 and out.best_score[16] == 0
    assert out.kept[16:].tolist() == [[False, False], [True, True], [True, False],
                                      [True, True]]
    assert int(np.float32(0.95) * np.int32(60)) == 56
    assert int(spmd.float32_floor(0.95, torch.tensor([60]))) == 57
    assert out.species_counts.sum() == 19  # every row but the one with no hit


def test_make_mesh(monkeypatch):
    assert dist.make_mesh(devices=[CPU] * 4).shape == {"data": 2, "shard": 2}
    assert dist.make_mesh(3, devices=[CPU] * 4).shape == {"data": 3, "shard": 1}
    assert dist.make_mesh(devices=[CPU]).shape == {"data": 1, "shard": 1}
    assert dist.make_mesh(4, shard_axis=4, devices=[CPU] * 4).shape == {"data": 1, "shard": 4}
    with pytest.raises(ValueError, match="do not split"):
        dist.make_mesh(3, shard_axis=2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="5 devices asked for, 4 given"):
        dist.make_mesh(5, devices=[CPU] * 4)
    # the default grid is every visible card; with none it raises
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.make_mesh()


def test_a_shard_goes_to_a_device_once(world):
    mesh = dist.make_mesh(8, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "shard": 2}
    inputs = dist.shard_arrays(mesh, **{k: world[k] for k in KEYS})
    assert len(inputs.placed) == 2
    for s in range(2):
        assert len({id(row[s]) for row in inputs.cells}) == 1
    with pytest.raises(ValueError, match="3 shard rows for a grid of 2"):
        dist.shard_arrays(mesh, ref_shards=np.zeros((3, 16), np.uint8),
                          seq_offsets=np.zeros((3, 2), np.int32),
                          seq_species=np.zeros((3, 1), np.int32))
