"""The port's reduced one-program step (``megapath_tpu_torch.parallel.spmd``)
against the JAX package's.

On ``chip_smoke``'s small worlds (``tests/test_spmd.py``'s world of 2
shards, shard 1 cut by 500 bp so that the pad path runs; its 16 planted
pairs, 2 junk pairs and the pad rows; and the same world with three
fragments of shard 0 copied into shard 1, beside the 8 random pairs of
``tests/test_spmd.py``) the JAX step runs once a batch on conftest's 4 x 2
mesh, and the port's on 2 x 2 and 1 x 2 grids of places on the one CPU
(its plain walk, locate and DP): every ``SpmdAlignOut`` field equal, with
its dtype and shape, and ``spmd_report``'s bytes. The JAX outputs equal
the committed record (``tests/fixtures/torch_spmd_records.json``, which
``chip_smoke.py`` phase 19 (b) holds the card to). The edge world's rows
hold the float32 ``kept`` edge (160 against 151 dropped, against 152
kept) and a tie at 160 (the lowest shard). ``pad_and_index_shards`` gives
JAX's padded texts, ``true_n`` and FM arrays; the refusals are kept.
Every check is exact.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fixtures import make_torch_spmd_records as rec
from megapath_tpu_torch.align import seeding_dev
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.parallel import spmd
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIX = pathlib.Path(__file__).parent / "fixtures"
GRIDS = {"2x2": 4, "1x2": 2}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX step on both batches (two compiles)."""
    return rec.jax_spmd_runs()


@pytest.fixture(scope="module")
def worlds():
    world = cs.small_spmd_world()
    edge_world, edge_batch = cs.small_spmd_edge(world)
    return {"planted": (world, cs.small_spmd_planted(world)), "edge": (edge_world, edge_batch)}


def _port_step(world, batch, n_devices):
    fms, padded, true_n = spmd.pad_and_index_shards(
        world["codes"], sa_interval=cs.SPMD_SA_INTERVAL, lut_k=8, device=CPU)
    sfm, meta = spmd.stack_fms(fms)
    mesh = spmd.make_mesh_for([CPU] * n_devices)
    inputs = spmd.place_spmd_inputs(mesh, sfm, ref_codes=padded, true_n=true_n,
                                    seq_offsets=world["seq_offsets"],
                                    seq_species=world["seq_species"])
    step = spmd.build_spmd_engine_step(mesh, meta, cs.SPMD_L, world["n_species"],
                                       params=AlignParams(**cs.SPMD_PARAMS))
    r1, r2, lens = batch
    return step(inputs, r1, r2, lens, lens), mesh


@pytest.fixture(scope="module")
def port_runs(worlds):
    out = {}
    for tag, (world, batch) in worlds.items():
        for grid, n in GRIDS.items():
            out[tag, grid] = _port_step(world, batch, n)
    return out


def test_pad_and_index_shards_equal_the_reference(jax_runs, worlds):
    world, _ = worlds["planted"]
    fms, padded, true_n = spmd.pad_and_index_shards(
        world["codes"], sa_interval=cs.SPMD_SA_INTERVAL, lut_k=8, device=CPU)
    want = jax_runs["planted"]
    assert padded.dtype == want["padded"].dtype and true_n.dtype == want["true_n"].dtype
    np.testing.assert_array_equal(padded, want["padded"])
    np.testing.assert_array_equal(true_n, want["true_n"])
    assert true_n.tolist() == [9000, 8500]
    for got, jfm in zip(fms, want["fms"]):
        for f in dataclasses.fields(tfm.FMIndex):
            a, b = getattr(got, f.name), getattr(jfm, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


def test_reference_outputs_equal_the_record(jax_runs):
    """The JAX step's outputs and report are the committed record's (the
    record that phase 19 (b) holds the card to), on inputs whose digest is
    the record's."""
    want = json.loads((FIX / "torch_spmd_records.json").read_text())["small"]
    assert cs.small_worlds_digest() == want["input_sha256"], "numpy's generator drifted"
    assert cs.out_record(jax_runs["planted"]["out"]) == {
        k: v for k, v in want["spmd"]["planted"].items() if k != "report"}
    assert jax_runs["report"] == want["spmd"]["planted"]["report"]
    assert cs.out_record(jax_runs["edge"]["out"]) == want["spmd"]["edge"]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("tag", ["planted", "edge"])
@pytest.mark.parametrize("field", spmd.SpmdAlignOut._fields)
def test_step_fields_equal_the_reference(jax_runs, port_runs, tag, grid, field):
    got = getattr(port_runs[tag, grid][0], field)
    want = np.asarray(getattr(jax_runs[tag]["out"], field))
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_report_bytes_equal_the_reference(jax_runs, port_runs, worlds, grid):
    lens = worlds["planted"][1][2]
    got = spmd.spmd_report(port_runs["planted", grid][0], cs.SPMD_TIDS, cs.mini_taxdb(),
                           lens, lens)
    assert got == jax_runs["report"]
    # tests/test_spmd.py's reading: 2 junk + 2 pad pairs unclassified, 32 lines classified
    assert "\t8\t8\tU\t0\t" in got and "\t32\t0\t-\t1\t" in got


def test_grids_are_as_asked(port_runs):
    assert port_runs["planted", "2x2"][1].shape == {"data": 2, "shard": 2}
    assert port_runs["planted", "1x2"][1].shape == {"data": 1, "shard": 2}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_float32_kept_edge_and_lowest_shard_tie(port_runs, grid):
    """The edge pairs (rows 8-10): a best of 160 with shard 1 at 151 (one
    below int(float32(0.95) * float32(160)) = 152, dropped) and at 152
    (kept), and an exact copy (a tie at 160: the lowest shard wins). A
    product of the float32 ratio taken in float64, as numpy promotes it,
    gives 151 and would keep the first."""
    out = port_runs["edge", grid][0]
    assert out.all_scores[8:11].tolist() == [[160, 151], [160, 152], [160, 160]]
    assert out.kept[8:11].tolist() == [[True, False], [True, True], [True, True]]
    assert out.best_shard[8:11].tolist() == [0, 0, 0]
    assert int(np.float32(0.95) * np.int32(160)) == 151
    assert int(spmd.float32_floor(0.95, torch.tensor([160]))) == 152
    # the random pairs and the pad row pair nowhere
    assert (out.best_score[:8] == 0).all() and out.best_shard[[*range(8), 11]].tolist() == [-1] * 9
    assert out.species_counts.tolist() == [3, 0, 0, 0, 0, 0]


def test_stack_fms_refusals(worlds):
    world, _ = worlds["planted"]
    a = tfm.build_fm_index(world["codes"][0], sa_interval=8, lut_k=8, device=CPU)
    b = tfm.build_fm_index(world["codes"][1], sa_interval=8, lut_k=8, device=CPU)
    with pytest.raises(ValueError, match="share a text length.*pad_and_index_shards"):
        spmd.stack_fms([a, b])
    c = tfm.build_fm_index(world["codes"][0], sa_interval=4, lut_k=8, device=CPU)
    with pytest.raises(ValueError, match="build parameters differ"):
        spmd.stack_fms([a, c])
    sfm, meta = spmd.stack_fms([a, seeding_dev.HostFM.pack(a)])
    assert meta == spmd.FMMeta(n=9000, lut_k=8, sa_interval=8)
    assert spmd.FMMeta._fields == ("n", "lut_k", "sa_interval")


def test_mesh_and_placement_refusals(worlds):
    with pytest.raises(ValueError, match="need at least 2 devices for 2 shards"):
        spmd.make_mesh_for([CPU])
    assert spmd.make_mesh_for([CPU] * 5).shape == {"data": 2, "shard": 2}
    world, (r1, r2, lens) = worlds["planted"]
    fms, padded, true_n = spmd.pad_and_index_shards(world["codes"], sa_interval=8, lut_k=8,
                                                    device=CPU)
    sfm, meta = spmd.stack_fms(fms)
    mesh = spmd.make_mesh_for([CPU] * 2)
    kw = dict(true_n=true_n, seq_offsets=world["seq_offsets"], seq_species=world["seq_species"])
    with pytest.raises(ValueError, match="its tables cover 9000"):
        spmd.place_spmd_inputs(mesh, sfm, ref_codes=padded[:, :-1], **kw)
    inputs = spmd.place_spmd_inputs(mesh, sfm, ref_codes=padded, **kw)
    wrong = spmd.build_spmd_engine_step(mesh, meta._replace(sa_interval=4), cs.SPMD_L, 6)
    with pytest.raises(ValueError, match="the step's meta"):
        wrong(inputs, r1, r2, lens, lens)
    step = spmd.build_spmd_engine_step(mesh, meta, cs.SPMD_L, 6)
    with pytest.raises(ValueError, match="D \\* Bl rows"):
        step(inputs, r1[:, :-1], r2[:, :-1], lens, lens)


def test_without_a_card_it_raises(monkeypatch, worlds):
    """The entry points run on the card unless given CPU devices; with no
    card they raise and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world, _ = worlds["planted"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spmd.pad_and_index_shards(world["codes"])


def test_a_shard_goes_to_a_device_once(worlds, monkeypatch):
    """[cpu] * 8 over 2 shards: a 4 x 2 grid whose cells all share one
    place; each shard's tables are uploaded once and every cell of its
    column holds that one copy; a ``DeviceFM`` already there is not
    copied."""
    world, _ = worlds["planted"]
    fms, padded, true_n = spmd.pad_and_index_shards(world["codes"], sa_interval=8, lut_k=8,
                                                    device=CPU)
    sfm, _ = spmd.stack_fms(fms)
    uploads = []
    orig = seeding_dev.HostFM.upload
    monkeypatch.setattr(seeding_dev.HostFM, "upload",
                        lambda self, dev: uploads.append(dev) or orig(self, dev))
    mesh = spmd.make_mesh_for([CPU] * 8)
    assert mesh.shape == {"data": 4, "shard": 2}
    inputs = spmd.place_spmd_inputs(mesh, sfm, ref_codes=padded, true_n=true_n,
                                    seq_offsets=world["seq_offsets"],
                                    seq_species=world["seq_species"])
    assert len(uploads) == 2 and len(inputs.placed) == 2
    for s in range(2):
        assert len({id(row[s]) for row in inputs.cells}) == 1
    assert inputs.cells[0][1].text.shape[0] == 8500
    dfm = inputs.cells[0][0].dfm
    assert spmd.table_on(dfm, CPU).rows is dfm.rows
