"""The card's pipeline workloads, held to the JAX pipeline on the CPU.

``chip_smoke.world_workload`` (every stage at 2 x 250 bp) goes through the
port's and the JAX package's ``MegaPathPipeline`` at a reduced pair count
on both seeding paths; ``chip_smoke.e2e_workload`` draws what
``tools/e2e_eval.simulate`` writes; and the records that
``chip_smoke.py`` holds the card to (``tests/fixtures/
torch_pipeline_reports.json``) belong to the workloads drawn here.
"""

import importlib.util
import json
import pathlib

import pytest
import torch

import chip_smoke as cs
from megapath_tpu.io.fastq import read_fastx
from tools import e2e_eval
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _maker():
    """tests/fixtures/make_torch_pipeline_reports.py, which builds the JAX
    side of the world the way chip_smoke builds the port's."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_pipeline_reports", FIX / "make_torch_pipeline_reports.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device_seeding", [True, False])
def test_world_equals_jax_pipeline(device_seeding):
    """One pair of each kind: bbduk with the adapter table, the hg and
    ribo filters, two NT shards, mate rescue at W = 1152. Both reports,
    both LSAM.id texts and the counters are equal."""
    world = cs.world_workload(n=1)
    want = _maker().jax_world_record(1, device_seeding)
    res = cs.world_pipeline(world, torch.device("cpu"), device_seeding).run_records(
        *cs.fastq_records(world["pairs"]))
    got = cs.pipeline_record(res)
    assert cs.record_diff(got, want) == []
    c = got["counters"]
    # every filter removed something: lowc (bbduk), human, ribo
    assert c["n_input_pairs"] > c["n_after_preprocess"] > c["n_after_human"] > c["n_after_ribo"]


def test_fixture_records_belong_to_the_workloads():
    recs = json.loads((FIX / "torch_pipeline_reports.json").read_text())
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    assert cs.pairs_digest(world["pairs"]) == recs["world"]["input_sha256"]
    assert recs["world"]["device_seeding"]["counters"]["n_input_pairs"] == len(world["pairs"])
    _, pairs = cs.e2e_workload()
    e2e = recs["e2e"]
    assert cs.pairs_digest(pairs) == e2e["input_sha256"]
    assert e2e["counters"]["n_input_pairs"] == len(pairs) == e2e_eval.N_PAIRS
    # the card's realistic cell: the community followed by the human pairs
    # its hg stage keeps, each adding two unclassified read ends
    assert e2e["hg_kept"] == [f"hg{i:06d}" for i in cs.LARGE_HG_KEPT]
    kept = e2e["with_hg_kept"]
    assert kept["counters"]["n_input_pairs"] == len(pairs) + len(cs.LARGE_HG_KEPT)
    for k in ("report", "ra_report"):
        assert cs.taxon_rows(kept[k]) == cs.taxon_rows(e2e[k])
        u = [int(r.splitlines()[1].split("\t")[1]) for r in (kept[k], e2e[k])]
        assert u[0] - u[1] == 2 * len(cs.LARGE_HG_KEPT)


def test_e2e_draw_equals_e2e_eval_files(tmp_path, monkeypatch):
    """chip_smoke's in-memory community equals tools/e2e_eval.simulate's
    FASTA and FASTQ files (at a reduced size: the draw order is what is
    checked; the full size is held by the fixture's input digest)."""
    monkeypatch.setattr(e2e_eval, "N_PAIRS", 700)
    monkeypatch.setattr(e2e_eval, "GENOME_LEN", 20_000)
    fa, fq1, fq2, _ = e2e_eval.simulate(str(tmp_path))
    genomes, pairs = cs.e2e_workload(n_pairs=700, genome_len=20_000)
    assert [(r.name, r.seq) for r in read_fastx(fa)] == [
        (name, cs._text(g)) for name, g in genomes]
    files = [(a.name, a.seq, a.qual, b.seq, b.qual)
             for a, b in zip(read_fastx(fq1), read_fastx(fq2))]
    assert files == pairs
    e2e_eval.write_taxonomy(str(tmp_path))
    (tmp_path / "ours").mkdir()
    cs.write_e2e_taxonomy(tmp_path / "ours", len(genomes))
    for f in ("nodes.dmp", "names.dmp", "acc2tid.map"):
        assert (tmp_path / "ours" / f).read_text() == (tmp_path / f).read_text()
