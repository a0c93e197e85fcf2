"""The configuration ``nt1-2g`` (one shard of the port's default 2.0 Gbp)
and the two per-layer metrics its cell adds: the configuration's
arithmetic against the port's shard limits, its database drawn at its
own genome counts and partitions, a tiny world cut from its file alone
held to the plain reference, and the readers of ``step_rows_per_pair``
and ``table_commit_s`` on hand-made counters and on a CPU run's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from megapath_tpu_torch.index.shard import DEFAULT_SHARD_BP, MAX_SHARD_BP
from megapath_tpu_torch.parallel import spmd_full
from portbench import gen, spec
from portbench.metrics import step_rows_per_pair, table_commit_s
from portbench.run import Bench, is_correct

CPU = torch.device("cpu")
CONF = json.loads((spec.HERE / "configs" / "nt1-2g.json").read_text())
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NEW = ("step_rows_per_pair", "table_commit_s")


def write_2g_world(root: Path, pairs: int = 160) -> Path:
    """``nt1-2g.json`` cut to 30 kbp genomes, a fifth of its genomes in
    each of its five partitions (15 random, 5 strains: its 3 to 1), and
    the community mix cut to a few hundred pairs, written as files under
    ``root``; returns the BENCHMARK.json path. Cell: ``g1``."""
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    conf = json.loads(json.dumps(CONF))
    conf["database"].update(genome_bp=30000, n_random=15, n_strains=5)
    conf["batch_size"] = pairs
    conf["pipeline"]["max_read_len"] = 152
    conf["name"] = "tiny2g"
    conf.pop("limits", None)  # the harness's own limits
    (root / "portbench" / "configs" / "tiny2g.json").write_text(json.dumps(conf))
    mix = json.loads((spec.HERE / "traffic" / "community.json").read_text())
    mix.update(absent_genomes=2, pool_batches=2, sample_pairs=80)
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] = [{"name": "tiny2g", "source": "test", "file": "portbench/configs/tiny2g.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "g1", "config": "tiny2g", "traffic": "tiny", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def test_the_configuration_is_one_shard_of_the_ports_default_size():
    db = CONF["database"]
    n_genomes = db["n_random"] + db["n_strains"]
    assert n_genomes == 500 and db["genome_bp"] == 4_000_000
    assert n_genomes * db["genome_bp"] == DEFAULT_SHARD_BP <= MAX_SHARD_BP
    assert CONF["shard_bp"] == CONF["database_bp"] == DEFAULT_SHARD_BP and CONF["shards"] == 1
    # a strain for every three random genomes, as in nt1-512m
    small = json.loads((spec.HERE / "configs" / "nt1-512m.json").read_text())["database"]
    assert db["n_strains"] * small["n_random"] == db["n_random"] * small["n_strains"]
    entry = {c["name"]: c for c in BENCH["configs"]}["nt1-2g"]
    assert entry["file"] == "portbench/configs/nt1-2g.json"
    assert CONF["reduced"] == entry["reduced"] == ["shard_bp", "database_bp", "batch_size"]
    # a deployment of its own: its source names the part that defines it
    assert CONF["source"] == entry["source"]
    assert all(c["source"] != entry["source"] for c in BENCH["configs"] if c is not entry)
    assert set(CONF["from_source"]) == set(CONF["reduced"])
    cell = spec.load_cell("nt1-2g.community")
    assert cell.chips == 1 and cell.traffic["name"] == "community"
    assert {m["name"] for m in cell.end_to_end} == {"align_reads_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NEW)


def test_the_database_splits_into_its_partitions():
    """The configuration's own genome counts and partitions, each genome
    cut to 100 bp so the draw is small: 75 random genomes and 25 strains
    a partition, every strain in another partition than its original, and
    the community's rank pattern (an original, its strain, two random)."""
    db = dict(CONF["database"], genome_bp=100)
    g = gen.generator(2**31 + 21, CPU)
    d = gen.draw_database(db, CONF["shards"], 16, g, CPU)
    P = db["partitions"]
    assert d.n_db == 500 and len(d.shard_genomes) == 1 and len(d.shard_genomes[0]) == 500
    assert d.text.shape[0] == (500 + 16) * 100
    part = np.arange(d.n_db) // (d.n_db // P)
    strains = np.flatnonzero(d.strain_of >= 0)
    assert len(strains) == 125
    assert np.array_equal(np.bincount(part[strains], minlength=P), np.full(P, 25))
    assert (part[strains] != part[d.strain_of[strains]]).all()
    order = gen.rank_genomes(d, g).numpy()[: d.n_db]
    assert sorted(order) == list(range(d.n_db))
    kinds = np.where(d.strain_of[order] >= 0, 1, np.where(np.isin(order, d.strain_of), 0, 2))
    assert list(kinds[:8]) == [0, 1, 2, 2, 0, 1, 2, 2]


def test_a_tiny_world_cut_from_the_configuration_keeps_to_the_reference(tmp_path):
    path = write_2g_world(tmp_path)
    cell = spec.load_cell("g1", path, tmp_path)
    assert cell.config["database"]["partitions"] == 5
    b = Bench(cell, 2**31 + 2021, CPU)
    win = b.window(0, batches=len(b.pool))
    b.release()
    checks = b.checks(b.expected(), win)
    assert checks["compared_pairs"]["value"] == len(b.pool) * 40
    assert checks["rows_wrong"]["value"] == 0
    assert is_correct(checks), checks


def test_step_rows_per_pair_on_hand_made_counters(monkeypatch):
    assert step_rows_per_pair.per_pair(1_250_000, 100_000) == pytest.approx(12.5)
    assert step_rows_per_pair.per_pair(0, 0) is None
    monkeypatch.setattr(spmd_full, "step_rows", 900)
    monkeypatch.setattr(spmd_full, "step_pairs", 300)
    assert step_rows_per_pair.read({}) == pytest.approx(3.0)
    monkeypatch.setattr(spmd_full, "step_pairs", 0)
    assert step_rows_per_pair.read({}) is None
    monkeypatch.delattr(spmd_full, "step_pairs")  # a program without the counters
    assert step_rows_per_pair.read({}) is None


def test_table_commit_seconds_on_hand_made_counters(monkeypatch):
    assert table_commit_s.seconds(20_800.0, 900.0) == pytest.approx(21.7)
    assert table_commit_s.seconds(0.0, 0.0) is None
    monkeypatch.setattr(spmd_full, "pack_ms", 5_700.0)
    monkeypatch.setattr(spmd_full, "upload_ms", 300.0)
    assert table_commit_s.read({}) == pytest.approx(6.0)
    monkeypatch.delattr(spmd_full, "pack_ms")
    monkeypatch.delattr(spmd_full, "upload_ms")
    assert table_commit_s.read({}) is None


def test_a_run_of_the_tiny_world_feeds_both_metrics(tmp_path):
    """Set-up and a window of the tiny world move the program's counters
    as the readers expect: the placement's times once, and the step's
    rows and pairs for the warm batch and each batch of the window."""
    cell = spec.load_cell("g1", write_2g_world(tmp_path), tmp_path)
    pack0, up0 = spmd_full.pack_ms, spmd_full.upload_ms
    rows0, pairs0 = spmd_full.step_rows, spmd_full.step_pairs
    b = Bench(cell, 2**31 + 2022, CPU)
    commit = table_commit_s.seconds(spmd_full.pack_ms - pack0, spmd_full.upload_ms - up0)
    assert 0 < commit <= b.split["commit_pack"]
    b.window(0, batches=3)
    b.release()
    rows, pairs = spmd_full.step_rows - rows0, spmd_full.step_pairs - pairs0
    assert pairs == 4 * b.n  # the warm batch and three more
    assert step_rows_per_pair.per_pair(rows, pairs) > 1  # two ends, both strands, a seed or more
    for name in NEW:
        assert spec.metric_reader(name)({}) > 0, name
