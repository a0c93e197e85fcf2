"""``chip_smoke.py``'s db phase (phase 13) on the CPU: ``build-db`` of the
world's NT, UniVec and human FASTAs against the mini taxonomy, then
``run`` on its two shards on device seeding. The committed record
(``tests/fixtures/torch_db_records.json``), which the card is held to, is
what the JAX command line writes today; the port's command line with
``--device cpu`` writes the same: the curated FASTA, every member of every
shard file, both reports and both LSAM.id files."""

import json
import pathlib

import pytest

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu_torch import cli
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def want():
    return json.loads((FIX / "torch_db_records.json").read_text())


@pytest.mark.parametrize("package", ["jax", "port"])
def test_db_phase_record(want, package):
    got = (cs.db_records(jcli.main) if package == "jax"
           else cs.db_records(cli.main, ["--device", "cpu"]))
    assert got["input_sha256"] == want["input_sha256"]
    assert got["curated_sha256"] == want["curated_sha256"]
    assert got["shards"] == want["shards"]
    assert got["run"] == want["run"]


def test_db_record_covers_the_world(want):
    """Two shards; the excluded taxon is absent, the human sequence and the
    NT species that stay are classified."""
    assert sorted(want["shards"]) == sorted(f"shard{i}{s}" for i in range(cs.DB_SHARDS)
                                            for s in (".ref.npz", ".fm.npz"))
    report = want["run"]["report"]
    assert "Human coronavirus 229E" not in report
    for taxon in ("Escherichia coli", "Salmonella enterica", "Homo sapiens",
                  "Severe acute respiratory syndrome-related coronavirus"):
        assert taxon in report, taxon
