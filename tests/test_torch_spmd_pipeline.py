"""The port's one-program backend in the pipeline and the command line
(``PipelineConfig(spmd=True)``, ``run --spmd``) against the JAX package's
and against the port's host-orchestrated path.

On the CPU, ``devices`` are places on the one CPU: the real-soap4 cascade
(two shards) on a 2 x 2 grid against the golden report and records and the
JAX backend's payload on a 2 x 2 mesh of conftest's virtual devices;
``tests/test_spmd_full.py``'s 24 junk pairs against the host path; a
forced escalation (``LEAN_CAPS`` too small: ``lean`` overflows, ``robust``
serves the batch, the next batches start at ``robust``) through
``run_files`` over three batches, byte-equal to the host path; the
refusal of more shards than devices; and ``run --spmd --device cpu
--devices 4`` on the world's files against the JAX CLI's ``run --spmd``
record (``tests/fixtures/torch_spmd_records.json``, written by
``tests/fixtures/make_torch_spmd_records.py``). Every check is exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu_torch import cli
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import pack_fasta_file
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.parallel import spmd_full as sf
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIX = pathlib.Path(__file__).parent / "fixtures"
CAS = FIX / "cascade"
OUTPUTS = (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")


def _config(spmd: bool, device_seeding: bool = False) -> PipelineConfig:
    return PipelineConfig(read_len=80, max_read_len=80, skip_preprocess=True,
                          skip_human=True, spmd=spmd, device_seeding=device_seeding)


@pytest.fixture(scope="module")
def cascade_shards():
    def shard(path):
        ref = pack_fasta_file(path)
        return ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)

    return [shard(CAS / "shard0.fa"), shard(CAS / "shard1.fa")]


def _pipe(shards, spmd=True, devices=None, device_seeding=False):
    return MegaPathPipeline(shards, cs.mini_taxdb(), config=_config(spmd, device_seeding),
                            devices=devices, device=CPU)


@pytest.fixture(scope="module")
def cascade_runs(cascade_shards):
    """The cascade through the port's backend on a 2 x 2 grid and through
    the JAX backend on a 2 x 2 mesh."""
    import jax

    from megapath_tpu.index.fm import build_fm_index as jbuild
    from megapath_tpu.index.pack import pack_fasta_file as jpack
    from megapath_tpu.io.fastq import read_fastx as jread, trim_readno as jtrim
    from megapath_tpu.pipeline import MegaPathPipeline as JPipeline
    from megapath_tpu.pipeline import PipelineConfig as JConfig
    from megapath_tpu.taxonomy import TaxDB as JTaxDB

    recs = cs.cascade_reads()
    pipe = _pipe(cascade_shards, devices=[CPU] * 4)
    res = pipe.run_records(*recs)

    jshards = []
    for i in (0, 1):
        ref = jpack(CAS / f"shard{i}.fa")
        jshards.append((ref, jbuild(ref.codes, sa_interval=8, lut_k=8)))
    jdb = JTaxDB(size=1024)
    jdb.read_nodes(FIX / "nodes.dmp")
    jdb.read_names(FIX / "names.dmp")
    jdb.read_acc2tid(FIX / "acc2tid.map")
    jrecs = [list(jread(CAS / f"r{e}.fq")) for e in (1, 2)]
    for r in jrecs[0] + jrecs[1]:
        r.name = jtrim(r.name)
    jcfg = JConfig(read_len=80, max_read_len=80, skip_preprocess=True, skip_human=True,
                   spmd=True)
    jpipe = JPipeline(jshards, jdb, config=jcfg, devices=jax.devices()[:4])
    jres = jpipe.run_records(*jrecs)
    return pipe, res, jpipe, jres


def test_cascade_report_equals_the_golden(cascade_runs):
    pipe, res, _, jres = cascade_runs
    assert pipe._spmd["mesh"].shape == {"data": 2, "shard": 2}
    assert res.report == (CAS / "cascade.report").read_text() == jres.report
    assert res.ra_report == jres.ra_report


def test_cascade_per_read_records(cascade_runs):
    _, res, _, jres = cascade_runs
    golden = cs.lsam_id_table(open(CAS / "cascade.lsam.id"))
    ours = cs.lsam_id_table(r.to_line() for r in res.lsam_id)
    assert ours == golden
    assert [r.to_line() for r in res.lsam_id] == [r.to_line() for r in jres.lsam_id]


def test_cascade_payload_equals_the_jax_backend(cascade_runs):
    pipe, _, jpipe, _ = cascade_runs
    assert pipe._spmd["payload"] == jpipe._spmd["payload"]
    assert pipe._spmd["payload"]["hit_rows"] > 0
    # both served by the lean caps (the JAX ladder's first level holds them too)
    assert pipe._spmd["level"] == "lean" and pipe._spmd["tried"] == ["lean"]
    assert jpipe._spmd["ladder_start"] == {(256, 80): 0}


def test_no_pool_and_engines_hold_only_their_text(cascade_runs):
    """On host seeding the rescue engines hold the grid's packed text of
    their device and no copy of their own."""
    pipe, _, _, _ = cascade_runs
    assert pipe._pool is None and not pipe._wave_shards
    for s, eng in enumerate(pipe.nt_engines):
        placed = pipe._spmd["inputs"].placed[(s, str(eng.device))]
        assert eng._ref_words_dev is placed.ref_words and eng.dfm is None
        assert eng._host_words is None
    assert len(pipe._spmd["inputs"].placed) == 2


@pytest.mark.parametrize("device_seeding", [False, True])
def test_junk_batch_gives_the_host_paths_report(cascade_shards, device_seeding):
    """test_spmd_full's 24 random pairs: every species at 0, and the report
    of the host path, whichever level serves the batch. The rescue engines
    (every pair goes through the exact rescue) hold the grid's packed text
    of their device and, on device seeding, its tables, not a copy."""
    rng = np.random.default_rng(44)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs1, recs2 = [], []
    for i in range(24):
        for recs in (recs1, recs2):
            recs.append(FastqRecord(f"junk{i}", decode[rng.integers(0, 4, 80)].tobytes().decode(),
                                    "I" * 80))
    pipe = _pipe(cascade_shards, devices=[CPU] * 2, device_seeding=device_seeding)
    for s, eng in enumerate(pipe.nt_engines):
        placed = pipe._spmd["inputs"].placed[(s, "cpu")]
        assert (eng.dfm is placed.dfm) == device_seeding
        assert eng._ref_words_dev is placed.ref_words
    res = pipe.run_records(recs1, recs2)
    want = _pipe(cascade_shards, spmd=False, device_seeding=device_seeding).run_records(
        recs1, recs2)
    assert pipe._spmd["level"] in ("lean", "robust")
    assert res.report == want.report and res.ra_report == want.ra_report
    assert "unclassified" in res.report
    species = [line for line in res.report.splitlines() if line.split("\t")[3] == "S"]
    assert all(int(line.split("\t")[1]) == 0 for line in species)


@pytest.fixture(scope="module")
def escalated_files(cascade_shards, tmp_path_factory):
    """The cascade's pairs 29 times over (3,915 pairs) as FASTQ, through
    ``run_files`` in 3 batches of 1,305 against the cascade's first shard
    on one place, with ``LEAN_CAPS`` at the 1,024-row floor (too small for
    1,305 pairs' hits), and through the host path."""
    d = tmp_path_factory.mktemp("spmd_files")
    recs = cs.cascade_reads()
    for e in (0, 1):
        with open(d / f"r{e + 1}.fq", "w") as f:
            for k in range(29):
                for r in recs[e]:
                    f.write(f"@{r.name}_{k}\n{r.seq}\n+\n{r.qual}\n")
    tiny = sf.SpmdCaps(*([0.01] * len(sf.SpmdCaps._fields)))
    pipe = _pipe(cascade_shards[:1], devices=[CPU])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sf, "LEAN_CAPS", tiny)
        pipe.run_files(d / "r1.fq", d / "r2.fq", str(d / "spmd"), batch_size=1305)
    _pipe(cascade_shards[:1], spmd=False).run_files(d / "r1.fq", d / "r2.fq", str(d / "host"),
                                                batch_size=1305)
    return d, pipe


def test_forced_escalation_lean_then_robust(escalated_files):
    """The first batch overflows ``lean`` and ``robust`` serves it; the
    next batches of that shape start at ``robust``."""
    _, pipe = escalated_files
    sp = pipe._spmd
    assert sp["tried"] == ["lean", "robust", "robust", "robust"]
    assert sp["level"] == "robust" and sp["ladder_start"] == {(1536, 80): 1}


@pytest.mark.parametrize("suffix", OUTPUTS)
def test_run_files_three_batches_equal_the_host_path(escalated_files, suffix):
    d, _ = escalated_files
    assert (d / f"spmd{suffix}").read_bytes() == (d / f"host{suffix}").read_bytes()


@pytest.mark.parametrize("devices", [None, [CPU]], ids=["default", "one"])
def test_more_shards_than_devices_raise(cascade_shards, devices):
    with pytest.raises(ValueError, match=r"spmd backend needs >= 2 devices for 2 shards "
                                         r"\(got 1\); use the host path or fewer shards"):
        _pipe(cascade_shards, devices=devices)


def test_cli_run_spmd_equals_the_jax_cli(tmp_path):
    """``run --spmd -b --device cpu --devices 4`` on the world's files (a
    2 x 2 grid for its two NT shards) against the JAX CLI's ``run --spmd
    -b``: both reports, both LSAM.id files and the BAM content."""
    want = json.loads((FIX / "torch_spmd_records.json").read_text())["world"]
    world = cs.world_workload(1)
    assert cs.pairs_digest(world["pairs"]) == want["input_sha256"]
    cs.write_world_files(world, tmp_path)
    for argv in cs.world_build_argvs(tmp_path):
        assert cli.main(argv + ["--device", "cpu"]) == 0
    prefix = str(tmp_path / "spmd")
    argv = cs.world_run_argv(tmp_path, prefix, True) + ["--spmd", "--device", "cpu",
                                                        "--devices", "4"]
    assert cli.main(argv) == 0
    assert cs.cli_record(prefix, n_shards=2) == want["spmd"]


@pytest.mark.parametrize("device,devices", [("cpu", "2"), ("cuda", "0")])
def test_cli_refuses_more_shards_than_devices_before_any_index(
        tmp_path, monkeypatch, device, devices):
    """Three shards over two places, and four shards over the one visible
    card, are refused before an index is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_load(prefix):
        raise AssertionError("an index was loaded")

    monkeypatch.setattr(cli, "load_shard", no_load)
    n = 3 if device == "cpu" else 4
    argv = ["run", "-1", "r1.fq", "-2", "r2.fq", "-p", str(tmp_path / "x"), "--nt-index",
            *[f"nt/shard{i}" for i in range(n)], "--nodes", "n", "--names", "m",
            "--acc2tid", "a", "--spmd", "--device", device, "--devices", devices]
    with pytest.raises(ValueError, match=f"spmd backend needs >= {n} devices for {n} shards"):
        cli.main(argv)
