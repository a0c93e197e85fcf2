"""The port's assembly stage (``run_files(assembly=True)``, ``run -A``)
against the JAX package's, on the CPU: the twin of
``tests/test_pipeline.py:216``, both command lines on the world part of
``chip_smoke.py``'s phase 14 (every output file, stdout and stderr, and
the committed record ``tests/fixtures/torch_asm_records.json`` that the
card is held to), the ``.assembly.done`` resume, ``--megahit-bin``
through a stub executable, and ``run_files(protein_db=)`` (the protein
remap, stage 4.1) in process."""

import json
import pathlib
import stat
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu.classify.protein import ProteinDB as JProteinDB
from megapath_tpu.index.fm import build_fm_index as jbuild_fm_index
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu.pipeline import MegaPathPipeline as JPipeline
from megapath_tpu.pipeline import PipelineConfig as JConfig
from megapath_tpu_torch import cli
from megapath_tpu_torch.classify.protein import ProteinDB
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")
MAINS = (("jax", jcli.main, ()), ("port", cli.main, ("--device", "cpu")))
ASM_FILES = (".contigs.fa", ".r2c.lsam")


@pytest.fixture(scope="module")
def want():
    return json.loads((FIX / "torch_asm_records.json").read_text())


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's world (seed 123) and its SARS-CoV-2 tiling
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    w = cs.world_workload(n=0)

    def entries(shard):
        return [(n, cs._text(c), d) for n, d, c in shard]

    def shard(es):
        ref = pack_fasta([FastqRecord(n, s, "", d) for n, s, d in es])
        return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)

    def jshard(es):
        ref = jpack_fasta([JRecord(n, s, "", d) for n, s, d in es])
        return ref, jbuild_fm_index(ref.codes, sa_interval=4, lut_k=6)

    return {"nt": [shard(entries(s)) for s in w["nt"]],
            "jnt": [jshard(entries(s)) for s in w["nt"]], "raw": w,
            "sars": next(c for n, _, c in w["nt"][1] if n == "NC_045512.1")}


def _tiling(codes, tmp_path, extra: int = 0):
    """``tests/test_pipeline.py:226-237``'s reads: 80 bp pairs, insert 300,
    a start every 10 bp over 1000-1400, plus ``extra`` random pairs; as
    two FASTQ files with /1 and /2 names."""
    rows = [(f"v{i}", cs._text(codes[p : p + 80]),
             cs._text(cs._COMP[codes[p + 220 : p + 300][::-1]]))
            for i, p in enumerate(range(1000, 1400, 10))]
    rng = np.random.default_rng(8)
    rows += [(f"junk{i}", cs._text(rng.integers(0, 4, 80).astype(np.uint8)),
              cs._text(rng.integers(0, 4, 80).astype(np.uint8))) for i in range(extra)]
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for name, a, b in rows:
            f1.write(f"@{name}/1\n{a}\n+\n{'I' * 80}\n")
            f2.write(f"@{name}/2\n{b}\n+\n{'I' * 80}\n")
    return str(p1), str(p2)


@pytest.mark.parametrize("device_seeding", [False, True])
def test_assembly_stage_writes_outputs(world, mini_taxdb, tmp_path, device_seeding):
    """``run_files(assembly=True)`` writes the contigs and the r2c LSAM
    byte-identical to the JAX pipeline's."""
    p1, p2 = _tiling(world["sars"], tmp_path, extra=3)
    kw = dict(read_len=80, skip_preprocess=True, skip_human=True, device_seeding=device_seeding)
    MegaPathPipeline(world["nt"], cs.mini_taxdb(), config=PipelineConfig(**kw),
                     device=CPU).run_files(p1, p2, str(tmp_path / "port"), assembly=True)
    JPipeline(world["jnt"], mini_taxdb, config=JConfig(**kw)).run_files(
        p1, p2, str(tmp_path / "jax"), assembly=True)
    assert (tmp_path / "port.assembly.done").exists()
    contigs = (tmp_path / "port.contigs.fa").read_text()
    assert contigs.startswith(">ctg0")
    assert len(contigs.splitlines()[1]) >= 100
    for suf in ASM_FILES:
        assert (tmp_path / f"port{suf}").read_bytes() == (tmp_path / f"jax{suf}").read_bytes()
    assert len((tmp_path / "port.r2c.lsam").read_text().splitlines()) >= 40


# ---------------------------------------------------------------------------
# the command line on a small index: the world's NT, 80 bp pairs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small(world, tmp_path_factory):
    """The world's NT FASTA through the JAX ``build-index`` (either
    package loads it), and the tiling plus three random pairs as FASTQ."""
    d = tmp_path_factory.mktemp("small")
    (d / "nt").mkdir()
    cs.write_fasta(d / "nt.fa", world["raw"]["nt"][0] + world["raw"]["nt"][1])
    assert jcli.main(["build-index", str(d / "nt.fa"), str(d / "nt" / "nt"),
                      "--shard-bp", str(cs.WORLD_SHARD_BP), *cs.WORLD_INDEX_ARGS]) == 0
    p1, p2 = _tiling(world["sars"], d, extra=3)
    return d, p1, p2


def _small_argv(small, prefix, *flags):
    d, p1, p2 = small
    return ["run", "-1", p1, "-2", p2, "-p", str(prefix), "--nt-index",
            str(d / "nt" / "shard0"), str(d / "nt" / "shard1"), "--nodes",
            str(FIX / "nodes.dmp"), "--names", str(FIX / "names.dmp"), "--acc2tid",
            str(FIX / "acc2tid.map"), "-L", "80", "--skip-preprocess", *flags]


def test_assembly_done_resume(small, tmp_path, capsys):
    """``run`` and then ``run -A`` on one prefix write what one ``run -A``
    writes; with ``.assembly.done`` present the stage is skipped and its
    outputs stay as they are. Both packages alike."""
    for tag, main, extra in MAINS:
        fresh, resumed = tmp_path / f"{tag}_fresh", tmp_path / f"{tag}_resumed"
        assert main([*_small_argv(small, fresh, "-A"), *extra]) == 0
        assert main([*_small_argv(small, resumed), *extra]) == 0
        assert not pathlib.Path(f"{resumed}.contigs.fa").exists()
        assert main([*_small_argv(small, resumed, "-A"), *extra]) == 0
        assert "Skipping alignment" in capsys.readouterr().err
        for suf in ASM_FILES:
            got = pathlib.Path(f"{resumed}{suf}").read_bytes()
            assert got and got == pathlib.Path(f"{fresh}{suf}").read_bytes()
        pathlib.Path(f"{resumed}.contigs.fa").write_text("kept\n")
        assert main([*_small_argv(small, resumed, "-A"), *extra]) == 0
        assert pathlib.Path(f"{resumed}.contigs.fa").read_text() == "kept\n"
    for suf in ASM_FILES:
        assert (tmp_path / f"port_fresh{suf}").read_bytes() == \
            (tmp_path / f"jax_fresh{suf}").read_bytes()


MEGAHIT_STUB = """#!{python}
# a stand-in for MEGAHIT: its contigs are the first reads of -1, each
# joined to its mate's reverse complement
import os, sys
a = sys.argv
r1, r2, out = a[a.index("-1") + 1], a[a.index("-2") + 1], a[a.index("-o") + 1]
assert a[1:3] == ["--presets", "meta-sensitive"], a
comp = str.maketrans("ACGT", "TGCA")
s1 = open(r1).read().split("\\n")[1::4]
s2 = open(r2).read().split("\\n")[1::4]
os.makedirs(out)
with open(os.path.join(out, "final.contigs.fa"), "w") as f:
    for i in range(0, min(len(s1), 12), 3):
        f.write(">k141_%d flag=1 multi=1.0 len=%d\\n%s\\n" % (i, 2 * len(s1[i]), s1[i] + s2[i].translate(comp)[::-1]))
"""


def test_megahit_bin_stub(small, tmp_path, capsys):
    """``run -A --megahit-bin`` calls the binary as the JAX package does
    (``--presets meta-sensitive -1 -2 -o``, then ``final.contigs.fa``):
    through a stub, both packages write the same files."""
    stub = tmp_path / "megahit"
    stub.write_text(MEGAHIT_STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    for tag, main, extra in MAINS:
        argv = _small_argv(small, tmp_path / tag, "-A", "--megahit-bin", str(stub))
        assert main([*argv, *extra]) == 0
    capsys.readouterr()
    contigs = (tmp_path / "port.contigs.fa").read_text()
    assert contigs.count(">ctg") == 4 and len(contigs.splitlines()[1]) == 160
    for suf in ASM_FILES:
        assert (tmp_path / f"port{suf}").read_bytes() == (tmp_path / f"jax{suf}").read_bytes()
    assert (tmp_path / "port.r2c.lsam").read_text()


@pytest.mark.parametrize("empty", [False, True], ids=["world_db", "empty_db"])
def test_run_files_protein_db_equals_jax(world, mini_taxdb, tmp_path, empty):
    """``run_files(assembly=True, protein_db=)`` writes the protein remap's
    three files byte-identical to the JAX pipeline's, beside the assembly's;
    an empty protein DB gives no NR hit and no genome in the r2g join."""
    p1, p2 = _tiling(world["sars"], tmp_path, extra=3)
    seqs = [] if empty else cs.protein_world_db(cs.world_workload(cs.WORLD_PAIRS_PER_KIND))
    kw = dict(read_len=80, skip_preprocess=True, skip_human=True)
    MegaPathPipeline(world["nt"], cs.mini_taxdb(), config=PipelineConfig(**kw),
                     device=CPU).run_files(p1, p2, str(tmp_path / "port"), assembly=True,
                                           protein_db=ProteinDB.build(seqs))
    JPipeline(world["jnt"], mini_taxdb, config=JConfig(**kw)).run_files(
        p1, p2, str(tmp_path / "jax"), assembly=True, protein_db=JProteinDB.build(seqs))
    for suf in (*ASM_FILES, *cs.PROTEIN_FILES):
        assert (tmp_path / f"port{suf}").read_bytes() == (tmp_path / f"jax{suf}").read_bytes()
    nr = (tmp_path / "port.nr.lsam.id").read_text()
    r2g = [ln.split("\t")[5] for ln in
           (tmp_path / "port.nt.unmap.r2g.lsam.id").read_text().splitlines()]
    assert r2g and (nr == "") == empty
    assert set(r2g) == {"*"}


# ---------------------------------------------------------------------------
# phase 14's world part through both command lines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def asm_world(tmp_path_factory):
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    d = {}
    for tag, main, extra in MAINS:
        d[tag] = tmp_path_factory.mktemp(f"asm_{tag}")
        cs.write_asm_files(world, d[tag])
        for argv in cs.world_build_argvs(d[tag]):
            assert main([*argv, *extra]) == 0
    return world, d


@pytest.mark.parametrize("device_seeding", [True, False])
def test_run_A_on_the_world_equals_jax_and_the_record(asm_world, want, capsys,
                                                      device_seeding):
    """``run -A`` of the world plus the tiling through both command lines:
    every output file, stdout and stderr equal; the contigs, the r2c
    LSAM, both reports and both LSAM.id files equal phase 14's record."""
    world, d = asm_world
    key = "device_seeding" if device_seeding else "host_seeding"
    capsys.readouterr()
    outs = {}
    for tag, main, extra in MAINS:
        assert main([*cs.asm_run_argv(d[tag], str(d[tag] / key), device_seeding),
                     *extra]) == 0
        out = capsys.readouterr()
        outs[tag] = (out.out.replace(str(d[tag]), "D"),
                     cs.mask_clock(out.err).replace(str(d[tag]), "D"), cs.run_outputs(d[tag], key))
    assert outs["port"] == outs["jax"]
    assert {".contigs.fa", ".r2c.lsam", ".assembly.done", ".done"} <= set(outs["port"][2])
    for tag in ("jax", "port"):
        assert cs.asm_record(str(d[tag] / key)) == want["world"][key]


def test_asm_record_inputs_and_measures(want):
    """The record's inputs are what ``chip_smoke`` draws today (the world
    part's and the realistic part's pairs hash to its digests), and its
    realistic assembly keeps its meaning: both viruses recovered, bbnorm
    tossing pairs, contigs and r2c lines on both seeding paths."""
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    assert cs.asm_digests(world) == {k: want[k] for k in ("world_input_sha256",
                                                           "realistic_input_sha256")}
    genomes, pairs = cs.asm_realistic_workload()
    assert len(pairs) == sum(n for _, _, n in cs.ASM_VIRUSES)
    assert sorted(genomes) == sorted(want["realistic"]["stats"]["recovery"])
    stats = want["realistic"]["stats"]
    assert min(stats["recovery"].values()) >= 0.9
    assert stats["kept_pairs"] < stats["extracted_pairs"]
    assert stats == cs.asm_stats(want["realistic"]["contigs_fa"], genomes,
                                 stats["extracted_pairs"], stats["kept_pairs"])
    for key in ("device_seeding", "host_seeding"):
        assert want["world"][key]["contigs_fa"].startswith(">ctg0")
        assert want["world"][key]["r2c_lines"] > 0
