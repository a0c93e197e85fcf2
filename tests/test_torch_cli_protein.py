"""The port's protein path through the command line against the JAX
package's, on the CPU: ``run -A --protein-db`` of ``chip_smoke.py``'s
phase-15 world part through both command lines (``--device cpu``, device
seeding: every file, stdout and stderr equal, and the committed record
``tests/fixtures/torch_protein_records.json`` that the card is held to),
the ``.assembly.done`` resume, ``--protein-db`` with and without ``-A``,
``--assembly`` and ``--megahit-bin`` (each run equal to the JAX CLI's), a
missing protein FASTA, and the record's inputs."""

import json
import pathlib

import pytest
import torch

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu_torch import cli
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")
MAINS = (("jax", jcli.main, ()), ("port", cli.main, ("--device", "cpu")))


@pytest.fixture(scope="module")
def want():
    return json.loads((FIX / "torch_protein_records.json").read_text())


# ---------------------------------------------------------------------------
# a small world: the world's NT index, 80 bp pairs tiling SARS-CoV-2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The world's NT FASTA through the JAX ``build-index`` (either package
    loads it); a tiling of SARS-CoV-2's 1000-1700 as 80 bp pairs plus two
    pairs of HCoV-229E, whose genome the NT index holds; the world protein
    DB (``chip_smoke.protein_world_db``) as ``prot.fa``."""
    d = tmp_path_factory.mktemp("small")
    (d / "nt").mkdir()
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    cs.write_fasta(d / "nt.fa", world["nt"][0] + world["nt"][1])
    assert jcli.main(["build-index", str(d / "nt.fa"), str(d / "nt" / "nt"),
                      "--shard-bp", str(cs.WORLD_SHARD_BP), *cs.WORLD_INDEX_ARGS]) == 0
    g = next(c for n, _, c in world["nt"][1] if n == "NC_045512.1")
    rows = [(f"v{i}", cs._text(g[p : p + 80]), cs._text(cs._COMP[g[p + 220 : p + 300][::-1]]))
            for i, p in enumerate(range(1000, 1400, 10))]
    rows += [(n, a[:80], b[:80]) for n, a, _, b, _ in world["pairs"]
             if n in ("NC_002645.1_0", "NC_002645.1_1")]
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for name, a, b in rows:
            f1.write(f"@{name}/1\n{a}\n+\n{'I' * 80}\n")
            f2.write(f"@{name}/2\n{b}\n+\n{'I' * 80}\n")
    cs.write_protein_fasta(d / "prot.fa", cs.protein_world_db(world))
    return d


def _small_argv(d, prefix, *flags):
    return ["run", "-1", str(d / "r1.fq"), "-2", str(d / "r2.fq"), "-p", str(prefix),
            "--nt-index", str(d / "nt" / "shard0"), str(d / "nt" / "shard1"), "--nodes",
            str(FIX / "nodes.dmp"), "--names", str(FIX / "names.dmp"), "--acc2tid",
            str(FIX / "acc2tid.map"), "-L", "80", "--skip-preprocess", *flags]


def _run_both(small, tmp_path, capsys, *flags) -> dict:
    """``run`` with ``flags`` through both command lines, each in its own
    directory; every file each wrote, its stdout and its stderr must be
    equal. Returns the port's files."""
    outs = {}
    for tag, main, extra in MAINS:
        d = tmp_path / tag
        d.mkdir()
        capsys.readouterr()
        assert main([*_small_argv(small, d / "run", *flags), *extra]) == 0
        out = capsys.readouterr()
        outs[tag] = (out.out.replace(str(d), "D"), cs.mask_clock(out.err).replace(str(d), "D"),
                     cs.run_outputs(d, "run"))
    assert outs["port"] == outs["jax"]
    return outs["port"][2]


@pytest.mark.parametrize("flags", [
    ("-A", "--protein-db"), ("--assembly", "--protein-db"),
    ("--megahit-bin", "megahit", "--protein-db"), ("--protein-db",),
], ids=["A", "assembly", "megahit_bin", "alone"])
def test_run_takes_the_protein_flags(small, tmp_path, capsys, flags):
    """The flags the port refused before the protein path was ported now
    run and write what the JAX CLI writes: with ``-A`` the three protein
    remap files besides the assembly's; without it (``--megahit-bin`` is
    then unused too) the files a plain ``run`` writes."""
    files = _run_both(small, tmp_path, capsys, *flags, str(small / "prot.fa"))
    if "-A" in flags or "--assembly" in flags:
        assert {".contigs.fa", ".r2c.lsam", *cs.PROTEIN_FILES} <= set(files)
        assert b"694009" in files[".nr.lsam.id"]  # the contig hits the SARS-CoV-2 homolog
    else:
        assert cli.main([*_small_argv(small, tmp_path / "plain"), "--device", "cpu"]) == 0
        assert files == cs.run_outputs(tmp_path, "plain")
        assert not set(files) & {".contigs.fa", *cs.PROTEIN_FILES}


def test_protein_remap_resume(small, tmp_path, capsys):
    """``run`` and then ``run -A --protein-db`` on one prefix write what one
    ``run -A --protein-db`` writes; with ``.assembly.done`` present stage 4,
    the protein remap included, is skipped and its outputs stay as they
    are. Both packages alike."""
    prot = str(small / "prot.fa")
    for tag, main, extra in MAINS:
        fresh, resumed = tmp_path / f"{tag}_fresh", tmp_path / f"{tag}_resumed"
        assert main([*_small_argv(small, fresh, "-A", "--protein-db", prot), *extra]) == 0
        assert main([*_small_argv(small, resumed), *extra]) == 0
        assert main([*_small_argv(small, resumed, "-A", "--protein-db", prot), *extra]) == 0
        assert "Skipping alignment" in capsys.readouterr().err
        for suf in (".contigs.fa", ".r2c.lsam", *cs.PROTEIN_FILES):
            got = pathlib.Path(f"{resumed}{suf}").read_bytes()
            assert got and got == pathlib.Path(f"{fresh}{suf}").read_bytes(), suf
        pathlib.Path(f"{resumed}.nr.report").write_text("kept\n")
        assert main([*_small_argv(small, resumed, "-A", "--protein-db", prot), *extra]) == 0
        assert pathlib.Path(f"{resumed}.nr.report").read_text() == "kept\n"
    for suf in cs.PROTEIN_FILES:
        assert (tmp_path / f"port_fresh{suf}").read_bytes() == \
            (tmp_path / f"jax_fresh{suf}").read_bytes()


def test_a_missing_protein_fasta_raises_as_in_jax(small, tmp_path):
    for _, main, extra in MAINS:
        with pytest.raises(FileNotFoundError):
            main([*_small_argv(small, tmp_path / "x", "-A", "--protein-db",
                               str(tmp_path / "missing.fa")), *extra])


# ---------------------------------------------------------------------------
# phase 15's world part through both command lines
# ---------------------------------------------------------------------------
def test_run_A_protein_db_on_the_world_equals_jax_and_the_record(tmp_path_factory, want,
                                                                  capsys):
    """``run -A --protein-db`` of the world plus the SARS-CoV-2 tiling with
    the world protein DB, on device seeding, through both command lines:
    every output file, stdout and stderr equal; the three protein files
    non-empty and, with the assembly's files and the reports, equal to
    phase 15's record."""
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    outs = {}
    for tag, main, extra in MAINS:
        d = tmp_path_factory.mktemp(f"protein_{tag}")
        cs.write_asm_files(world, d)
        cs.write_protein_files(world, d)
        for argv in cs.world_build_argvs(d):
            assert main([*argv, *extra]) == 0
        capsys.readouterr()
        rec = cs.protein_world_record(main, d, extra)
        out = capsys.readouterr()
        outs[tag] = (out.out.replace(str(d), "D"), cs.mask_clock(out.err).replace(str(d), "D"),
                     cs.run_outputs(d, "protein_world"))
        for suf in cs.PROTEIN_FILES:
            assert (d / f"protein_world{suf}").read_bytes(), suf
        assert rec == {k: want["world"][k] for k in rec}
    assert outs["port"] == outs["jax"]


def test_protein_record_inputs(want):
    """The record's inputs are what ``chip_smoke`` draws today: the world
    and realistic protein DBs and the ac-diamond fixture hash to its
    digests; the realistic DB holds 300 proteins of 100-300 aa, the four
    planted homologs among them; both parts found hits."""
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    assert cs.protein_digests(world) == {k: want[k] for k in (
        "world_db_sha256", "realistic_db_sha256", "acd_sha256")}
    db = cs.protein_realistic_db(cs.asm_realistic_workload()[0])
    assert len(db) == 300
    assert all(100 <= len(s) <= 300 for _, s in db)
    assert [n for n, _ in db if not n.startswith("decoy")] == [
        n for n, *_ in cs.PROT_REAL_PLANTS]
    for part in ("world", "realistic"):
        assert want[part]["nr_lsam_id"] and want[part]["r2g_lines"]
    assert cs.acd_problems(want["acd"]) == []
