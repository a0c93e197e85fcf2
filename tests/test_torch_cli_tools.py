"""The port's command line (``megapath_tpu_torch.cli``) against the JAX
package's (``megapath_tpu.cli``) on the subcommands the earlier CLI
tests do not reach: ``build-db``, ``sam2cfq``, ``extract``,
``genomecov-filter``, ``m8-to-lsam``, ``r2c-to-r2g``, ``cleanup``,
``bbduk``, ``count-table``, ``m8-cov`` and ``maplen-hist``
(``amplicon`` is in ``tests/test_torch_cli_amplicon.py``). The twins of ``tests/test_cli.py``: both CLIs run on the
same files (or the same standard input, ``-``) and their standard output,
standard error and files must be byte-equal; the reference goldens are
checked where the JAX tests use one."""

import argparse
import io
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu_torch import cli
from megapath_tpu_torch.index import shard
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import PackedReference
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)
from test_torch_extras import random_lsam_pairs, random_m8

FIX = pathlib.Path(__file__).parent / "fixtures"
MAINS = (("port", cli.main), ("jax", jcli.main))


def _both(argv, capsys, monkeypatch, stdin=None, err=True):
    """Run ``argv`` through the port's CLI and then the JAX CLI; their
    standard outputs (and standard errors) must be equal. Returns the
    port's (stdout, stderr)."""
    outs = []
    for _, main in MAINS:
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        assert main(argv) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    if err:
        assert outs[0].err == outs[1].err
    return outs[0].out, outs[0].err


def _write(path: pathlib.Path, text: str) -> str:
    path.write_text(text)
    return str(path)


# ---------------------------------------------------------------------------
# the subcommand list and every flag
# ---------------------------------------------------------------------------
def _parsers(main) -> dict:
    """{subcommand: {(flags, dest, default, nargs, required, type)}} of a CLI."""
    grabbed = {}

    def grab(self, argv=None, namespace=None):
        grabbed["ap"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in grabbed["ap"]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {repr((a.option_strings, a.dest, a.default, a.nargs, a.required, a.type))
                   for a in p._actions} for name, p in sub.choices.items()}


def test_every_jax_subcommand_and_flag_exists():
    """The port's subcommands are the JAX CLI's, in its order, each with
    its flags and defaults (build-db's --lut-k 8 and build-index's 13
    among them); ``--device`` is the port's only addition."""
    port, jax = _parsers(cli.main), _parsers(jcli.main)
    assert list(port) == list(jax)
    device = repr((["--device"], "device", "cuda", None, False, None))
    for name in jax:
        assert port[name] - jax[name] == ({device} if name in ("build-index", "build-db", "run",
                                                               "amplicon")
                                          else set()), name
        assert jax[name] <= port[name], name
    for name, k in (("build-db", 8), ("build-index", 13)):
        assert repr((["--lut-k"], "lut_k", k, None, False, int)) in port[name]


# ---------------------------------------------------------------------------
# stream tools (tests/test_cli.py)
# ---------------------------------------------------------------------------
EXTRACT_LSAM = ("r1\t64\t50\tACGT\tIIII\t50,acc1\n"
                "r1\t128\t10\tTTAA\tIIII\t*\n"
                "r2\t64\t90\tACGT\tIIII\t90,acc1\n"
                "r2\t128\t95\tTTAA\tIIII\t95,acc1\n")


def test_extract_pairs(tmp_path, capsys, monkeypatch):
    out, _ = _both(["extract", "-t", "40", _write(tmp_path / "a.lsam", EXTRACT_LSAM)],
                   capsys, monkeypatch)
    # r1 selected (end 2 under cutoff), r2 fully mapped -> dropped
    assert "@r1/1" in out and "@r1/2" in out and "r2" not in out


def test_extract_fractional_threshold(tmp_path, capsys, monkeypatch):
    # pair len 8 -> cut = 0.9*8 = 7.2; scores 7 < 7.2 selects
    p = _write(tmp_path / "a.lsam",
               "r1\t64\t7\tACGT\tIIII\t7,acc1\nr1\t128\t9\tTTAA\tIIII\t9,acc1\n")
    out, _ = _both(["extract", "-t", "0.9", p], capsys, monkeypatch)
    assert "@r1/1" in out


@pytest.mark.parametrize("flags", [[], ["-v"], ["-s"], ["-i"], ["-g"], ["-n"], ["-v", "-n"],
                                   ["-s", "-i", "-g"], ["-v", "-s", "-n"]])
@pytest.mark.parametrize("threshold", ["40", "0.9"])
def test_extract_flags_on_stdin(capsys, monkeypatch, flags, threshold):
    """Every flag on random pairs read from standard input (``-``): -n
    prints each pair's name once however many of its ends are chosen."""
    lsam = "\n".join(random_lsam_pairs(np.random.default_rng(7), 50)) + "\n"
    out, _ = _both(["extract", "-t", threshold, *flags, "-"], capsys, monkeypatch, stdin=lsam)
    assert out
    if "-n" in flags:
        names = out.split()
        assert len(names) == len(set(names))


@pytest.mark.parametrize("case", ["jax_test", "random"])
def test_m8_to_lsam(tmp_path, capsys, monkeypatch, case):
    if case == "jax_test":
        p = _write(tmp_path / "a.m8", "q1\ts10x1s2\t99\t100\t0\t0\t1\t100\t5\t105\t1e-30\t200\n")
        out, _ = _both(["m8-to-lsam", p], capsys, monkeypatch)
        assert out.strip() == "q1\t0\t200\t*\t*\t200,s1;200,s2"
    else:
        m8 = "".join(random_m8(np.random.default_rng(3), 80))
        out, _ = _both(["m8-to-lsam"], capsys, monkeypatch, stdin=m8)
        assert out.count("\n") > 10


@pytest.mark.parametrize("case", ["jax_test", "random"])
def test_genomecov_filter(tmp_path, capsys, monkeypatch, case):
    if case == "jax_test":
        g = _write(tmp_path / "g.genome", "chr1\t100\n")
        c = _write(tmp_path / "cov.bed", "chr1\t0\t50\t2\nchr1\t50\t60\t500\nchr1\t60\t100\t2\n")
        out, _ = _both(["genomecov-filter", g, c, "2"], capsys, monkeypatch)
        assert out.strip() == "chr1\t50\t60"
        return
    rng = np.random.default_rng(5)
    names = [f"seq{i}" for i in range(4)]
    g = _write(tmp_path / "g.genome", "".join(f"{n}\t{1000 + i}\n" for i, n in enumerate(names)))
    rows = []
    for n in names + ["absent"]:
        pos = 0
        while pos < 1000:
            step = int(rng.integers(1, 60))
            depth = int(rng.integers(0, 6)) if rng.random() > 0.05 else int(rng.integers(50, 900))
            rows.append(f"{n}\t{pos}\t{pos + step}\t{depth}\n")
            pos += step
    rows.insert(3, "junk\n")
    c = _write(tmp_path / "cov.bed", "".join(rows))
    for stdev in ([], ["1"], ["3"]):
        out, _ = _both(["genomecov-filter", g, c, *stdev], capsys, monkeypatch)
        assert out or stdev == []


def test_r2c_to_r2g(tmp_path, capsys, monkeypatch):
    r2c = _write(tmp_path / "r2c.lsam", "read1\t64\t30\t*\t*\t50,12;25,13\n"
                 "read2\t128\t30\t*\t*\t99,13;41,12\tIGNORE\nread3\t64\t30\t*\t*\t90,13\tBacteria\n")
    c2g = _write(tmp_path / "c2g.lsam", "contig_12\t0\t99\t*\t*\t99,9606;80.5,562\n"
                 "contig_13\t0\t70\t*\t*\t70,562\n")
    out, _ = _both(["r2c-to-r2g", r2c, c2g], capsys, monkeypatch)
    assert out.splitlines()[0] == "read1\t64\t30\t*\t*\t99,9606;80.5,562"
    assert "read2" not in out and out.splitlines()[1] == "read3\t64\t30\t*\t*\t70,562\tBacteria"


def test_sam2cfq(tmp_path, capsys, monkeypatch):
    p = _write(tmp_path / "a.sam", "@SQ\tSN:chr1\tLN:1000\n"
               "r9\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII\tAS:i:4\tNM:i:0\n"
               "r8\t16\tkraken:taxid|562|x\t10\t60\t2S4M\t*\t0\t0\tACGTAA\tIIIII#\tNM:i:1\t"
               "XA:Z:chr2,+5,6M,0;chr3,-9,6M,3;\n")
    for dropout in ([], ["-d", "0.5"]):
        out, _ = _both(["sam2cfq", p, *dropout], capsys, monkeypatch)
        assert out.startswith("@r9 SCORE:4;4,chr1")


@pytest.mark.parametrize("flags", [[], ["--taxid", "562"], ["--tolerance", "3", "--fraction", "0.2"]])
def test_cleanup(capsys, monkeypatch, flags):
    """Records and the removed-species line on standard error."""
    lines = ([f"r{i}\t0\t150\t*\t*\t100,562;98,9606" for i in range(10)]
             + [f"s{i}\t0\t150\t*\t*\t100,28901;90.5,32630" for i in range(10)]
             + random_lsam_pairs(np.random.default_rng(2), 30))
    out, err = _both(["cleanup", *flags], capsys, monkeypatch, stdin="\n".join(lines) + "\n")
    assert out.count("\n") == len(lines) and err.startswith("removed species: [")
    if not flags:
        assert "562" in err


@pytest.mark.parametrize("case", ["jax_test", "golden", "random"])
def test_m8_cov(tmp_path, capsys, monkeypatch, case):
    if case == "jax_test":
        p = _write(tmp_path / "a.m8", "q1\ts1\t99\t50\t0\t0\t1\t50\t10\t59\t1e-9\t90\n"
                   "q2\ts1\t99\t50\t0\t0\t1\t50\t40\t99\t1e-9\t90\n"
                   "q3\ts1\t99\t20\t0\t0\t1\t20\t200\t181\t1e-9\t40\n")
        out, _ = _both(["m8-cov", p], capsys, monkeypatch)
        assert out.splitlines()[0] == "s1\t10,99;181,200;\t110"
    elif case == "golden":
        out, _ = _both(["m8-cov", str(FIX / "eval_in.m8")], capsys, monkeypatch)
        assert out == (FIX / "eval_cov.golden").read_text()
    else:
        _both(["m8-cov", "-"], capsys, monkeypatch,
              stdin="".join(random_m8(np.random.default_rng(9), 70)))


@pytest.mark.parametrize("case", ["jax_test", "golden", "random"])
def test_maplen_hist(tmp_path, capsys, monkeypatch, case):
    if case == "jax_test":
        p = _write(tmp_path / "a.m8", "q1\ts1\t99\t50\t0\t0\t1\t50\t10\t59\t1e-9\t90\n"
                   "q1\ts1\t99\t30\t0\t0\t1\t30\t80\t109\t1e-9\t50\n"
                   "q2\ts1\t99\t30\t0\t0\t1\t30\t70\t99\t1e-9\t50\n")
        out, _ = _both(["maplen-hist", p], capsys, monkeypatch)
        assert "Target: s1" in out and "NC50" in out
        assert len([l for l in out.splitlines() if "\t" in l and "Target" not in l]) == 3
    elif case == "golden":
        out, _ = _both(["maplen-hist", str(FIX / "eval_in.m8")], capsys, monkeypatch)
        assert out == (FIX / "eval_hist_nofa.golden").read_text()
    else:
        _both(["maplen-hist"], capsys, monkeypatch,
              stdin="".join(random_m8(np.random.default_rng(10), 70)))


@pytest.mark.parametrize("case", ["jax_test", "golden"])
def test_count_table(tmp_path, capsys, monkeypatch, case):
    tax = [str(FIX / "nodes.dmp"), str(FIX / "names.dmp")]
    if case == "jax_test":
        p = _write(tmp_path / "a.lsamid", "r1\t64\t50\t*\t*\t50,562\n"
                   "r2\t64\t50\t*\t*\t50,562;48,28901\n")
        out, _ = _both(["count-table", *tax, p], capsys, monkeypatch)
        rows = out.strip().split("\n")
        assert any(r.split("\t")[-2:] == ["1", "1"] for r in rows if r.startswith("species"))
        fam = [r for r in rows if r.startswith("family")]
        assert fam and fam[0].split("\t")[-2:] == ["2", "0"]
    else:
        lines = [l for l in (FIX / "golden.lsam.id").read_text().splitlines()
                 if int(l.split("\t")[2]) >= 40]
        out, _ = _both(["count-table", *tax], capsys, monkeypatch, stdin="\n".join(lines) + "\n")
        assert out == (FIX / "eval_counttable.golden").read_text()


@pytest.mark.parametrize("adapters", [True, False])
def test_bbduk(tmp_path, capsys, adapters):
    """The world's pairs (adapter read-through, low complexity, a '#'
    tail, N bases) through bbduk, with the TruSeq table and --outm or
    without both: the output files byte-equal, the summary line on
    standard error equal."""
    world = cs.world_workload(n=2)
    cs.write_fastq_pairs(world["pairs"], tmp_path / "r1.fq.gz", tmp_path / "r2.fq.gz")
    (tmp_path / "adapters.fa").write_text(f">truseq\n{cs.TRUSEQ}\n")
    got = {}
    for name, main in MAINS:
        out = tmp_path / name
        argv = ["bbduk", "--in1", str(tmp_path / "r1.fq.gz"), "--in2", str(tmp_path / "r2.fq.gz"),
                "--out1", f"{out}.1.fq", "--out2", f"{out}.2.fq"]
        if adapters:
            argv += ["--ref", str(tmp_path / "adapters.fa"), "--outm", f"{out}.lowc.fq"]
        assert main(argv) == 0
        got[name] = ({p.name[len(name):]: p.read_bytes() for p in tmp_path.glob(f"{name}.*")},
                     capsys.readouterr().err)
    assert got["port"] == got["jax"]
    files = got["port"][0]
    assert sorted(files) == [".1.fq", ".2.fq"] + ([".lowc.fq"] if adapters else [])
    if adapters:
        assert files[".lowc.fq"] and b"AGATCGGAAGAGC" not in files[".1.fq"]


# ---------------------------------------------------------------------------
# build-db (tests/test_cli.py:201)
# ---------------------------------------------------------------------------
def _db_inputs(d: pathlib.Path) -> list:
    """tests/test_cli.py's build-db inputs: an artificial sequence, an
    excluded taxon and an unmapped accession beside one kept NT sequence,
    and a UniVec segment. Returns the taxonomy flags."""
    rng = np.random.default_rng(3)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    (d / "nt.fa").write_text(
        f">AC001.1 Escherichia-like thing\n{seq(4000)}\n"
        f">AC002.1 synthetic construct vector\n{seq(3000)}\n"
        f">AC003.1 Dropme species genome\n{seq(3500)}\n"
        f">AC999.1 unmapped accession\n{seq(2000)}\n")
    (d / "uv.fa").write_text(f">UV001.1 UniVec segment\n{seq(1500)}\n")
    (d / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\t\n2\t|\t1\t|\tsuperkingdom\t|\t\n"
        "100\t|\t2\t|\tspecies\t|\t\n200\t|\t28384\t|\tspecies\t|\t\n"
        "28384\t|\t1\t|\tno rank\t|\t\n300\t|\t2\t|\tspecies\t|\t\n")
    (d / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
        "100\t|\tEscherichia thing\t|\t\t|\tscientific name\t|\n"
        "200\t|\tsynthetic construct\t|\t\t|\tscientific name\t|\n"
        "28384\t|\tartificial sequences\t|\t\t|\tscientific name\t|\n"
        "300\t|\tDropme species\t|\t\t|\tscientific name\t|\n")
    (d / "acc2tid.map").write_text(
        "accession\taccession.version\ttaxid\tgi\nAC001\tAC001.1\t100\t0\n"
        "AC002\tAC002.1\t200\t0\nAC003\tAC003.1\t300\t0\nUV001\tUV001.1\t100\t0\n")
    return ["--nodes", str(d / "nodes.dmp"), "--names", str(d / "names.dmp"),
            "--acc2tid", str(d / "acc2tid.map")]


def _build_db_argv(d: pathlib.Path, out: str, extra=()) -> list:
    return ["build-db", "--nt", str(d / "nt.fa"), "--univec", str(d / "uv.fa"),
            *_db_inputs(d), "--out-prefix", out, *extra]


@pytest.mark.parametrize("extra", [
    ["--exclude-taxa", "Dropme species", "--shard-bp", "5000", "--sa-interval", "4",
     "--lut-k", "6"],
    ["--human", "HUMAN", "--shard-bp", "3000"],
])
def test_build_db_files_equal_jax(tmp_path, capsys, extra):
    """createDB drops the artificial and the unmapped sequences, filterDB
    the excluded taxon, UniVec (and human) are appended; the curated FASTA,
    the shard FASTAs and every member of every .ref.npz/.fm.npz equal the
    JAX build-db's, dtypes included; so do stdout and stderr's counts."""
    extra = [str(tmp_path / "hg.fa") if e == "HUMAN" else e for e in extra]
    (tmp_path / "hg.fa").write_text(">NC_000001.11 Homo sapiens chr1\n" + "ACGTTGCA" * 300 + "\n")
    outs = {}
    for name, main in MAINS:
        (tmp_path / name).mkdir()
        argv = _build_db_argv(tmp_path, str(tmp_path / name / "nt"), extra)
        assert main(argv + (["--device", "cpu"] if name == "port" else [])) == 0
        cap = capsys.readouterr()
        outs[name] = (cap.out.replace(str(tmp_path / name), "D"),
                      [l for l in cap.err.splitlines() if "done in" not in l])
    assert outs["port"] == outs["jax"]
    pairs = [l.split("\t") for l in outs["port"][0].splitlines()]
    curated = (tmp_path / "port" / "nt.curated.fa").read_text()
    assert "AC001" in curated and "UV001" in curated
    assert "AC002" not in curated and "AC999" not in curated
    assert ("AC003" in curated) == ("--exclude-taxa" not in extra)
    assert ("NC_000001" in curated) == ("--human" in extra)
    assert len(pairs) >= 2 and outs["port"][1][0].startswith("[build-db] curated ")
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for f in port_files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if not f.endswith(".npz"):
            assert a.read_bytes() == b.read_bytes(), f
            continue
        with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
            assert sorted(x.files) == sorted(y.files), f
            for k in x.files:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (f, k)
    for rp, fp in pairs:
        rp, fp = (p.replace("D", str(tmp_path / "port"), 1) for p in (rp, fp))
        assert FMIndex.load(fp).n == len(PackedReference.load(rp).codes)


def test_build_db_aborts_when_nothing_survives(tmp_path, capsys):
    argv = _build_db_argv(tmp_path, str(tmp_path / "x"), ["--exclude-taxa", "Bacteria"])
    argv.remove("--univec")
    argv.remove(str(tmp_path / "uv.fa"))
    for name, main in MAINS:
        assert main(argv + (["--device", "cpu"] if name == "port" else [])) == 1
        assert "ABORT: no sequences survived curation" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.npz"))


def test_build_db_without_a_card_raises(tmp_path, monkeypatch):
    """The default --device cuda raises on a machine with no card, before
    it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available.*--device cpu"):
        cli.main(_build_db_argv(tmp_path, str(tmp_path / "db")))
    assert not list(tmp_path.glob("db*"))


@pytest.mark.parametrize("cmd", ["build-db", "build-index"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_a_shard_the_card_cannot_hold_is_refused_before_any_build(tmp_path, monkeypatch,
                                                                  cmd, where):
    """Shards at --shard-bp 4000 (4,000, 3,500 and 1,500 bp, then the
    5,000 bp human sequence alone): on a card that holds 3,600 bp the first
    shard is over, on one that holds 4,500 only the last. Either way
    check_shard_fits refuses before any shard is built or written, naming
    the limit and --device cpu."""
    limit = 3600 if where == "first" else 4500
    props = types.SimpleNamespace(total_memory=limit * shard.BUILD_BYTES_PER_CHAR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "a test card")

    def no_build(*a, **k):
        raise AssertionError("the index build ran")

    monkeypatch.setattr("megapath_tpu_torch.index.fm.build_fm_index", no_build)
    (tmp_path / "hg.fa").write_text(">NC_000001.11 chr1\n" + "ACGTTGCAGG" * 500 + "\n")
    argv = _build_db_argv(tmp_path, str(tmp_path / "db"), ["--human", str(tmp_path / "hg.fa"),
                                                           "--shard-bp", "4000"])
    if cmd == "build-index":  # the same shards from a FASTA of those lengths
        fa = tmp_path / "ref.fa"
        fa.write_text("".join(f">s{i}\n{'ACGT' * (n // 4)}\n"
                              for i, n in enumerate((4000, 3500, 1500, 5000))))
        argv = ["build-index", str(fa), str(tmp_path / "ix"), "--shard-bp", "4000"]
    with pytest.raises(ValueError, match=f"up to {limit} bp.*--device cpu"):
        cli.main(argv)
    assert not list(tmp_path.glob("*.npz"))


def test_fasta_bp_is_the_packed_length(tmp_path):
    """The size check counts what the pack holds: multi-line sequences,
    lower case, N runs, an empty sequence, headers with descriptions."""
    from megapath_tpu_torch.index.pack import pack_fasta_file

    fa = tmp_path / "x.fa"
    fa.write_text(">a desc\nACGT\nacgN\n>empty\n>b\nNNNNACGTRYK\n\n>c x y\nA\n")
    assert shard.fasta_bp(fa) == pack_fasta_file(fa).total_len == 20
    parts = shard.split_fasta(fa, str(tmp_path / "s"), max_bp=8)
    assert [shard.fasta_bp(p) for p in parts] == [pack_fasta_file(p).total_len for p in parts]
