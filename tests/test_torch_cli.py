"""The port's command line against the JAX package's (``megapath_tpu.cli``)
on the CPU: ``build-index`` files, ``run`` outputs (reports, LSAM.id, the
BAM content) on the cascade golden's reads and the 2 x 250 bp world on
both seeding paths, resume, the stream tools against the reference
goldens, and what the port refuses. Every check is exact."""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu.index.fm import FMIndex as JFMIndex
from megapath_tpu.index.pack import PackedReference as JRef
from megapath_tpu.index.shard import DEFAULT_SHARD_BP as JDEFAULT_SHARD_BP
from megapath_tpu_torch import cli
from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.index import shard
from megapath_tpu_torch.index.fm import FMIndex, build_fm_index
from megapath_tpu_torch.index.pack import PackedReference, pack_fasta_file
from megapath_tpu_torch.io.fastq import read_fastx
from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CAS = FIX / "cascade"
CPU = ["--device", "cpu"]
OUTPUTS = (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")
TAXONOMY = ["--nodes", str(FIX / "nodes.dmp"), "--names", str(FIX / "names.dmp"),
            "--acc2tid", str(FIX / "acc2tid.map")]


def _cascade_argvs(d: pathlib.Path, prefix: str, device_seeding: bool):
    """build-index of the cascade's two shards and its run (-L 80, no
    preprocessing, no human filter, -b)."""
    builds = [["build-index", str(CAS / f"shard{i}.fa"), str(d / f"s{i}" / "s"),
               "--sa-interval", "8", "--lut-k", "8"] for i in (0, 1)]
    run = ["run", "-1", str(CAS / "r1.fq"), "-2", str(CAS / "r2.fq"), "-p", prefix,
           "--nt-index", str(d / "s0" / "shard0"), str(d / "s1" / "shard0"), *TAXONOMY,
           "-L", "80", "--skip-preprocess", "-b"]
    return builds, run + ([] if device_seeding else ["--no-device-seeding"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over the world (one pair of each kind) and the cascade:
    build-index, then run -b on device and on host seeding. Returns the
    directories {(package, workload): path}."""
    root = tmp_path_factory.mktemp("cli")
    world = cs.world_workload(n=1)
    out = {}
    for pkg, main, extra in (("port", cli.main, CPU), ("jax", jcli.main, [])):
        d = root / pkg / "world"
        cs.write_world_files(world, d)
        for argv in cs.world_build_argvs(d):
            assert main(argv + extra) == 0
        for ds, key in ((True, "device"), (False, "host")):
            assert main(cs.world_run_argv(d, str(d / key), ds) + extra) == 0
        out[pkg, "world"] = d
        d = root / pkg / "cascade"
        for i in (0, 1):
            (d / f"s{i}").mkdir(parents=True)
        for ds, key in ((True, "device"), (False, "host")):
            builds, run = _cascade_argvs(d, str(d / key), ds)
            if ds:
                for argv in builds:
                    assert main(argv + extra) == 0
            assert main(run + extra) == 0
        out[pkg, "cascade"] = d
    return out


# ---------------------------------------------------------------------------
# build-index and the index files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard_prefix", ["nt/shard0", "nt/shard1", "hg/shard0", "ribo/shard0"])
def test_build_index_files_equal_jax(runs, shard_prefix):
    """Every key of every .ref.npz/.fm.npz equal, dtypes included."""
    for suf in (".ref.npz", ".fm.npz"):
        with np.load(runs["port", "world"] / (shard_prefix + suf), allow_pickle=True) as a, \
                np.load(runs["jax", "world"] / (shard_prefix + suf), allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (suf, k)
                assert np.array_equal(a[k], b[k]), (suf, k)


@pytest.mark.parametrize("shard_prefix", ["nt/shard0", "hg/shard0"])
def test_each_package_loads_the_others_index(runs, shard_prefix):
    port = runs["port", "world"] / shard_prefix
    jax = runs["jax", "world"] / shard_prefix
    for loaded, want in (
        (JRef.load(str(port) + ".ref.npz"), PackedReference.load(str(jax) + ".ref.npz")),
        (PackedReference.load(str(jax) + ".ref.npz"), JRef.load(str(port) + ".ref.npz")),
    ):
        assert loaded.names == want.names and loaded.annotations == want.annotations
        assert all(np.array_equal(getattr(loaded, f), getattr(want, f))
                   for f in ("codes", "offsets", "ambiguous"))
    for loaded, want in ((JFMIndex.load(str(port) + ".fm.npz"), FMIndex.load(str(jax) + ".fm.npz")),
                         (FMIndex.load(str(jax) + ".fm.npz"), JFMIndex.load(str(port) + ".fm.npz"))):
        for f in ("n", "primary", "sa_interval", "lut_k", "bwt_words", "occ", "counts",
                  "sa_sampled", "mark_rank", "lut_lo", "lut_hi"):
            assert np.array_equal(getattr(loaded, f), getattr(want, f)), f


@pytest.mark.parametrize("device_seeding", [False, True])
def test_engine_on_loaded_index_equals_fresh(runs, device_seeding):
    """A port engine over the index build-index saved gives the hits of one
    over an index built in memory from the same FASTA."""
    d = runs["port", "world"]
    ref, fm = cli.load_shard(str(d / "nt" / "shard0"))
    fresh = pack_fasta_file(d / "nt" / "nt.0.fa")
    fresh_fm = build_fm_index(fresh.codes, sa_interval=4, lut_k=6, device=torch.device("cpu"))
    world = cs.world_workload(n=1)
    recs1, recs2 = cs.fastq_records(world["pairs"])
    from megapath_tpu_torch.index.pack import pack_reads

    batch = (*pack_reads([r.seq for r in recs1], 250), *pack_reads([r.seq for r in recs2], 250))
    hits = [AlignEngine(r, f, AlignParams(), device=torch.device("cpu"),
                        device_seeding=device_seeding).align_pairs(*batch)
            for r, f in ((ref, fm), (fresh, fresh_fm))]
    assert len(hits[0]) > 0
    assert np.array_equal(cs.canonical_hits(hits[0]), cs.canonical_hits(hits[1]))


def test_split_fasta_shard_cap(tmp_path):
    """tests/test_index.py:189's twin: sequences packed up to max_bp a
    shard, an oversized one alone; the same pinned 2.0 Gbp default."""
    assert shard.DEFAULT_SHARD_BP == JDEFAULT_SHARD_BP == int(2.0e9)
    p = tmp_path / "ref.fa"
    seqs = [("a", "A" * 50), ("b", "C" * 40), ("c", "G" * 70), ("d", "T" * 150), ("e", "A" * 10)]
    p.write_text("".join(f">{n} desc {n}\n{s}\n" for n, s in seqs))
    shards = shard.split_fasta(p, str(tmp_path / "out"), max_bp=100)
    got = [[(r.name, r.comment, len(r.seq)) for r in read_fastx(sp)] for sp in shards]
    assert got == [[("a", "desc a", 50), ("b", "desc b", 40)], [("c", "desc c", 70)],
                   [("d", "desc d", 150)], [("e", "desc e", 10)]]


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("workload", ["world", "cascade"])
@pytest.mark.parametrize("seeding", ["device", "host"])
def test_run_outputs_byte_identical_to_jax(runs, workload, seeding):
    for suf in OUTPUTS:
        got = (runs["port", workload] / (seeding + suf)).read_bytes()
        assert got == (runs["jax", workload] / (seeding + suf)).read_bytes(), suf


@pytest.mark.parametrize("workload,n_shards", [("world", 2), ("cascade", 2)])
@pytest.mark.parametrize("seeding", ["device", "host"])
def test_run_bam_content_equals_jax(runs, workload, n_shards, seeding):
    """The merged and per-shard BAMs decompress to the JAX package's
    header and SAM lines (the BGZF bytes depend on the zlib build)."""
    for suf in [".nt.bam"] + [f".nt.bam.{i}" for i in range(n_shards)]:
        got = cs.bam_content(runs["port", workload] / (seeding + suf))
        want = cs.bam_content(runs["jax", workload] / (seeding + suf))
        assert got == want, suf
    header, lines = cs.bam_content(runs["port", workload] / (seeding + ".nt.bam"))
    assert lines and header.count("@SQ") == 4


@pytest.mark.parametrize("seeding", ["device", "host"])
def test_cascade_run_report_equals_golden(runs, seeding):
    got = (runs["port", "cascade"] / f"{seeding}.nt.report").read_text()
    assert got == (CAS / "cascade.report").read_text()


def test_run_resumes_after_the_align_stage(runs, tmp_path, monkeypatch, capsys):
    """tests/test_pipeline.py's resume contract: a second run on the same
    prefix skips the stages that are done and gives the same outputs."""
    d = runs["port", "cascade"]
    prefix = str(tmp_path / "again")
    _, run = _cascade_argvs(d, prefix, device_seeding=False)
    assert cli.main(run + CPU) == 0
    first = {suf: pathlib.Path(prefix + suf).read_bytes() for suf in OUTPUTS}
    bam_mtime = pathlib.Path(prefix + ".nt.bam").stat().st_mtime_ns

    def no_align(*a, **k):
        raise AssertionError("the align stage ran again")

    monkeypatch.setattr(MegaPathPipeline, "_align_shards", no_align)
    capsys.readouterr()
    assert cli.main(run + CPU) == 0
    assert "Skipping alignment" in capsys.readouterr().err
    assert {suf: pathlib.Path(prefix + suf).read_bytes() for suf in OUTPUTS} == first
    assert pathlib.Path(prefix + ".nt.bam").stat().st_mtime_ns == bam_mtime


# ---------------------------------------------------------------------------
# the stream tools and report against the reference goldens
# ---------------------------------------------------------------------------
def _both(argv, capsys):
    outs = []
    for main in (cli.main, jcli.main):
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    return outs[0]


def test_fastq2lsam_golden(capsys):
    out = _both(["fastq2lsam", str(FIX / "mini.cfq")], capsys)
    assert out == (FIX / "golden.lsam").read_text()


def test_taxlookup_golden(capsys):
    out = _both(["taxlookup", str(FIX / "acc2tid.map"), str(FIX / "nodes.dmp"),
                 str(FIX / "names.dmp"), str(FIX / "golden.lsam")], capsys)
    assert out == (FIX / "golden.lsam.id").read_text()


def test_reassign_golden(capsys):
    out = _both(["reassign", str(FIX / "golden.lsam.id")], capsys)
    assert out == (FIX / "golden.ra.lsam.id").read_text()


@pytest.mark.parametrize("lsam,golden", [("golden.lsam.id", "golden.report"),
                                         ("golden.ra.lsam.id", "golden.ra.report")])
def test_report_golden(capsys, lsam, golden):
    out = _both(["report", str(FIX / "nodes.dmp"), str(FIX / "names.dmp"), str(FIX / lsam)],
                capsys)
    assert out == (FIX / golden).read_text()


def test_deinterleave_equals_jax(tmp_path, capsys):
    for main, name in ((cli.main, "t"), (jcli.main, "j")):
        assert main(["deinterleave", str(tmp_path / name), str(FIX / "mini.cfq")]) == 0
    for suf in (".pe_1.fq", ".pe_2.fq", ".se.fq"):
        assert (tmp_path / f"t{suf}").read_text() == (tmp_path / f"j{suf}").read_text()
    pe1 = list(read_fastx(tmp_path / "t.pe_1.fq"))
    assert len(pe1) == 8 and pe1[0].name.endswith("/1")
    assert len(list(read_fastx(tmp_path / "t.se.fq"))) == 1


def test_lsam_read_filter_equals_jax(tmp_path, capsys):
    ban = tmp_path / "ban.txt"
    ban.write_text("r1/1\nread_single_1\n")
    lsam = tmp_path / "a.lsam"
    lsam.write_text("r1\t64\t50\t*\t*\t*\nr2\t64\t50\t*\t*\t*\n"
                    + (FIX / "golden.lsam").read_text())
    out = _both(["lsam-read-filter", str(ban), str(lsam)], capsys)
    assert out.startswith("r2\t64\t50\t*\t*\t*\n") and "read_single_1" not in out


def test_cli_records_belong_to_the_workloads():
    """torch_cli_records.json, which chip_smoke.py holds the card to,
    belongs to the workloads drawn here; its community records classify
    as phase 10's JAX e2e record does."""
    recs = json.loads((FIX / "torch_cli_records.json").read_text())
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    assert recs["world"]["input_sha256"] == cs.pairs_digest(world["pairs"])
    assert set(recs["world"]["device_seeding"]["bam_sha256"]) == {
        ".nt.bam", ".nt.bam.0", ".nt.bam.1"}
    _, pairs = cs.e2e_workload()
    e2e = recs["e2e"]
    assert e2e["input_sha256"] == cs.pairs_digest(pairs)
    assert e2e["hg_kept"] == [f"hg{i:06d}" for i in cs.LARGE_HG_KEPT]
    pipeline_e2e = json.loads((FIX / "torch_pipeline_reports.json").read_text())["e2e"]
    for key in ("alone", "with_hg_kept"):
        for k in ("report", "ra_report"):
            assert cs.taxon_rows(e2e[key][k]) == cs.taxon_rows(pipeline_e2e[k])


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags,item", [(["--devices", "2"], "A10"), (["--spmd"], "A10")])
def test_run_refuses_unported_flags(tmp_path, flags, item):
    argv = ["run", "-1", "r1.fq", "-2", "r2.fq", "-p", str(tmp_path / "x"),
            "--nt-index", "nt/shard0", *TAXONOMY, *flags, *CPU]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


@pytest.mark.parametrize("cmd", ["build-index", "run"])
def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "g.fa"
    fa.write_text(">g\nACGTACGTAC\n")
    argv = (["build-index", str(fa), str(tmp_path / "g")] if cmd == "build-index" else
            ["run", "-1", "r1.fq", "-2", "r2.fq", "--nt-index", "nt/shard0", *TAXONOMY])
    with pytest.raises(RuntimeError, match="CUDA is not available.*--device cpu"):
        cli.main(argv)
    assert not list(tmp_path.glob("*.npz"))


def test_an_80_gb_card_admits_the_default_shard(monkeypatch):
    """The card's build fits the 2.0 Gbp default shard on an 80 GB card
    (the JAX package builds it on the host); there int32 coordinates, not
    the card's memory, set the limit, and a shard one character over it
    is still refused."""
    total = 80 * 10**9
    props = types.SimpleNamespace(total_memory=total)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "an 80 GB card")
    assert shard.BUILD_BYTES_PER_CHAR <= 36
    shard.check_shard_fits(shard.DEFAULT_SHARD_BP, torch.device("cuda"))
    limit = shard.MAX_SHARD_BP
    assert shard.DEFAULT_SHARD_BP <= limit < total // shard.BUILD_BYTES_PER_CHAR
    assert limit == 2**31 - 2
    shard.check_shard_fits(limit, torch.device("cuda"))
    with pytest.raises(ValueError, match=f"up to {limit} bp.*--device cpu"):
        shard.check_shard_fits(limit + 1, torch.device("cuda"))


def test_build_index_refuses_a_shard_the_card_cannot_hold(tmp_path, monkeypatch):
    """On a card, a shard longer than its memory over
    BUILD_BYTES_PER_CHAR is refused before anything is built, naming the
    limit and --device cpu; at the limit it passes the check."""
    limit = 1500
    props = types.SimpleNamespace(total_memory=limit * shard.BUILD_BYTES_PER_CHAR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "a test card")
    fa = tmp_path / "g.fa"
    fa.write_text(">g1\n" + "ACGT" * 300 + "\n>g2\n" + "TTGCA" * 100 + "\n")
    with pytest.raises(ValueError, match=f"up to {limit} bp.*--device cpu"):
        cli.main(["build-index", str(fa), str(tmp_path / "g")])
    assert not list(tmp_path.glob("*.npz"))
    shard.check_shard_fits(limit, torch.device("cuda"))
    shard.check_shard_fits(10**12, torch.device("cpu"))
