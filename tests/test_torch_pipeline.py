"""The port's MegaPath pipeline against the JAX pipeline and the goldens.

Twins of ``tests/test_cascade_parity.py`` (the real-soap4 cascade golden,
on both seeding paths) and of ``tests/test_pipeline.py`` (the synthetic
world with the mini taxonomy): the port's ``MegaPathPipeline`` runs on the
CPU with its plain PyTorch walk, locate and DP, and its host stages in
C++ and numpy. Every check is exact.
"""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.index.fm import build_fm_index as jbuild_fm_index
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu.pipeline import MegaPathPipeline as JPipeline
from megapath_tpu.pipeline import PipelineConfig as JConfig
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from megapath_tpu_torch.pipeline.megapath import PipelineAbort
from megapath_tpu_torch.taxonomy.taxdb import TaxDB
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CAS = pathlib.Path(__file__).parent / "fixtures" / "cascade"
ECOLI, SALM, SARS, HUMAN = (
    "NC_000913.1", "NC_003197.1", "NC_045512.1", "NC_000001.1")


# ---------------------------------------------------------------------------
# the real-soap4 cascade golden (tests/test_cascade_parity.py:58,63)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cascade_results():
    recs1, recs2 = cs.cascade_reads()
    return {ds: cs.cascade_pipeline(CPU, ds).run_records(recs1, recs2)
            for ds in (False, True)}


@pytest.mark.parametrize("device_seeding", [False, True])
def test_cascade_report_byte_identical(cascade_results, device_seeding):
    assert cascade_results[device_seeding].report == (CAS / "cascade.report").read_text()


@pytest.mark.parametrize("device_seeding", [False, True])
def test_cascade_per_read_records(cascade_results, device_seeding):
    golden = cs.lsam_id_table(open(CAS / "cascade.lsam.id"))
    ours = cs.lsam_id_table(r.to_line() for r in cascade_results[device_seeding].lsam_id)
    assert set(golden) == set(ours)
    assert [k for k in golden if golden[k] != ours[k]] == []


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's world: the same genomes (seed 123), 80 bp pairs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    w = cs.world_workload(n=0)
    seqs = {name: codes for shard in (*w["nt"], w["hg"]) for name, _, codes in shard}

    def shard(entries):
        ref = pack_fasta([FastqRecord(n, cs._text(c), "", d) for n, d, c in entries])
        return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)

    def jshard(entries):
        ref = jpack_fasta([JRecord(n, cs._text(c), "", d) for n, d, c in entries])
        return ref, jbuild_fm_index(ref.codes, sa_interval=4, lut_k=6)

    return {
        "nt": [shard(s) for s in w["nt"]], "hg": shard(w["hg"]),
        "jnt": [jshard(s) for s in w["nt"]], "jhg": jshard(w["hg"]),
        "seqs": seqs, "taxdb": cs.mini_taxdb(),
    }


def _pairs_from(seqs, key, rng, n, read_len=80, insert=300, prefix="rd"):
    """tests/test_pipeline.py's _pairs_from with the port's records."""
    codes = seqs[key]
    qual = "I" * read_len
    r1, r2 = [], []
    for i in range(n):
        p = int(rng.integers(0, len(codes) - insert))
        a = codes[p : p + read_len]
        b = COMPLEMENT[codes[p + insert - read_len : p + insert][::-1]]
        name = f"{prefix}{key}_{i}"
        r1.append(FastqRecord(name, cs._text(a), qual))
        r2.append(FastqRecord(name, cs._text(b), qual))
    return r1, r2


def _mixed(seqs, rng, counts):
    r1, r2 = [], []
    for key, n in counts:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    return r1, r2


def _jax(recs):
    return [JRecord(r.name, r.seq, r.qual) for r in recs]


def _write_fastq(recs, path):
    with open(path, "w") as f:
        for r in recs:
            f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")


def test_pipeline_end_to_end(world, mini_taxdb):
    rng = np.random.default_rng(5)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], hg_shard=world["hg"],
                            config=cfg, device=CPU)
    r1, r2 = _mixed(world["seqs"], rng, [(ECOLI, 10), (SALM, 6), (SARS, 4), (HUMAN, 5)])
    res = pipe.run_records(r1, r2)
    assert res.n_after_preprocess == 25
    assert res.n_after_human == 20  # 5 human pairs dropped
    lines = {tuple(x.split("\t")) for x in res.report.splitlines()[1:]}
    by_tid = {int(t[4]): (int(t[1]), int(t[2])) for t in lines}
    assert by_tid[562] == (20, 20)
    assert by_tid[28901] == (12, 12)
    assert by_tid[694009] == (8, 8)
    assert 9606 not in by_tid
    assert by_tid[0] == (0, 0)
    # and the JAX pipeline's bytes on the same inputs
    want = JPipeline(world["jnt"], mini_taxdb, hg_shard=world["jhg"],
                     config=JConfig(read_len=80, skip_preprocess=True)
                     ).run_records(_jax(r1), _jax(r2))
    assert cs.pipeline_record(res) == cs.pipeline_record(want)


def test_pipeline_report_scores_are_paired_sums(world):
    rng = np.random.default_rng(6)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], config=cfg, device=CPU)
    r1, r2 = _pairs_from(world["seqs"], ECOLI, rng, 3)
    res = pipe.run_records(r1, r2)
    assert len(res.lsam_id) == 6
    for rec in res.lsam_id:
        assert rec.score == 160  # 2 x 80 paired sum
        assert [t for _, t in rec.hits] == ["562"]


def test_pipeline_preprocess_drops_low_complexity(world):
    rng = np.random.default_rng(7)
    cfg = PipelineConfig(read_len=80, min_len=50, skip_human=True)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], config=cfg, device=CPU)
    r1, r2 = _pairs_from(world["seqs"], SALM, rng, 3)
    r1.append(FastqRecord("lowc", "AT" * 40, "I" * 80))
    r2.append(FastqRecord("lowc", "TA" * 40, "I" * 80))
    res = pipe.run_records(r1, r2)
    assert res.n_after_preprocess == 3


def test_ribosome_stage_filters_pairs(world):
    rng = np.random.default_rng(7)
    ribo_seq = rng.integers(0, 4, 3000).astype(np.uint8)
    ref = pack_fasta([FastqRecord("SILVA_1", cs._text(ribo_seq), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], config=cfg, ribo_shard=(ref, fm),
                            device=CPU)
    qual = "I" * 80
    rr1, rr2 = [], []
    for i in range(4):
        p = int(rng.integers(0, len(ribo_seq) - 300))
        rr1.append(FastqRecord(f"ribo{i}", cs._text(ribo_seq[p : p + 80]), qual))
        rr2.append(FastqRecord(
            f"ribo{i}", cs._text(COMPLEMENT[ribo_seq[p + 220 : p + 300][::-1]]), qual))
    e1, e2 = _pairs_from(world["seqs"], ECOLI, rng, 5)
    res = pipe.run_records(rr1 + e1, rr2 + e2)
    assert res.n_after_ribo == 5
    assert "Escherichia" in res.report
    assert not any(r.name.startswith("ribo") for r in res.lsam_id)


def test_streaming_run_files_matches_run_records(world, tmp_path):
    rng = np.random.default_rng(6)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, batch_size=7)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], hg_shard=world["hg"],
                            config=cfg, device=CPU)
    r1, r2 = _mixed(world["seqs"], rng, [(ECOLI, 9), (SARS, 5), (HUMAN, 3)])
    want = pipe.run_records(r1, r2)
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    got = pipe.run_files(str(p1), str(p2), str(tmp_path / "mp"))
    assert got.report == want.report
    assert got.ra_report == want.ra_report
    assert got.n_after_human == want.n_after_human
    lines = (tmp_path / "mp.nt.lsam.id").read_text().splitlines()
    assert lines == [rec.to_line() for rec in want.lsam_id]
    ra_lines = (tmp_path / "mp.nt.ra.lsam.id").read_text().splitlines()
    assert ra_lines == [rec.to_line() for rec in want.ra_lsam_id]
    assert (tmp_path / "mp.align.done").exists()
    assert (tmp_path / "mp.done").exists()
    again = pipe.run_files(str(p1), str(p2), str(tmp_path / "mp"))
    assert again.report == want.report


def test_run_files_aborts_on_empty_stage(world, tmp_path):
    rng = np.random.default_rng(66)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], hg_shard=world["hg"],
                            config=cfg, device=CPU)
    r1, r2 = _pairs_from(world["seqs"], HUMAN, rng, 6)
    p1, p2 = tmp_path / "h1.fq", tmp_path / "h2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    with pytest.raises(PipelineAbort, match="host filtering"):
        pipe.run_files(str(p1), str(p2), str(tmp_path / "ab"))


def test_run_files_resumes_from_batch_journal(world, tmp_path):
    rng = np.random.default_rng(9)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, batch_size=5)
    pipe = MegaPathPipeline(world["nt"], world["taxdb"], hg_shard=world["hg"],
                            config=cfg, device=CPU)
    r1, r2 = _mixed(world["seqs"], rng, [(ECOLI, 8), (SARS, 9)])
    want = pipe.run_records(r1, r2)
    p1, p2 = tmp_path / "j1.fq", tmp_path / "j2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    orig = pipe._align_shards
    calls = {"n": 0}

    def bomb(*a, **k):
        if calls["n"] == 2:
            raise RuntimeError("synthetic crash at batch 2")
        calls["n"] += 1
        return orig(*a, **k)

    pipe._align_shards = bomb
    with pytest.raises(RuntimeError, match="synthetic crash"):
        pipe.run_files(str(p1), str(p2), str(tmp_path / "jr"))
    bdir = tmp_path / "jr.align_batches"
    assert sorted(p.name for p in bdir.iterdir()) == ["batch000000.npz", "batch000001.npz"]
    assert not (tmp_path / "jr.align.done").exists()
    calls2 = {"n": 0}

    def count(*a, **k):
        calls2["n"] += 1
        return orig(*a, **k)

    pipe._align_shards = count
    got = pipe.run_files(str(p1), str(p2), str(tmp_path / "jr"))
    assert calls2["n"] == 2  # batches 2 and 3 only
    assert got.report == want.report
    assert got.ra_report == want.ra_report
    lines = (tmp_path / "jr.nt.lsam.id").read_text().splitlines()
    assert lines == [rec.to_line() for rec in want.lsam_id]
    assert not bdir.exists()


def test_e2e_sensitivity_fdr_gate(tmp_path):
    """tests/test_pipeline.py's scaled-down community (10 species + 2
    decoys x 60 kbp, 600 pairs, device seeding): sensitivity >= 0.99,
    FDR <= 0.01, every species with >= 5 pairs reported, no false one."""
    rng = np.random.default_rng(67)
    n_species, n_decoys, glen, L, ins = 10, 2, 60_000, 100, 320
    genomes = [rng.integers(0, 4, glen).astype(np.uint8) for _ in range(n_species + n_decoys)]
    ref = pack_fasta([FastqRecord(f"genome{i}", cs._text(g), "") for i, g in enumerate(genomes)])
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)
    cs.write_e2e_taxonomy(tmp_path, n_species + n_decoys)
    db = TaxDB(size=4096)
    db.read_nodes(tmp_path / "nodes.dmp")
    db.read_names(tmp_path / "names.dmp")
    db.read_acc2tid(tmp_path / "acc2tid.map")
    w = np.logspace(0, -2.5, n_species)
    w /= w.sum()
    counts = rng.multinomial(600, w)
    recs1, recs2, truth = [], [], {}
    i = 0
    for sp in range(n_species):
        g = genomes[sp]
        for _ in range(counts[sp]):
            p = int(rng.integers(0, glen - ins))
            r1 = g[p : p + L].copy()
            r2 = COMPLEMENT[g[p + ins - L : p + ins][::-1]].copy()
            for arr in (r1, r2):
                for _ in range(int(rng.binomial(L, 0.005))):
                    q = int(rng.integers(0, L))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            name = f"rd{i:05d}"
            truth[name] = 10 + sp
            recs1.append(FastqRecord(name, cs._text(r1), "I" * L))
            recs2.append(FastqRecord(name, cs._text(r2), "I" * L))
            i += 1
    pipe = MegaPathPipeline(
        [(ref, fm)], db, device=CPU,
        config=PipelineConfig(read_len=L, skip_human=True, device_seeding=True, max_read_len=L),
    )
    res = pipe.run_records(recs1, recs2)
    tp = fp = fn = 0
    for rec in res.lsam_id:
        t = truth.get(rec.name)
        if rec.score < 40 or not rec.hits:
            fn += 1
            continue
        tids = {int(float(x)) for _, x in rec.hits}
        if t in tids:
            tp += 1
            fp += len(tids) - 1
        else:
            fn += 1
            fp += len(tids)
    assert tp / max(tp + fn, 1) >= 0.99, (tp, fn)
    assert fp / max(tp + fp, 1) <= 0.01, (tp, fp)
    want_sp = {10 + s for s in range(n_species) if counts[s] >= 5}
    got_sp = set()
    for line in res.ra_report.splitlines():
        c = line.split("\t")
        if len(c) >= 6 and c[3] == "S" and int(c[1]) > 0:
            got_sp.add(int(c[4]))
    assert want_sp <= got_sp, want_sp - got_sp
    assert not (got_sp - {10 + s for s in range(n_species)}), "false species"


# ---------------------------------------------------------------------------
# what the port leaves out raises, naming the ROADMAP item
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [
    ({"config": PipelineConfig(spmd=True)}, "A10"),
    ({"devices": [CPU, CPU]}, "A10"),
])
def test_left_out_features_raise(world, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        MegaPathPipeline(world["nt"], world["taxdb"], device=CPU, **kw)


def test_run_files_protein_db_without_assembly_is_unused(world, tmp_path):
    """``run_files(protein_db=)`` without ``assembly`` runs as the JAX
    pipeline does: the protein DB is accepted and unused, and the run
    writes exactly what it writes without it."""
    from megapath_tpu_torch.classify.protein import ProteinDB

    rng = np.random.default_rng(4)
    recs = _mixed(world["seqs"], rng, [(SARS, 6), (ECOLI, 6)])
    paths = []
    for end in (0, 1):
        paths.append(tmp_path / f"r{end + 1}.fq")
        _write_fastq(recs[end], paths[-1])
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    db = ProteinDB.build(cs.protein_world_db(cs.world_workload(cs.WORLD_PAIRS_PER_KIND)))
    for tag, kw in (("plain", {}), ("protein_db", {"protein_db": db})):
        MegaPathPipeline(world["nt"], world["taxdb"], config=cfg, device=CPU).run_files(
            str(paths[0]), str(paths[1]), str(tmp_path / tag), **kw)
    assert cs.run_outputs(tmp_path, "protein_db") == cs.run_outputs(tmp_path, "plain")
    assert not (tmp_path / "protein_db.nr.lsam.id").exists()
