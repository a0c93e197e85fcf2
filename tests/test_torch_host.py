"""The port's host stages against the JAX package's and the goldens.

bbduk (its host C++ scans and their plain numpy versions), SPIKE (the C++
moments fold and its plain loop), the taxonomy, the Kraken report, the
reassignment and the LSAM text: the same inputs, made with numpy from a
seed, go through the port and ``megapath_tpu``. Every check is exact
unless it says otherwise; the Java-oracle cases keep
``tests/test_bbduk_golden.py``'s 1e-6 for the entropy.
"""

import pathlib

import numpy as np
import pytest

from megapath_tpu.filters import bbduk as jbb
from megapath_tpu.filters import spike as jspike
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu_torch import native
from megapath_tpu_torch.classify.reassign import Reassigner, reassign_lines
from megapath_tpu_torch.convert import taxdb_from_reference
from megapath_tpu_torch.filters import bbduk as tbb
from megapath_tpu_torch.filters import spike as tspike
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.io.lsam import parse_lsam_line, read_lsam, write_lsam
from megapath_tpu_torch.taxonomy.report import KrakenReport, gen_kraken_report
from megapath_tpu_torch.taxonomy.taxdb import TaxDB
from test_bbduk_golden import (
    ADAPTER,
    ENTROPY_CASES,
    KMASK_CASES,
    QTRIM_CASES,
    enc,
    java_average_entropy,
    java_kmask,
    java_store_kmers,
    java_test_optimal,
)

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def taxdb():
    db = TaxDB(size=1024)
    db.read_nodes(FIX / "nodes.dmp")
    db.read_names(FIX / "names.dmp")
    db.read_acc2tid(FIX / "acc2tid.map")
    return db


def _reads(seed: int, B: int = 64, L: int = 250):
    """B random reads of lengths 0..L with N bases, some carrying the
    adapter with a substitution, phred 0-41 qualities (low tails on a
    third); returns (seqs, quals) strings."""
    rng = np.random.default_rng(seed)
    seqs, quals = [], []
    for b in range(B):
        n = int(rng.integers(0, L + 1)) if b % 5 else L
        s = list("ACGT"[c] for c in rng.integers(0, 4, n))
        if b % 3 == 0 and n > 40:
            frag = list(ADAPTER)
            frag[int(rng.integers(0, len(frag)))] = "ACGT"[int(rng.integers(0, 4))]
            p = int(rng.integers(0, n - len(frag)))
            s[p : p + len(frag)] = frag
        for q in rng.integers(0, max(n, 1), int(rng.integers(0, 4))):
            if n:
                s[int(q)] = "N"
        q = rng.integers(0, 42, n)
        if b % 3 == 1:
            q[n * 2 // 3 :] = rng.integers(0, 5, n - n * 2 // 3)
        seqs.append("".join(s))
        quals.append("".join(chr(33 + int(x)) for x in q))
    return seqs, quals


def _matrices(seqs, quals, L: int = 250):
    B = len(seqs)
    codes = np.zeros((B, L), np.uint8)
    is_n = np.zeros((B, L), bool)
    qual = np.zeros((B, L), np.int16)
    lens = np.array([len(s) for s in seqs], np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        codes[i, : len(s)] = enc(s)
        is_n[i, : len(s)] = np.frombuffer(s.encode(), np.uint8) == ord("N")
        qual[i, : len(q)] = np.frombuffer(q.encode(), np.uint8) - 33
    return codes, is_n, qual, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_quality_trim_equals_jax(seed):
    codes, is_n, qual, lens = _matrices(*_reads(seed))
    want = jbb.quality_trim(qual, is_n, lens, trimq=10)
    for fn in (tbb.quality_trim, tbb.quality_trim_plain):
        got = fn(qual, is_n, lens, trimq=10)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fn.__name__)


@pytest.mark.parametrize("seed", [2, 3])
def test_average_entropy_equals_jax(seed):
    codes, is_n, qual, lens = _matrices(*_reads(seed))
    want = jbb.average_entropy(codes, lens)
    np.testing.assert_array_equal(tbb.average_entropy(codes, lens), want)
    np.testing.assert_array_equal(tbb.average_entropy_plain(codes, lens), want)


@pytest.mark.parametrize("seed", [4, 5])
def test_kmask_equals_jax(seed):
    codes, is_n, qual, lens = _matrices(*_reads(seed))
    want = jbb.kmask(codes, lens, is_n, jbb.build_kmer_ref([ADAPTER], k=27, hdist=1))
    got = tbb.kmask(codes, lens, is_n, tbb.build_kmer_ref([ADAPTER], k=27, hdist=1))
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [6, 7])
def test_bbduk_pair_arrays_equals_jax(seed):
    s1, q1 = _reads(seed)
    s2, q2 = _reads(seed + 100)
    s1[:4] = ["AT" * 125, "A" * 250, "AAC" * 83, "GATTACA" * 35]  # low complexity
    names = [f"r{i}" for i in range(len(s1))]
    args = dict(min_len=50, trimq=10, entropy_cutoff=0.75, max_len=250)
    want = jbb.bbduk_pair_arrays(
        [JRecord(n, s, q) for n, s, q in zip(names, s1, q1)],
        [JRecord(n, s, q) for n, s, q in zip(names, s2, q2)],
        jbb.build_kmer_ref([ADAPTER], k=27, hdist=1), **args)
    got = tbb.bbduk_pair_arrays(
        [FastqRecord(n, s, q) for n, s, q in zip(names, s1, q1)],
        [FastqRecord(n, s, q) for n, s, q in zip(names, s2, q2)],
        tbb.build_kmer_ref([ADAPTER], k=27, hdist=1), **args)
    assert got.removed == want.removed and 0 < len(got.kept1) < len(names)
    for f in ("codes1", "lens1", "codes2", "lens2"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("kept1", "kept2", "low_complexity"):
        assert [(r.name, r.seq, r.qual) for r in getattr(got, f)] == [
            (r.name, r.seq, r.qual) for r in getattr(want, f)], f
    # the record path decides the same pairs
    res = tbb.bbduk_pair(
        [FastqRecord(n, s, q) for n, s, q in zip(names, s1, q1)],
        [FastqRecord(n, s, q) for n, s, q in zip(names, s2, q2)],
        tbb.build_kmer_ref([ADAPTER], k=27, hdist=1), **args)
    assert [r.seq for r in res.kept1] == [r.seq for r in got.kept1]
    assert res.removed_short == got.removed


@pytest.mark.parametrize("plain", [False, True])
def test_bbduk_scans_pass_the_java_oracle(plain):
    """tests/test_bbduk_golden.py's oracle cases on the port's C++ scans
    and on their plain versions."""
    entropy = tbb.average_entropy_plain if plain else tbb.average_entropy
    trim = tbb.quality_trim_plain if plain else tbb.quality_trim
    L = max(len(s) for s in ENTROPY_CASES)
    codes = np.zeros((len(ENTROPY_CASES), L), np.uint8)
    lens = np.array([len(s) for s in ENTROPY_CASES], np.int32)
    for i, s in enumerate(ENTROPY_CASES):
        codes[i, : len(s)] = enc(s)
    ours = entropy(codes, lens)
    for i, s in enumerate(ENTROPY_CASES):
        assert ours[i] == pytest.approx(java_average_entropy(s), abs=1e-6), i
    L = max(len(s) for s, _ in QTRIM_CASES)
    quals = np.zeros((len(QTRIM_CASES), L), np.int16)
    is_n = np.zeros((len(QTRIM_CASES), L), bool)
    lens = np.array([len(s) for s, _ in QTRIM_CASES], np.int32)
    for i, (s, q) in enumerate(QTRIM_CASES):
        quals[i, : len(q)] = q
        is_n[i, : len(s)] = np.frombuffer(s.encode(), np.uint8) == ord("N")
    start, stop = trim(quals, is_n, lens, trimq=10)
    for i, (s, q) in enumerate(QTRIM_CASES):
        left, right = java_test_optimal(s, q)
        if left == 0 and right == len(s):
            assert start[i] == stop[i], i
        else:
            assert (int(start[i]), len(s) - int(stop[i])) == (left, right), i


def test_kmask_passes_the_java_oracle():
    ref = tbb.build_kmer_ref([ADAPTER], k=27, hdist=1)
    stored, mm = java_store_kmers([ADAPTER], k=27, hdist=1)
    L = max(len(s) for s in KMASK_CASES)
    codes = np.zeros((len(KMASK_CASES), L), np.uint8)
    is_n = np.zeros((len(KMASK_CASES), L), bool)
    lens = np.array([len(s) for s in KMASK_CASES], np.int32)
    for i, s in enumerate(KMASK_CASES):
        codes[i, : len(s)] = enc(s)
        is_n[i, : len(s)] = np.frombuffer(s.encode(), np.uint8) == ord("N")
    ours = tbb.kmask(codes, lens, is_n, ref)
    for i, s in enumerate(KMASK_CASES):
        np.testing.assert_array_equal(ours[i, : len(s)], java_kmask(s, stored, mm, k=27))


def _alignments(seed: int):
    """Alignment intervals over three sequences with a pile-up on two."""
    rng = np.random.default_rng(seed)
    seq_lens = [5000, 3000, 800]
    seq = rng.integers(0, 3, 600).astype(np.int32)
    start = np.array([rng.integers(0, seq_lens[s] - 150) for s in seq])
    stop = start + rng.integers(60, 150, len(seq))
    seq = np.concatenate([seq, np.zeros(500, np.int32), np.ones(200, np.int32)])
    start = np.concatenate([start, np.full(500, 1200), np.full(200, 40)])
    stop = np.concatenate([stop, np.full(500, 1300), np.full(200, 120)])
    return seq_lens, np.arange(len(seq)) // 2, seq, start, stop


@pytest.mark.parametrize("seed", [0, 1])
def test_spike_equals_jax(seed):
    seq_lens, read, seq, start, stop = _alignments(seed)
    runs = tspike.genome_coverage(seq_lens, seq, start, stop)
    jruns = jspike.genome_coverage(seq_lens, seq, start, stop)
    for f in ("seq", "start", "stop", "depth"):
        np.testing.assert_array_equal(getattr(runs, f), getattr(jruns, f))
    for g, p in zip(tspike.spike_moments(runs, len(seq_lens)),
                    tspike.spike_moments_plain(runs, len(seq_lens))):
        np.testing.assert_array_equal(g, p)
    for k in (3, 60):
        for g, w in zip(tspike.spike_regions(runs, len(seq_lens), k),
                        jspike.spike_regions(jruns, len(seq_lens), k)):
            np.testing.assert_array_equal(g, w)
        got = tspike.spike_read_filter(seq_lens, read, seq, start, stop, max_depth_stdev=k)
        want = jspike.spike_read_filter(seq_lens, read, seq, start, stop, max_depth_stdev=k)
        np.testing.assert_array_equal(got, want)
    assert len(tspike.spike_read_filter(seq_lens, read, seq, start, stop, max_depth_stdev=3))


def test_taxdb_equals_jax(taxdb, mini_taxdb):
    for f in ("parent", "rank_code", "is_species", "is_superkingdom"):
        np.testing.assert_array_equal(getattr(taxdb, f), getattr(mini_taxdb, f))
    assert (taxdb.names, taxdb.acc2tid, taxdb.rank) == (
        mini_taxdb.names, mini_taxdb.acc2tid, mini_taxdb.rank)
    tids = np.array(sorted(mini_taxdb.names))
    for t in tids.tolist():
        assert taxdb.pop_to_species(t) == mini_taxdb.pop_to_species(t)
        assert taxdb.superkingdom_of(t) == mini_taxdb.superkingdom_of(t)
    np.testing.assert_array_equal(taxdb.depth_table(), mini_taxdb.depth_table())
    np.testing.assert_array_equal(taxdb.species_table(), mini_taxdb.species_table())
    rng = np.random.default_rng(0)
    a, b = rng.choice(tids, 200), rng.choice(tids, 200)
    np.testing.assert_array_equal(taxdb.lca_pairwise(a, b), mini_taxdb.lca_pairwise(a, b))
    gid = np.sort(rng.integers(0, 60, 200))
    np.testing.assert_array_equal(taxdb.lca_grouped(a, gid), mini_taxdb.lca_grouped(a, gid))
    shared = taxdb_from_reference(mini_taxdb)
    assert shared.parent is mini_taxdb.parent and shared.acc2tid is mini_taxdb.acc2tid
    np.testing.assert_array_equal(shared.lca_grouped(a, gid), taxdb.lca_grouped(a, gid))


def test_reports_and_reassign_reproduce_the_goldens(taxdb):
    lines = (FIX / "golden.lsam.id").read_text().splitlines()
    ra = list(reassign_lines(lines, t=40))
    assert "\n".join(ra) + "\n" == (FIX / "golden.ra.lsam.id").read_text()
    assert gen_kraken_report(taxdb, lines, 40) == (FIX / "golden.report").read_text()
    assert gen_kraken_report(taxdb, ra, 40) == (FIX / "golden.ra.report").read_text()


def test_array_path_reproduces_the_goldens(taxdb):
    """The pipeline's array path: per-line LCA by ``lca_grouped``,
    ``KrakenReport.add_lsam_batch``, and ``Reassigner.count_grouped`` /
    ``resolve`` / ``explained_rows`` give golden.report and
    golden.ra.report from golden.lsam.id's rows."""
    recs = [parse_lsam_line(x) for x in (FIX / "golden.lsam.id").read_text().splitlines()]
    scores = np.array([r.score for r in recs], np.int64)
    gid = np.array([g for g, r in enumerate(recs) for _ in r.hits], np.int64)
    sp = np.array([int(t) for r in recs for _, t in r.hits], np.int64)

    def report(sp_rows, gid_rows):
        lca = np.zeros(len(recs), np.int64)
        has = np.zeros(len(recs), bool)
        if len(sp_rows):
            lca[np.unique(gid_rows)] = taxdb.lca_grouped(sp_rows, gid_rows)
            has[np.unique(gid_rows)] = True
        rpt = KrakenReport(taxdb)
        rpt.add_lsam_batch(np.where(has, scores, -1), lca, 40)
        return rpt.format()

    assert report(sp, gid) == (FIX / "golden.report").read_text()
    ra = Reassigner(t=40.0)
    ra.count_grouped(sp, gid, scores)
    ra.resolve()
    drop = ra.explained_rows(sp, gid, len(recs))
    assert drop.any()
    assert report(sp[~drop], gid[~drop]) == (FIX / "golden.ra.report").read_text()
    rewritten = [ra.rewrite_line(r.to_line()) for r in recs]
    assert "\n".join(rewritten) + "\n" == (FIX / "golden.ra.lsam.id").read_text()


def test_lsam_round_trips_the_golden(tmp_path):
    text = (FIX / "golden.lsam.id").read_text()
    assert "".join(parse_lsam_line(x).to_line() + "\n" for x in text.splitlines()) == text
    write_lsam(read_lsam(FIX / "golden.lsam.id"), tmp_path / "out.lsam.id")
    assert (tmp_path / "out.lsam.id").read_text() == text


def test_host_build_refuses_without_gxx(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.build("spike", force=True)


def test_host_libraries_build_from_the_sources():
    for name in ("bbduk", "spike"):
        path = native.build(name)
        assert path.exists() and path.stat().st_mtime >= (
            native.SRC_DIR / f"{name}.cpp").stat().st_mtime
    assert native.load("bbduk").bbduk_qtrim.restype is None
