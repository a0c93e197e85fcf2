"""The port's assembly stage modules against the JAX package's, in one
process on the same inputs: ``filters/bbnorm.py``, ``pipeline/multik.py``
and ``pipeline/assembly.py``. Twins of ``tests/test_assembly.py`` (less
``test_dbtools``, twinned in ``tests/test_torch_dbtools.py``),
``tests/test_bbnorm_golden.py`` and ``tests/test_extras.py``'s bbnorm
downsampling, plus random inputs drawn from seeds. Outputs are compared
whole: the contig lists as text, ``normalize_pairs``' mask,
``end_stats``' fields, every r2c ``LsamRecord`` as its LSAM line.

The single-k ``assemble_unitigs`` walks a set of strings, so its text
changes with the process's string hash; both packages build that set the
same way, so within one process they agree, and only that is compared."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from megapath_tpu.filters import bbnorm as jbbnorm
from megapath_tpu.io.fastq import FastqRecord as JRec
from megapath_tpu.io.lsam import LsamRecord as JLsam
from megapath_tpu.pipeline import assembly as jasm
from megapath_tpu.pipeline import multik as jmultik
from megapath_tpu_torch.filters import bbnorm
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.io.lsam import LsamRecord
from megapath_tpu_torch.pipeline import assembly, multik
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")
COMP = str.maketrans("ACGT", "TGCA")


def _seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def _reads(rng, genome: str, n: int, L: int, err: float, both_strands: bool = False):
    """``n`` reads of ``L`` bp from ``genome`` with ``err`` substitutions a
    base, half of them reverse-complemented when ``both_strands``."""
    out = []
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - L))
        r = list(genome[p : p + L])
        for j in range(L):
            if rng.random() < err:
                r[j] = "ACGT"[("ACGT".index(r[j]) + 1 + int(rng.integers(0, 3))) % 4]
        s = "".join(r)
        out.append(_rc(s) if both_strands and rng.random() < 0.5 else s)
    return out


def _golden_module():
    spec = importlib.util.spec_from_file_location("make_bbnorm_golden",
                                                  FIX / "make_bbnorm_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pairs_records(rows):
    """(name, seq1, qual1, seq2, qual2) rows as each package's records:
    ((recs1, recs2) of the port, (recs1, recs2) of the JAX package)."""
    return (([FastqRecord(n, a, qa) for n, a, qa, _, _ in rows],
             [FastqRecord(n, b, qb) for n, _, _, b, qb in rows]),
            ([JRec(n, a, qa) for n, a, qa, _, _ in rows],
             [JRec(n, b, qb) for n, _, _, b, qb in rows]))


def _lines(recs) -> list:
    return [r.to_line() for r in recs]


# ---------------------------------------------------------------------------
# bbnorm (tests/test_bbnorm_golden.py, tests/test_extras.py:26)
# ---------------------------------------------------------------------------
def test_bbnorm_matches_transliterated_oracle():
    pairs = _golden_module().make_fixture()
    golden = json.loads((FIX / "bbnorm_golden.json").read_text())
    assert golden["n_pairs"] == len(pairs)
    kw = dict(target=golden["target"], mindepth=golden["mindepth"], seed=golden["seed"])
    s1, s2 = [a for a, _ in pairs], [b for _, b in pairs]
    keep = bbnorm.normalize_pairs(s1, s2, **kw)
    assert np.flatnonzero(keep).tolist() == golden["kept"]
    np.testing.assert_array_equal(keep, jbbnorm.normalize_pairs(s1, s2, **kw))


def test_canonical_kmers_match_oracle_and_handle_ns():
    mod = _golden_module()
    seq = "ACGTACGTAC" * 5 + "N" + "GGTTCCAAGG" * 5
    ours = bbnorm.canonical_kmers(seq)
    assert ours is not None and ours.dtype == np.int64
    assert ours.tolist() == mod.to_kmers(seq, 31)
    assert ours.tolist() == jbbnorm.canonical_kmers(seq).tolist()
    assert bbnorm.canonical_kmers("ACGT") is None
    assert jbbnorm.canonical_kmers("ACGT") is None


def test_error_reads_get_reduced_target():
    p1, pf = bbnorm.pass_params(target=70, mindepth=1)
    assert p1.target_depth == 280
    assert p1.target_bad_low == 60
    assert p1.target_bad_high == 105
    assert p1.max_depth == 350
    assert pf.target_depth == pf.target_bad_low == 70
    assert abs(p1.depth_percentile - 0.648) < 1e-3
    assert abs(pf.depth_percentile - 0.54) < 1e-9
    for target, mindepth in ((70, 1), (20, 3), (5, 2), (333, 1)):
        for ours, theirs in zip(bbnorm.pass_params(target, mindepth),
                                jbbnorm.pass_params(target, mindepth)):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_bbnorm_downsamples_deep_coverage():
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    deep1 = [seq[0:100]] * 200
    deep2 = [seq[100:200]] * 200
    uniq1 = ["".join("ACGT"[i] for i in rng.integers(0, 4, 100)) for _ in range(20)]
    uniq2 = ["".join("ACGT"[i] for i in rng.integers(0, 4, 100)) for _ in range(20)]
    keep = bbnorm.normalize_pairs(deep1 + uniq1, deep2 + uniq2, target=20)
    assert keep[200:].all()
    assert 15 <= keep[:200].sum() <= 120
    np.testing.assert_array_equal(
        keep, jbbnorm.normalize_pairs(deep1 + uniq1, deep2 + uniq2, target=20))


def _noisy_seq(rng, n: int) -> str:
    """A random sequence with lower-case bases, N and other IUPAC codes."""
    s = list(rng.choice(list("ACGT"), n))
    for q in rng.integers(0, n, int(rng.integers(0, 4))):
        s[int(q)] = str(rng.choice(list("NnRYacgt")))
    return "".join(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_kmers_random(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 120))
        k = int(rng.choice([5, 17, 31]))
        s = _noisy_seq(rng, n)
        ours, theirs = bbnorm.canonical_kmers(s, k), jbbnorm.canonical_kmers(s, k)
        if theirs is None:
            assert ours is None
        else:
            assert ours.dtype == theirs.dtype and ours.tolist() == theirs.tolist()


@pytest.mark.parametrize("seed", [3, 4])
def test_end_stats_and_normalize_random(seed):
    """Mixed-depth pairs from a seed (a deep, a mid and a rare region,
    error reads, N bases, short ends): ``count_table``, every
    ``end_stats`` field of every end under both passes, and the keep mask
    at several targets, each pass count."""
    rng = np.random.default_rng(seed)
    g = _seq(2000, seed + 10)
    s1, s2 = [], []
    for lo, hi, n in ((0, 250, 150), (400, 900, 80), (1000, 1900, 25)):
        for _ in range(n):
            p = int(rng.integers(lo, hi - 100 + 1)) if hi - lo > 100 else lo
            a, b = list(g[p : p + 60]), list(_rc(g[p + 40 : p + 100]))
            for arr in (a, b):
                for _ in range(int(rng.poisson(0.5))):
                    arr[int(rng.integers(0, 60))] = str(rng.choice(list("ACGTN")))
            s1.append("".join(a)[: int(rng.integers(20, 61))])
            s2.append("".join(b))
    km = [bbnorm.canonical_kmers(s) for s in s1 + s2]
    counts = bbnorm.count_table(km)
    assert counts == jbbnorm.count_table([jbbnorm.canonical_kmers(s) for s in s1 + s2])
    for p, jp in zip(bbnorm.pass_params(), jbbnorm.pass_params()):
        for x in km:
            assert dataclasses.asdict(bbnorm.end_stats(x, counts, p)) == \
                dataclasses.asdict(jbbnorm.end_stats(x, counts, jp))
    for target, passes in ((70, 2), (20, 2), (5, 1), (2, 2)):
        np.testing.assert_array_equal(
            bbnorm.normalize_pairs(s1, s2, target=target, passes=passes),
            jbbnorm.normalize_pairs(s1, s2, target=target, passes=passes))


# ---------------------------------------------------------------------------
# the assemblers (tests/test_assembly.py)
# ---------------------------------------------------------------------------
def test_unitig_assembler_recovers_contig():
    genome = _seq(600, 1)
    reads = [genome[i : i + 80] for i in range(0, 520, 7)]
    contigs = assembly.assemble_unitigs(reads, k=31, min_count=2, min_len=200)
    assert contigs == jasm.assemble_unitigs(reads, k=31, min_count=2, min_len=200)
    best = max(contigs, key=len)
    assert best in genome or _rc(best) in genome
    assert len(best) > 400


def test_unitig_assembler_handles_two_sources():
    g1, g2 = _seq(400, 2), _seq(400, 3)
    reads = [g1[i : i + 70] for i in range(0, 330, 6)] + [
        g2[i : i + 70] for i in range(0, 330, 6)]
    contigs = assembly.assemble_unitigs(reads, k=31, min_len=150)
    assert contigs == jasm.assemble_unitigs(reads, k=31, min_len=150)
    assert len(contigs) >= 2


def test_unitig_assembler_quality_metrics():
    """A 3-genome mock at ~30x with 0.5% substitutions: the port's contigs
    equal the JAX package's, recover >= 70% with N50 >= 1 kb, and each is
    an exact (revcomp-)substring of one genome."""
    rng = np.random.default_rng(7)
    genomes = ["".join("ACGT"[c] for c in rng.integers(0, 4, n)) for n in (8000, 5000, 3000)]
    L = 100
    reads = []
    for g in genomes:
        for _ in range(len(g) * 30 // L):
            p = int(rng.integers(0, len(g) - L))
            r = list(g[p : p + L])
            for j in range(L):
                if rng.random() < 0.005:
                    r[j] = "ACGT"[int(rng.integers(0, 4))]
            reads.append("".join(r))
    contigs = assembly.assemble_unitigs(reads, k=31, min_count=3, min_len=300)
    assert contigs == jasm.assemble_unitigs(reads, k=31, min_count=3, min_len=300)
    assert contigs
    covered = [np.zeros(len(g), bool) for g in genomes]
    for c in contigs:
        spot = next(((g, cov, g.find(probe), probe) for g, cov in zip(genomes, covered)
                     for probe in (c, _rc(c)) if probe in g), None)
        assert spot is not None, f"misassembled contig (len {len(c)})"
        _, cov, p, probe = spot
        cov[p : p + len(probe)] = True
    assert sum(int(c.sum()) for c in covered) / sum(map(len, genomes)) >= 0.70
    assert multik.n50(contigs) >= 1000


def test_multik_beats_single_k_on_uneven_coverage():
    rng = np.random.default_rng(5)
    genomes = [_seq(6000, 50 + i) for i in range(3)]
    reads = []
    for g, cov in zip(genomes, (6, 30, 100)):
        reads += _reads(rng, g, len(g) * cov // 100, 100, 0.01, both_strands=True)
    single = assembly.assemble_unitigs(reads, k=31, min_count=2, min_len=100)
    multi = multik.assemble_multik(reads, min_count=2, min_len=100)
    assert single == jasm.assemble_unitigs(reads, k=31, min_count=2, min_len=100)
    assert multi == jmultik.assemble_multik(reads, min_count=2, min_len=100)
    assert multik.n50(multi) >= 4 * max(multik.n50(single), 1)
    for g in genomes:
        rs, rm = multik.genome_recovery(single, g), multik.genome_recovery(multi, g)
        assert rm >= rs - 0.02
        assert rm == jmultik.genome_recovery(multi, g)
    assert multik.genome_recovery(multi, genomes[2]) > 0.95
    assert multik.n50(multi) > 1000


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_multik_internals_random(seed):
    """``_count_kmers`` (weights, N and lower case), ``_build_unitigs``,
    ``_clean_graph`` and ``assemble_multik`` at several k lists and
    min_counts on a two-genome draw with errors and both strands."""
    rng = np.random.default_rng(seed)
    genomes = [_seq(int(rng.integers(800, 2500)), seed * 7 + i) for i in range(2)]
    reads = []
    for g, cov in zip(genomes, (8, 40)):
        reads += _reads(rng, g, len(g) * cov // 90, 90, 0.01, both_strands=True)
    noisy = [_noisy_seq(rng, 60) for _ in range(10)]
    weights = [int(w) for w in rng.integers(1, 4, len(reads) + len(noisy))]
    for k in (5, 21, 31):
        assert multik._count_kmers(reads + noisy, k) == \
            jmultik._count_kmers(reads + noisy, k)
        assert multik._count_kmers(reads + noisy, k, weights) == \
            jmultik._count_kmers(reads + noisy, k, weights)
    for k in (21, 31):
        counts = multik._count_kmers(reads, k)
        solid = {km: c for km, c in counts.items() if c >= 2}
        got = [(u.kmers, u.cov, u.seq) for u in multik._build_unitigs(solid, k)]
        want = [(u.kmers, u.cov, u.seq) for u in jmultik._build_unitigs(solid, k)]
        assert got == want
        # equal in content and in order: the unitig walk follows dict order
        assert list(multik._clean_graph(dict(solid), k).items()) == \
            list(jmultik._clean_graph(dict(solid), k).items())
    for k_list, min_count in (((21, 41, 61, 81), 2), ((25, 55), 3), ((31,), 1)):
        got = multik.assemble_multik(reads, k_list=k_list, min_count=min_count, min_len=80)
        assert got == jmultik.assemble_multik(reads, k_list=k_list, min_count=min_count,
                                              min_len=80)
        assert multik._dedup(got + [c[5:60] for c in got]) == \
            jmultik._dedup(got + [c[5:60] for c in got])
        for g in genomes:
            for k in (21, 31):
                assert multik.genome_recovery(got, g, k) == jmultik.genome_recovery(got, g, k)


@pytest.mark.parametrize("seed", [21, 22])
def test_n50_random(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        contigs = ["A" * int(n) for n in rng.integers(1, 500, int(rng.integers(0, 12)))]
        assert multik.n50(contigs) == jmultik.n50(contigs)
    assert multik.n50([]) == 0
    assert multik.genome_recovery(["ACGT"], "AC") == jmultik.genome_recovery(["ACGT"], "AC")


# ---------------------------------------------------------------------------
# extraction and the assembly path (tests/test_assembly.py)
# ---------------------------------------------------------------------------
def test_extract_viral_and_unmapped():
    rows = [(n, "ACGT" * 20, "I" * 80, "ACGT" * 20, "I" * 80) for n in "abc"]
    (r1, r2), (j1, j2) = _pairs_records(rows)
    spec = [("a", 0x40, 150, [(150.0, "562")], []), ("a", 0x80, 150, [(150.0, "562")], []),
            ("b", 0x40, 10, [], []), ("b", 0x80, 150, [(150.0, "562")], []),
            ("c", 0x40, 150, [(150.0, "694009")], ["Viruses"]),
            ("c", 0x80, 150, [(150.0, "694009")], ["Viruses"])]
    o1, o2 = assembly.extract_viral_and_unmapped(
        [LsamRecord(n, f, s, hits=h, opts=o) for n, f, s, h, o in spec], r1, r2, threshold=40)
    assert [r.name for r in o1] == ["b", "c"] == [r.name for r in o2]
    p1, _ = jasm.extract_viral_and_unmapped(
        [JLsam(n, f, s, hits=h, opts=o) for n, f, s, h, o in spec], j1, j2, threshold=40)
    assert [r.name for r in p1] == ["b", "c"]


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_extract_viral_and_unmapped_random(seed):
    """Odd flags (0, 0x41, 0xC0, 0x80 only), duplicate and missing
    records, 'Viruses' on either end, and a fractional threshold."""
    rng = np.random.default_rng(seed)
    n = 60
    rows = []
    for i in range(n):
        l1, l2 = int(rng.integers(30, 150)), int(rng.integers(30, 150))
        rows.append((f"r{i}", "A" * l1, "I" * l1, "C" * l2, "I" * l2))
    spec = []
    for i in range(n):
        for _ in range(int(rng.integers(0, 4))):
            flag = int(rng.choice([0x40, 0x80, 0x41, 0x81, 0xC0, 0]))
            opts = ["Viruses"] if rng.random() < 0.15 else (["Bacteria"] if rng.random() < 0.3 else [])
            spec.append((f"r{i}", flag, int(rng.integers(0, 300)), opts))
    spec.append(("stranger", 0x40, 5, []))
    for threshold in (40, 0.3, 0):
        (r1, r2), (j1, j2) = _pairs_records(rows)
        o1, o2 = assembly.extract_viral_and_unmapped(
            [LsamRecord(nm, f, s, opts=o) for nm, f, s, o in spec], r1, r2, threshold=threshold)
        p1, p2 = jasm.extract_viral_and_unmapped(
            [JLsam(nm, f, s, opts=o) for nm, f, s, o in spec], j1, j2, threshold=threshold)
        assert [(r.name, r.seq) for r in o1] == [(r.name, r.seq) for r in p1]
        assert [(r.name, r.seq) for r in o2] == [(r.name, r.seq) for r in p2]


def _path_pairs(seed_genome=5, seed_draw=6, n=60, glen=800):
    """``tests/test_assembly.py::test_assembly_path_end_to_end``'s pairs."""
    genome = _seq(glen, seed_genome)
    rng = np.random.default_rng(seed_draw)
    rows = []
    for i in range(n):
        p = int(rng.integers(0, glen - 300))
        rows.append((f"p{i}", genome[p : p + 80], "I" * 80,
                     _rc(genome[p + 220 : p + 300]), "I" * 80))
    return rows


def _both_paths(rows, device_seeding, **kw):
    (r1, r2), (j1, j2) = _pairs_records(rows)
    got = assembly.assembly_path(r1, r2, device=CPU, device_seeding=device_seeding, **kw)
    want = jasm.assembly_path(j1, j2, **kw)
    return got, want


@pytest.mark.parametrize("device_seeding", [False, True])
def test_assembly_path_end_to_end(device_seeding):
    got, want = _both_paths(_path_pairs(), device_seeding, norm_target=100, k=31,
                            min_contig=150)
    assert got.contigs and got.contigs == want.contigs
    assert got.read2contig and _lines(got.read2contig) == _lines(want.read2contig)
    assert len({r.name for r in got.read2contig}) > 30


@pytest.mark.parametrize("device_seeding", [False, True])
def test_assembly_path_single_k_and_random_draw(device_seeding):
    """The single-k branch (``multi_k=False``), and the multi-k branch on
    two genomes with errors, both strands and pairs of no genome."""
    got, want = _both_paths(_path_pairs(7, 8, 50, 700), device_seeding, multi_k=False,
                            min_contig=120)
    assert got.contigs == want.contigs
    assert _lines(got.read2contig) == _lines(want.read2contig)
    rng = np.random.default_rng(9)
    genomes = [_seq(1500, 40), _seq(900, 41)]
    rows = []
    for i in range(120):
        g = genomes[i % 2]
        p = int(rng.integers(0, len(g) - 260))
        a, b = _reads(rng, g[p : p + 260], 2, 100, 0.005)
        rows.append((f"q{i}", a, "I" * 100, _rc(b), "I" * 100))
    rows += [(f"junk{i}", _seq(100, 90 + i), "I" * 100, _seq(100, 190 + i), "I" * 100)
             for i in range(6)]
    got, want = _both_paths(rows, device_seeding)
    assert got.contigs and got.contigs == want.contigs
    assert _lines(got.read2contig) == _lines(want.read2contig)


@pytest.mark.parametrize("device_seeding", [False, True])
def test_assembly_path_without_contigs(device_seeding):
    """Too few pairs to assemble: both packages return no contig and no
    r2c record, and build no index."""
    rows = [(f"e{i}", _seq(90, 300 + i), "I" * 90, _seq(90, 400 + i), "I" * 90)
            for i in range(5)]
    got, want = _both_paths(rows, device_seeding)
    assert got.contigs == want.contigs == []
    assert got.read2contig == want.read2contig == []
    got, want = _both_paths([], device_seeding)
    assert (got.contigs, got.read2contig) == ([], []) == (want.contigs, want.read2contig)


_HASH_SCRIPT = r"""
import json, sys
import numpy as np
from megapath_tpu.pipeline.assembly import assemble_unitigs as j_single
from megapath_tpu.pipeline.multik import assemble_multik as j_multi
from megapath_tpu_torch.pipeline.assembly import assemble_unitigs
from megapath_tpu_torch.pipeline.multik import assemble_multik
rng = np.random.default_rng(5)
comp = str.maketrans("ACGT", "TGCA")
reads = []
for gi, cov in enumerate((10, 40)):
    g = "".join("ACGT"[c] for c in np.random.default_rng(50 + gi).integers(0, 4, 3000))
    for _ in range(3000 * cov // 100):
        p = int(rng.integers(0, 2900))
        r = list(g[p : p + 100])
        for k in range(100):
            if rng.random() < 0.01:
                r[k] = "ACGT"[("ACGT".index(r[k]) + 1 + int(rng.integers(0, 3))) % 4]
        s = "".join(r)
        reads.append(s if rng.random() < 0.5 else s.translate(comp)[::-1])
single, multi = assemble_unitigs(reads), assemble_multik(reads)
json.dump({"single": single, "multi": multi,
           "single_equal": single == j_single(reads), "multi_equal": multi == j_multi(reads)},
          sys.stdout)
"""


def test_string_hash_changes_only_the_single_k_strands():
    """Under two string-hash seeds (two processes): the port equals the
    JAX package in each, the multi-k contigs are the same text in both,
    and the single-k contigs are the same sequences up to strand (which
    strand of each unitig is kept follows the set's order, ROADMAP §C)."""
    out = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed, "JAX_PLATFORMS": "cpu"}
        proc = subprocess.run([sys.executable, "-c", _HASH_SCRIPT], env=env, text=True,
                              capture_output=True, cwd=FIX.parents[1], timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out.append(json.loads(proc.stdout))
    for o in out:
        assert o["single_equal"] and o["multi_equal"]
    assert out[0]["multi"] == out[1]["multi"]
    assert sorted(min(c, _rc(c)) for c in out[0]["single"]) == \
        sorted(min(c, _rc(c)) for c in out[1]["single"])
