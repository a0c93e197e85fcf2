"""The port's protein-remap, cleanup, SAM and evaluation tools against the
JAX package's on the same inputs: ``classify/extras.py``,
``io/sam2cfq.py``, ``utils/accuracy.py`` and ``taxonomy/report.py``'s
``japsa_to_kraken``. The twins of ``tests/test_extras.py``,
``tests/test_eval_golden.py`` (against the reference binaries' goldens in
``tests/fixtures/eval_*`` too) and ``tests/test_taxonomy.py``'s Japsa
report, plus random inputs drawn from a seed. Every comparison is of
whole outputs: LSAM lines, FASTQ records, report text."""

import pathlib

import numpy as np
import pytest

from chip_smoke import mini_taxdb as port_mini_taxdb
from megapath_tpu.classify import extras as jextras
from megapath_tpu.io import lsam as jlsam
from megapath_tpu.io import sam2cfq as jsam2cfq
from megapath_tpu.taxonomy import report as jreport
from megapath_tpu.taxonomy.taxdb import TaxDB as JTaxDB
from megapath_tpu.utils import accuracy as jaccuracy
from megapath_tpu_torch.classify import extras
from megapath_tpu_torch.io import lsam
from megapath_tpu_torch.io import sam2cfq
from megapath_tpu_torch.taxonomy import report
from megapath_tpu_torch.taxonomy.taxdb import TaxDB
from megapath_tpu_torch.utils import accuracy
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _dbs(size: int, acc2tid: bool = True):
    """(port TaxDB, JAX TaxDB) over the mini taxonomy at one size."""
    out = []
    for cls in (TaxDB, JTaxDB):
        db = cls(size=size)
        db.read_nodes(FIX / "nodes.dmp")
        db.read_names(FIX / "names.dmp")
        if acc2tid:
            db.read_acc2tid(FIX / "acc2tid.map")
        out.append(db)
    return out


def _lines(recs) -> list:
    return [r.to_line() for r in recs]


def _fq(recs) -> list:
    return [(r.name, r.seq, r.qual, r.comment) for r in recs]


def _both_lsam(lines):
    """The same LSAM lines parsed by each package."""
    return ([lsam.parse_lsam_line(l) for l in lines],
            [jlsam.parse_lsam_line(l) for l in lines])


# ---------------------------------------------------------------------------
# random inputs drawn from a seed
# ---------------------------------------------------------------------------
TIDS = ("562", "83333", "28901", "59201", "694009", "11137", "9606", "32630", "561")


def random_m8(rng: np.random.Generator, n: int) -> list:
    """m8 rows: runs of a query over several subjects (some 0x1-joined),
    reversed subject intervals, fractional bitscores, a short row."""
    rows = []
    for i in range(n):
        q = f"q{int(rng.integers(0, n // 3 + 1))}"
        k = int(rng.integers(1, 3))
        s = "0x1".join(str(rng.choice(TIDS)) for _ in range(k))
        qs, qe = sorted(int(x) for x in rng.integers(1, 150, 2))
        ss, se = (int(x) for x in rng.integers(1, 2000, 2))
        bit = float(rng.integers(20, 300)) + float(rng.choice([0.0, 0.5, 0.25]))
        rows.append(f"{q}\t{s}\t97.{i % 10}\t{qe - qs + 1}\t1\t0\t{qs}\t{qe}\t{ss}\t{se}\t"
                    f"1e-{int(rng.integers(5, 40))}\t{bit:g}\n")
    rows.sort(key=lambda r: r.split("\t")[0])
    rows.insert(int(rng.integers(0, len(rows))), "short\trow\n")
    return rows


def random_lsam_pairs(rng: np.random.Generator, n: int) -> list:
    """Consecutive-pair LSAM.id lines: scores around the cutoffs, taxid
    hits with fractional scores, Viruses and IGNORE columns."""
    out = []
    for i in range(n):
        for flag in (64, 128):
            L = int(rng.integers(30, 120))
            seq = "".join(rng.choice(list("ACGT"), L))
            score = int(rng.integers(0, 160))
            hits = ";".join(f"{score - int(rng.integers(0, 12)) + float(rng.choice([0, 0.5])):g},"
                            f"{rng.choice(TIDS)}" for _ in range(int(rng.integers(0, 4)))) or "*"
            opts = [c for c in ("Viruses", "IGNORE", "Bacteria") if rng.random() < 0.25]
            out.append("\t".join([f"r{i}", str(flag), str(score), seq, "I" * L, hits, *opts]))
    return out


# ---------------------------------------------------------------------------
# classify/extras.py (tests/test_extras.py:40-179)
# ---------------------------------------------------------------------------
def test_m8_to_lsam():
    lines = [
        "read1\t562\t99.0\t100\t1\t0\t1\t100\t5\t104\t1e-30\t180.5",
        "read1\t289010x1562\t98.0\t100\t2\t0\t1\t100\t5\t104\t1e-28\t170",
        "read2\t9606\t90\t80\t8\t0\t1\t80\t3\t82\t1e-10\t95.2",
    ]
    recs = list(extras.m8_to_lsam(lines))
    assert _lines(recs) == _lines(jextras.m8_to_lsam(lines))
    assert len(recs) == 2 and recs[0].name == "read1" and recs[0].score == 180
    assert (170.0, "28901") in recs[0].hits and (170.0, "562") in recs[0].hits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_m8_to_lsam_random(seed):
    rows = random_m8(np.random.default_rng(seed), 60)
    assert _lines(extras.m8_to_lsam(rows)) == _lines(jextras.m8_to_lsam(rows))


@pytest.mark.parametrize("case", ["labels", "unaligned_contig"])
def test_r2c_to_r2g(case):
    if case == "labels":
        r2c, c2g = [("read1", 90, [(90.0, "1")])], [("contig_1", 500, [(500.0, "NC_1"), (450.0, "NC_2")])]
        want = [(500.0, "NC_1"), (450.0, "NC_2")]
    else:  # an unaligned contig ('*') contributes no genome hits
        r2c = [("read1", 90, [(90.0, "1"), (85.0, "2")])]
        c2g = [("contig_1", 0, []), ("contig_2", 500, [(500.0, "NC_9")])]
        want = [(500.0, "NC_9")]
    outs = []
    for mod, pkg in ((lsam, extras), (jlsam, jextras)):
        recs = [[mod.LsamRecord(n, 0, s, hits=list(h)) for n, s, h in side] for side in (r2c, c2g)]
        outs.append(list(pkg.r2c_to_r2g(iter(recs[0]), iter(recs[1]))))
    assert _lines(outs[0]) == _lines(outs[1])
    assert outs[0][0].hits == want and outs[0][0].seq == "*" and outs[0][0].qual == "*"


def test_r2c_to_r2g_random():
    """Reads over random contigs, some unaligned, IGNORE reads dropped,
    read-side scores around the 40 threshold."""
    rng = np.random.default_rng(4)
    c2g = [f"contig_{c}\t0\t{int(rng.integers(50, 500))}\t*\t*\t"
           + (";".join(f"{int(rng.integers(50, 500))},NC_{int(rng.integers(0, 9))}"
                       for _ in range(int(rng.integers(1, 4)))) if c % 4 else "*")
           for c in range(12)] + ["notacontig\t0\t9\t*\t*\t9,NC_0"]
    r2c = [f"read{i}\t{64 if i % 2 else 128}\t30\tACGT\tIIII\t"
           + ";".join(f"{int(rng.integers(20, 90))},{int(rng.integers(0, 14))}"
                      for _ in range(int(rng.integers(1, 4))))
           + ("\tIGNORE" if i % 7 == 3 else "\tBacteria")
           for i in range(40)]
    port = extras.r2c_to_r2g(_both_lsam(r2c)[0], _both_lsam(c2g)[0])
    ref = jextras.r2c_to_r2g(_both_lsam(r2c)[1], _both_lsam(c2g)[1])
    assert _lines(port) == _lines(ref)


def test_cleanup_contaminants():
    lines = ([f"r{i}\t0\t150\t*\t*\t100,562;98,9606" for i in range(10)]
             + [f"s{i}\t0\t150\t*\t*\t100,28901" for i in range(10)])
    port, ref = _both_lsam(lines)
    (out, removed), (jout, jremoved) = (extras.cleanup_contaminants(port, fraction=0.5),
                                        jextras.cleanup_contaminants(ref, fraction=0.5))
    assert removed == jremoved == {562}
    assert _lines(out) == _lines(jout)
    assert all("562" not in [t for _, t in r.hits] for r in out)


@pytest.mark.parametrize("seed", [0, 1])
def test_cleanup_contaminants_random(seed):
    port, ref = _both_lsam(random_lsam_pairs(np.random.default_rng(seed), 80))
    for kw in ({}, {"score_tolerance": 3.0, "fraction": 0.2},
               {"contaminant_tids": {562}, "fraction": 0.9}):
        (out, removed), (jout, jremoved) = (extras.cleanup_contaminants(port, **kw),
                                            jextras.cleanup_contaminants(ref, **kw))
        assert removed == jremoved and _lines(out) == _lines(jout)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_from_lsam_random(seed):
    """Every flag combination of extractFromLSAM on random pairs: the
    selected (record, mate, comment) triples are the JAX package's."""
    lines = random_lsam_pairs(np.random.default_rng(seed), 60)
    port, ref = _both_lsam(lines)
    for threshold in (40.0, 0.9):
        for flags in range(16):
            kw = dict(viral=bool(flags & 1), se_mode=bool(flags & 2),
                      append_ignore=bool(flags & 4), skip_ignore_tag=bool(flags & 8))
            got = [(r.to_line(), w, c) for r, w, c in extras.extract_from_lsam(port, threshold, **kw)]
            want = [(r.to_line(), w, c) for r, w, c in jextras.extract_from_lsam(ref, threshold, **kw)]
            assert got == want, (threshold, kw)


def test_japsa_to_kraken_report():
    db, jdb = _dbs(4096, acc2tid=False)
    sp = [t for t in range(len(db.parent)) if db.rank_of(t) == "species"][:2]
    lines = ["header\tcols", f"x\tx\tx\tx\t{sp[0]}\tx\tx\tx\t70",
             f"x\tx\tx\tx\t{sp[1]}\tx\tx\tx\t30"]
    rpt = extras.japsa_to_kraken_report(db, lines)
    assert rpt == jextras.japsa_to_kraken_report(jdb, lines)
    rows = rpt.splitlines()
    assert rows[0].startswith("prec\t")
    assert any(f"\t{sp[0]}\t" in r and "70.00" in r for r in rows)
    root = [r for r in rows if "\t1\t0\t" in r]
    assert root and root[0].startswith("100.00\t100\t")


def test_filter_cross_family_reads():
    db, jdb = _dbs(3_000_000)
    accs = sorted(db.acc2tid)
    fam_of = {}
    for a in accs:
        t = db.acc2tid[a]
        while t not in (0, 1) and db.rank_of(t) != "family":
            t = int(db.parent[t])
        fam_of[a] = t
    same = [a for a in accs if fam_of[a] == fam_of[accs[0]]][:2]
    other = next(a for a in accs if fam_of[a] != fam_of[accs[0]])
    lines = [f"keep\t64\t100\tACGT\tIIII\t100,{same[0]}.1;90,{same[-1]}",
             f"drop\t64\t100\tTTTT\tIIII\t100,{same[0]};90,{other}.2",
             "star\t64\t0\tGGGG\tIIII\t*",
             "unknown\t64\t50\tCCCC\tIIII\t50,NOT_AN_ACC;40,gi|1|ref|" + same[0] + "|"]
    port, ref = _both_lsam(lines)
    out = list(extras.filter_cross_family_reads(db, port))
    assert _fq(out) == _fq(jextras.filter_cross_family_reads(jdb, ref))
    names = [r.name for r in out]
    assert "keep" in names and "star" in names and "drop" not in names


# ---------------------------------------------------------------------------
# io/sam2cfq.py
# ---------------------------------------------------------------------------
def test_sam2cfq_scores_and_hits():
    for cigar, nm, want in (("100M", 2, 94), ("50M2D50M", 2, 96), ("10S30M1I20M2D5M", 7, None)):
        got = sam2cfq.score_from_cigar_nm(cigar, nm)
        assert got == jsam2cfq.score_from_cigar_nm(cigar, nm)
        assert want is None or got == want
    lines = [
        "@SQ\tSN:x\tLN:1",
        "r1\t0\tNC_1.1\t10\t60\t100M\t*\t0\t0\t" + "A" * 100 + "\t" + "I" * 100 + "\tNM:i:0\tAS:i:100",
        "r2\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tIIII",
        "r3\t16\tkraken:taxid|562|seq\t5\t60\t4M\t*\t0\t0\tACGT\tIIII\tNM:i:0",
    ]
    recs = list(sam2cfq.sam_to_cfq(lines))
    assert _fq(recs) == _fq(jsam2cfq.sam_to_cfq(lines))
    assert [r.comment for r in recs] == ["SCORE:100;100,NC_1.1;", "SCORE:0;", "SCORE:4;4,562;"]
    assert recs[2].seq == "ACGT"[::-1].translate(str.maketrans("ACGT", "TGCA"))


def test_sam2cfq_random():
    """Random SAM lines: secondary/supplementary skipped, reverse strand,
    AS or CIGAR+NM scores, XA alternates under several dropouts."""
    rng = np.random.default_rng(11)
    lines = ["@HD\tVN:1.6", "@SQ\tSN:chr1\tLN:5000"]
    for i in range(80):
        flag = int(rng.choice([0, 16, 4, 256, 2048, 16 | 64, 128]))
        L = int(rng.integers(20, 60))
        m = L - 4
        cigar = rng.choice([f"{L}M", f"2S{m}M2S", f"{L // 2}M2D{L - L // 2}M",
                            f"{L // 2}M1I{L - L // 2 - 1}M"])
        rname = rng.choice(["chr1", "kraken:taxid|562|x", "NC_9.1", "*"])
        opts = [f"NM:i:{int(rng.integers(0, 5))}"]
        if rng.random() < 0.5:
            opts.append(f"AS:i:{int(rng.integers(0, L))}")
        if rng.random() < 0.5:
            alts = ";".join(f"{rng.choice(['chr2', 'kraken:taxid|9606|h'])},+{int(rng.integers(1, 900))},"
                            f"{L}M,{int(rng.integers(0, 6))}" for _ in range(int(rng.integers(1, 4))))
            opts.append(f"XA:Z:{alts};")
        seq = "".join(rng.choice(list("ACGTN"), L))
        lines.append("\t".join([f"q{i}", str(flag), rname, "10", "60", cigar, "*", "0", "0",
                                seq, "".join(rng.choice(list("!#5?I"), L)), *opts]))
    for dropout in (0.95, 0.5, 1.0):
        assert _fq(sam2cfq.sam_to_cfq(lines, dropout)) == _fq(jsam2cfq.sam_to_cfq(lines, dropout))


# ---------------------------------------------------------------------------
# utils/accuracy.py and the reference binaries' goldens
# (tests/test_eval_golden.py, tests/test_extras.py:108)
# ---------------------------------------------------------------------------
def test_accuracy_eval():
    db, jdb = _dbs(1024)
    lines = ["read_ecoli_1\t0\t150\t*\t*\t150,562", "read_ecoli_2\t0\t150\t*\t*\t150,28901",
             "read_salm_1\t0\t20\t*\t*\t20,28901", "nobody\t0\t99\t*\t*\t99,562"]
    truth = {"read_ecoli_1": 562, "read_ecoli_2": 562, "read_salm_1": 28901}
    port, ref = _both_lsam(lines)
    for kw in ({}, {"score_threshold": 10}, {"match_at_species": False}):
        st = accuracy.evaluate(port, truth.get, db, **kw)
        jst = jaccuracy.evaluate(ref, truth.get, jdb, **kw)
        assert (st.tp, st.fp, st.fn, st.unclassified, st.sensitivity, st.fdr) == (
            jst.tp, jst.fp, jst.fn, jst.unclassified, jst.sensitivity, jst.fdr)
    st = accuracy.evaluate(port, truth.get, db)
    assert (st.tp, st.fn, st.fp) == (1, 2, 1) and 0 < st.sensitivity < 1


@pytest.mark.parametrize("tool,golden", [
    ("m8_cov", "eval_cov.golden"),
    ("maplen_fasta", "eval_hist.golden"),
    ("maplen", "eval_hist_nofa.golden"),
])
def test_m8_tools_byte_parity(tool, golden):
    outs = []
    for mod in (accuracy, jaccuracy):
        with open(FIX / "eval_in.m8") as f:
            if tool == "m8_cov":
                outs.append(mod.m8_coverage(f))
            elif tool == "maplen_fasta":
                outs.append(mod.maplen_stats(f, ref_fa=FIX / "eval_ref.fa",
                                             contig_fa=FIX / "eval_q.fa"))
            else:
                outs.append(mod.maplen_stats(f))
    assert outs[0] == outs[1] == (FIX / golden).read_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_m8_tools_random(seed):
    rows = random_m8(np.random.default_rng(seed), 90)
    assert accuracy.m8_coverage(rows) == jaccuracy.m8_coverage(rows)
    assert accuracy.maplen_stats(rows) == jaccuracy.maplen_stats(rows)


def test_count_table_byte_parity():
    db, jdb = _dbs(3_000_000, acc2tid=False)
    port = [r for r in lsam.read_lsam(FIX / "golden.lsam.id") if r.score >= 40]
    ref = [r for r in jlsam.read_lsam(FIX / "golden.lsam.id") if r.score >= 40]
    got = accuracy.count_table(db, port)
    assert got == jaccuracy.count_table(jdb, ref)
    assert got == (FIX / "eval_counttable.golden").read_text()


@pytest.mark.parametrize("seed", [0, 1])
def test_count_table_random(seed):
    db, jdb = _dbs(1024, acc2tid=False)
    port, ref = _both_lsam(random_lsam_pairs(np.random.default_rng(seed), 70))
    assert accuracy.count_table(db, port) == jaccuracy.count_table(jdb, ref)


# ---------------------------------------------------------------------------
# taxonomy/report.py japsa_to_kraken (tests/test_taxonomy.py:81)
# ---------------------------------------------------------------------------
def test_japsa_to_kraken():
    db = port_mini_taxdb()
    _, jdb = _dbs(1024)
    lines = ["header\tcols\there\tx\ttaxid\ty\tz\tw\taligned",
             "a\tb\tc\td\t562\te\tf\tg\t3", "a\tb\tc\td\t694009\te\tf\tg\t2",
             "a\tb\tc\td\tnot-a-taxid\te\tf\tg\t2", "short\trow",
             "a\tb\tc\td\t9606\te\tf\tg\t0", "a\tb\tc\td\t11137.0\te\tf\tg\t4.0"]
    out = report.japsa_to_kraken(db, lines)
    assert out == jreport.japsa_to_kraken(jdb, lines)
    assert "Escherichia coli" in out
    rows = {l.split("\t")[4]: l.split("\t") for l in out.splitlines()[1:]}
    assert rows["562"][1] == "3"
    csv = [l.replace("\t", ",") for l in lines]
    assert report.japsa_to_kraken(db, csv, delimiter=",") == jreport.japsa_to_kraken(
        jdb, csv, delimiter=",")
