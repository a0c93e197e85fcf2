"""The port's offline reference-DB tools (``index/dbtools.py``) against the
JAX package's on the same records: the twins of the dbtools tests in
``tests/test_index.py`` and ``tests/test_assembly.py``, plus random
records drawn from a seed. Outputs are compared whole: every record's
name, sequence, quality and comment."""

import pathlib

import numpy as np
import pytest

from megapath_tpu.index import dbtools as jdb
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.io.fastq import FastqRecord as JRec
from megapath_tpu.taxonomy.taxdb import TaxDB as JTaxDB
from megapath_tpu_torch.index import dbtools
from megapath_tpu_torch.index.pack import pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.taxonomy.taxdb import TaxDB
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"


def _recs(rows):
    """The same (name, seq, qual, comment) rows as each package's records."""
    return [FastqRecord(*r) for r in rows], [JRec(*r) for r in rows]


def _fq(recs) -> list:
    return [(r.name, r.seq, r.qual, r.comment) for r in recs]


@pytest.fixture(scope="module")
def taxdbs():
    out = []
    for cls in (TaxDB, JTaxDB):
        db = cls(size=1024)
        db.read_nodes(FIX / "nodes.dmp")
        db.read_names(FIX / "names.dmp")
        db.read_acc2tid(FIX / "acc2tid.map")
        out.append(db)
    return out


def random_rows(rng: np.random.Generator, n: int) -> list:
    """FASTA/FASTQ rows with soft-masked bases, N, repeats of earlier
    sequences and accession-style names."""
    rows = []
    for i in range(n):
        if rows and rng.random() < 0.2:
            seq = rows[int(rng.integers(0, len(rows)))][1]
        else:
            seq = "".join(rng.choice(list("ACGTacgtN"), int(rng.integers(1, 40))))
        qual = "".join(rng.choice(list("!5?I"), len(seq))) if i % 2 else ""
        name = f"NC_{int(rng.integers(0, 6)):06d}.{i % 3 + 1}"
        if i % 5 == 0:
            name += "/1" if i % 10 == 0 else "/2"
        rows.append((name, seq, qual, f"desc {i}" if i % 3 else ""))
    return rows


def test_mask_dedup_kraken_prefix():
    """tests/test_assembly.py:82's twin."""
    port, ref = _recs([("NC_1.1", "ACgtAC", "", "")])
    got = dbtools.mask_lowercase_with_n(port[0])
    assert _fq([got]) == _fq([jdb.mask_lowercase_with_n(ref[0])])
    assert got.seq == "ACNNAC"
    rows = [("a", "ACGT", "", ""), ("b", "ACGT", "", ""), ("c", "GGGG", "", "")]
    port, ref = _recs(rows)
    assert _fq(dbtools.dedup_sequences(port)) == _fq(jdb.dedup_sequences(ref))
    assert [r.name for r in dbtools.dedup_sequences(port)] == ["a", "c"]
    port, ref = _recs([("NC_1.1", "AC", "", ""), ("NC_2.1", "GG", "", "x")])
    got = list(dbtools.prepare_kraken_fasta(port, {"NC_1": 562}))
    assert _fq(got) == _fq(jdb.prepare_kraken_fasta(ref, {"NC_1": 562}))
    assert got[0].name == "kraken:taxid|562|NC_1.1" and got[1].name == "NC_2.1"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_transforms_random(seed):
    """Masking, interval masking, dedup, existing-name filter, Kraken
    prefixes, reference chopping, reverse complement and smart pairing
    on random records."""
    rng = np.random.default_rng(seed)
    rows = random_rows(rng, 40)
    port, ref = _recs(rows)
    assert _fq(map(dbtools.mask_lowercase_with_n, port)) == _fq(map(jdb.mask_lowercase_with_n, ref))
    iv = [(int(a), int(a) + int(b)) for a, b in rng.integers(-3, 30, (4, 2))]
    assert _fq(dbtools.mask_intervals_with_n(r, iv) for r in port) == _fq(
        jdb.mask_intervals_with_n(r, iv) for r in ref)
    assert _fq(dbtools.dedup_sequences(port)) == _fq(jdb.dedup_sequences(ref))
    existing = {"NC_000001", "NC_000004"}
    assert _fq(dbtools.filter_existing(port, existing)) == _fq(jdb.filter_existing(ref, existing))
    acc = {"NC_000002": 562, "NC_000003": 9606}
    assert _fq(dbtools.prepare_kraken_fasta(port, acc)) == _fq(jdb.prepare_kraken_fasta(ref, acc))
    for read_len, overlap in ((4, 3), (7, 5), (50, 10)):
        assert _fq(dbtools.split_ref_to_reads(port, read_len, overlap)) == _fq(
            jdb.split_ref_to_reads(ref, read_len, overlap))
    assert _fq(dbtools.revcomp_fastx(port)) == _fq(jdb.revcomp_fastx(ref))
    port, ref = _recs(sorted(rows))
    pairs, singles = dbtools.smart_pairing(port)
    jpairs, jsingles = jdb.smart_pairing(ref)
    assert _fq(pairs) == _fq(jpairs) and _fq(singles) == _fq(jsingles)


def test_split_ref_to_reads():
    """tests/test_index.py:152's twin."""
    port, ref = _recs([("ctg", "ACGTACGTAC", "", "")])
    out = list(dbtools.split_ref_to_reads(port, read_len=4, overlap=3))
    assert _fq(out) == _fq(jdb.split_ref_to_reads(ref, read_len=4, overlap=3))
    assert [r.name for r in out] == ["ctg_0", "ctg_3", "ctg_6"]
    assert [r.seq for r in out] == ["ACGT", "TACG", "GTAC"]
    out = list(dbtools.split_ref_to_reads(port, read_len=7, overlap=5))
    assert _fq(out) == _fq(jdb.split_ref_to_reads(ref, read_len=7, overlap=5))
    # the final window flushes to the sequence end
    assert [r.name for r in out] == ["ctg_0", "ctg_3"]
    assert [r.seq for r in out] == ["ACGTACG", "TACGTAC"]


def test_revcomp_fastx():
    port, ref = _recs([("r", "ACGTN", "IJKLM", "")])
    out = list(dbtools.revcomp_fastx(port))
    assert _fq(out) == _fq(jdb.revcomp_fastx(ref))
    assert out[0].seq == "NACGT" and out[0].qual == "MLKJI"


def test_smart_pairing():
    rows = [("a/1", "AC", "II", ""), ("a/2", "GT", "II", ""), ("b/1", "CC", "II", ""),
            ("c/1", "GG", "II", ""), ("c/2", "TT", "II", "")]
    port, ref = _recs(rows)
    pairs, singles = dbtools.smart_pairing(port)
    jpairs, jsingles = jdb.smart_pairing(ref)
    assert _fq(pairs) == _fq(jpairs) and _fq(singles) == _fq(jsingles)
    assert [r.name for r in pairs] == ["a", "a", "c", "c"]
    assert [r.name for r in singles] == ["b"]


@pytest.mark.parametrize("header,want", [
    ("gi|123|ref|NC_000913.3| E coli", ["NC_000913"]),
    ("NC_000913.3 first\x01NC_003197.2 second", ["NC_000913", "NC_003197"]),
    ("gnl|uv|U12345.1:1-100", ["U12345"]),
    ("gnl|uv|U12345.1", ["U12345"]),
    ("gi|1|emb|X1.1|\x01gi|2|gb|Y2.2| two", ["X1", "Y2"]),
    ("NC_1.1\x01gi|9|ref|NC_2.1|\x01NC_3", ["NC_1", "NC_2", "NC_3"]),
    ("AC001.1", ["AC001"]),
    ("", [""]),
])
def test_header2acc(header, want):
    assert dbtools.header2acc(header) == jdb.header2acc(header) == want


def test_db_construction_tools(taxdbs):
    """tests/test_index.py:235's twin: createDB, filterDB,
    selectSameSpecieGenome and surpiAnn2id."""
    db, jtax = taxdbs
    nt = [("NC_000913.3", "ACGTACGT", "", "E coli genome"),
          ("UNKNOWN.1", "ACGTACGT", "", "no taxid"),
          ("gi|5|ref|NC_045512.2|", "GGTT", "", "")]
    uv = [("gnl|uv|U12345.1:1-10", "GGGG", "", "")]
    hg = [("NC_000001.11", "TTTT", "", "")]
    port = [_recs(r)[0] for r in (nt, uv, hg)]
    ref = [_recs(r)[1] for r in (nt, uv, hg)]
    out = list(dbtools.create_db(*port, db))
    assert _fq(out) == _fq(jdb.create_db(*ref, jtax))
    assert [r.name for r in out] == ["NC_000913", "NC_045512", "U12345", "NC_000001"]

    rows = [("NC_000913.3", "ACGT", "", ""), ("NC_045512.2", "ACGT", "", ""),
            ("NC_003197.1", "ACGT", "", "")]
    port, ref = _recs(rows)
    name913 = db.name_of(db.pop_to_species(db.acc2tid["NC_000913"]))
    for names in ([name913], ["Enterobacteriaceae"], ["Viruses", "Homo sapiens"], []):
        kept = list(dbtools.filter_db(port, db, names))
        assert _fq(kept) == _fq(jdb.filter_db(ref, jtax, names))
    assert [r.name for r in dbtools.filter_db(port, db, [name913])] == [
        "NC_045512.2", "NC_003197.1"]

    tid913 = db.acc2tid["NC_000913"]
    rows = [("NC_000913.3", "AAAA", "", "strain 1, complete genome"),
            ("NC_000913.2", "CCCC", "", "strain 2, complete genome"),
            ("NC_000913.1", "GGGG", "", "partial cds"),
            ("NC_003197.1", "TTTT", "", "complete genome")]
    port, ref = _recs(rows)
    for seed in (10086, 1, 2):
        targets = [tid913, db.acc2tid["NC_003197"], 9606]
        sel = dbtools.select_same_species_genome(port, db, targets, seed=seed)
        assert _fq(sel) == _fq(jdb.select_same_species_genome(ref, jtax, targets, seed=seed))
    sel = dbtools.select_same_species_genome(port, db, [tid913])
    assert len(sel) == 1 and "complete genome" in sel[0].comment

    name = db.name_of(db.pop_to_species(tid913))
    lines = [f"ACC1#junk\tfoo\tspecies--{name}\tbar", "ACC2\tspecies--Nobody here",
             "ACC3#a#b\tgenus--Escherichia\tspecies--Homo sapiens", "ACC4"]
    out = list(dbtools.surpi_ann2id(FIX / "names.dmp", lines))
    assert out == list(jdb.surpi_ann2id(FIX / "names.dmp", lines))
    assert out[0] == f"ACC1\t{db.pop_to_species(tid913)}" and out[2] == "ACC3#a\t9606"


def test_kraken_censtruct_and_extract_region(capsys):
    rows = [("seqA", "ACGTACGTAC", "", ""), ("seqB", "GGGGCCCC", "", "")]
    port, ref = _recs(rows)
    out = list(dbtools.kraken_censtruct(port, seqid2taxid={"seqA": 7}))
    port_err = capsys.readouterr().err
    assert _fq(out) == _fq(jdb.kraken_censtruct(ref, seqid2taxid={"seqA": 7}))
    assert port_err == capsys.readouterr().err == "Error: cannot find taxid for seqB\n"
    assert [r.name for r in out] == ["seqA|kraken:taxid|7"]
    out = list(dbtools.kraken_censtruct(port, taxid=99))
    assert _fq(out) == _fq(jdb.kraken_censtruct(ref, taxid=99))
    assert [r.name for r in out] == ["seqA|kraken:taxid|99", "seqB|kraken:taxid|99"]
    for kw in ({}, {"seqid2taxid": {}, "taxid": 1}):
        with pytest.raises(ValueError, match="exactly one"):
            list(dbtools.kraken_censtruct(port, **kw))

    packed, jpacked = pack_fasta(port), jpack_fasta(ref)
    for name, a, b in (("seqB", 2, 6), ("seqA", 8, 99), ("seqA", -5, 3), ("seqB", 7, 2)):
        got = dbtools.extract_region(packed, name, a, b)
        assert got == jdb.extract_region(jpacked, name, a, b)
    assert dbtools.extract_region(packed, "seqB", 2, 6) == "GGCC"
    assert dbtools.extract_region(packed, "seqA", 8, 99) == "AC"
