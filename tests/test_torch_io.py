"""The port's input and output modules against the JAX package's: the C++
FASTQ reader and the stream, the index files, the host traceback, SAM and
BAM. Twins of ``tests/test_native.py``, ``tests/test_index.py:140``,
``tests/test_sam.py`` and ``tests/test_bam.py``. Every check is exact."""

import gzip
import io
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
import megapath_tpu.native.build as jbuild
import megapath_tpu.ops.dp as jdp
from megapath_tpu.align import AlignEngine as JEngine
from megapath_tpu.align import AlignParams as JParams
from megapath_tpu.align import MmpParams as JMmp
from megapath_tpu.index.fm import FMIndex as JFMIndex
from megapath_tpu.index.fm import build_fm_index as jbuild_fm_index
from megapath_tpu.index.pack import PackedReference as JRef
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.io import bam as jbam
from megapath_tpu.io import sam as jsam
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu.io.stream import stream_read_pairs as jstream
from megapath_tpu_torch import native
from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.params import AlignParams, MmpParams
from megapath_tpu_torch.index.fm import FMIndex, build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, PackedReference, decode_seq, pack_fasta
from megapath_tpu_torch.io import bam as tbam
from megapath_tpu_torch.io import sam as tsam
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.io.stream import stream_read_pairs
from megapath_tpu_torch.ops import dp as tdp
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the C++ FASTQ reader and the stream
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_fastq_lib(tmp_path, monkeypatch):
    """The JAX package's reader, its library built from its own source into
    this test's directory (a shared build path races between workers)."""
    monkeypatch.setattr(jbuild, "_FQ_SO", str(tmp_path / "_fastq.so"))
    monkeypatch.setattr(jbuild, "_fq_lib", None)
    monkeypatch.setattr(jbuild, "_fq_tried", False)
    assert jbuild.load_fastq_lib() is not None
    return jbuild.NativeFastqReader


def _fastq_text(n: int, seed: int, mate: int = 1) -> str:
    """``n`` records: random lengths 1-70 (max_len 48 cuts some), N and
    lower-case bases, /1-style suffixes, comments after a space or a tab,
    and one name longer than the reader's 96-byte cap."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name = f"read{i}" if i != 3 else "long_" + "x" * 120
        head = name + (f"/{mate}" if i % 3 else "") + (" c=1" if i % 4 == 1 else "") \
            + ("\tSCORE:1;" if i % 5 == 2 else "")
        L = int(rng.integers(1, 71))
        seq = "".join(rng.choice(list("ACGTNacgt"), L))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, L))
        out.append(f"@{head}\n{seq}\n+\n{qual}\n")
    return "".join(out)


def _write(path, text: str):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


@pytest.mark.parametrize("suffix", [".fq", ".fq.gz"])
@pytest.mark.parametrize("cap", [5, 7, 23, 50])
def test_native_reader_batches_equal_jax(tmp_path, jax_fastq_lib, suffix, cap):
    p = _write(tmp_path / f"r{suffix}", _fastq_text(23, 1))
    with native.NativeFastqReader(p, max_len=48) as ours, jax_fastq_lib(str(p), 48) as ref:
        n_batches = 0
        while True:
            got, want = ours.next_batch(cap), ref.next_batch(cap)
            for g, w in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(g, w)
            assert got[4] == want[4]
            if not got[4]:
                break
            n_batches += 1
    assert n_batches == -(-23 // cap)


def test_native_reader_cuts_names_and_reads(tmp_path):
    p = _write(tmp_path / "r.fq.gz", _fastq_text(6, 2))
    with native.NativeFastqReader(p, max_len=48) as r:
        codes, lens, quals, seqs, names = r.next_batch(10)
    assert names[3] == ("long_" + "x" * 120)[: native.NativeFastqReader.NAME_CAP - 1]
    assert names[1] == "read1" and names[2] == "read2"  # /1 and the comment dropped
    assert lens.max() <= 48


@pytest.mark.parametrize("as_files", [False, True])
def test_stream_read_pairs_equal_jax(tmp_path, jax_fastq_lib, as_files):
    """Paths go through the C++ reader, file objects through the Python
    reader, in both packages."""
    p1 = _write(tmp_path / "r1.fq.gz", _fastq_text(19, 3, mate=1))
    p2 = _write(tmp_path / "r2.fq.gz", _fastq_text(19, 4, mate=2))

    def batches(fn):
        a = (gzip.open(p1, "rt"), gzip.open(p2, "rt")) if as_files else (p1, p2)
        return list(fn(*a, batch_size=7, max_len=48))

    got, want = batches(stream_read_pairs), batches(jstream)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in ("names", "seqs1", "quals1", "seqs2", "quals2"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("reads1", "lens1", "reads2", "lens2"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_reader_build_failure_raises(tmp_path, monkeypatch):
    """No fallback to the Python reader: a C++ reader that cannot be built
    raises."""
    def fail(name, force=False):
        raise RuntimeError(f"g++ failed on {name}.cpp")

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "build", fail)
    p1 = _write(tmp_path / "r1.fq", _fastq_text(3, 5))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on fastq.cpp"):
        list(stream_read_pairs(p1, p1, batch_size=2))


# ---------------------------------------------------------------------------
# index files (tests/test_index.py:140)
# ---------------------------------------------------------------------------
def test_fm_save_load_roundtrip(tmp_path):
    codes = np.random.default_rng(13).integers(0, 4, 400).astype(np.uint8)
    fm = build_fm_index(codes, sa_interval=4, lut_k=4, device=CPU)
    p = str(tmp_path / "fm.npz")
    fm.save(p)
    fm2 = FMIndex.load(p)
    rows = np.arange(1, fm.n + 1, 7)
    np.testing.assert_array_equal(fm.locate(rows), fm2.locate(rows))
    assert fm2.lut_k == 4
    for f in ("bwt_words", "occ", "counts", "sa_sampled", "mark_rank", "lut_lo", "lut_hi"):
        a, b = getattr(fm, f), getattr(fm2, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("lut_k", [0, 5])
def test_index_files_load_across_packages(tmp_path, lut_k):
    """A file either package writes loads in the other with equal arrays
    (an absent k-mer table included)."""
    rng = np.random.default_rng(lut_k)
    seqs = [("s1", "first desc", "".join(rng.choice(list("ACGTN"), 700))),
            ("s2", "", "".join(rng.choice(list("ACGT"), 500)))]
    ref = pack_fasta([FastqRecord(n, s, "", d) for n, d, s in seqs])
    jref = jpack_fasta([JRecord(n, s, "", d) for n, d, s in seqs])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=lut_k, device=CPU)
    jfm = jbuild_fm_index(jref.codes, sa_interval=4, lut_k=lut_k)
    ref.save(str(tmp_path / "t.ref.npz"))
    fm.save(str(tmp_path / "t.fm.npz"))
    jref.save(str(tmp_path / "j.ref.npz"))
    jfm.save(str(tmp_path / "j.fm.npz"))
    pairs = [(JRef.load(str(tmp_path / "t.ref.npz")), jref),
             (PackedReference.load(str(tmp_path / "j.ref.npz")), ref)]
    for got, want in pairs:
        assert got.names == want.names and got.annotations == want.annotations
        for f in ("codes", "offsets", "ambiguous"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for got, want in ((JFMIndex.load(str(tmp_path / "t.fm.npz")), jfm),
                      (FMIndex.load(str(tmp_path / "j.fm.npz")), fm)):
        assert (got.n, got.primary, got.sa_interval, got.lut_k) == (
            want.n, want.primary, want.sa_interval, want.lut_k)
        fields = ["bwt_words", "occ", "counts", "sa_sampled", "mark_rank"]
        fields += ["lut_lo", "lut_hi"] if lut_k else []
        for f in fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        if not lut_k:
            assert got.lut_lo is None and got.lut_hi is None
    pos = np.array([0, 650, 700, 1199])
    for a, b in zip(ref.local_pos(pos), jref.local_pos(pos)):
        np.testing.assert_array_equal(a, b)
    assert ref.n_seqs == jref.n_seqs == 2
    # the same container: one deflated <key>.npy member an array, as
    # np.savez_compressed writes (only the zlib level differs)
    for kind in ("ref", "fm"):
        with zipfile.ZipFile(tmp_path / f"t.{kind}.npz") as t, \
                zipfile.ZipFile(tmp_path / f"j.{kind}.npz") as j:
            assert t.namelist() == j.namelist()
            assert {i.compress_type for i in t.infolist()} == {zipfile.ZIP_DEFLATED}


# ---------------------------------------------------------------------------
# the host traceback
# ---------------------------------------------------------------------------
def _traceback_batch(seed: int, C: int, R: int, W: int, edge: bool):
    """Planted candidates traced back from the forward DP's end cells;
    with ``edge`` the windows stop early and the rest is 255 (never
    matches), as hits_to_sam fills a window that runs past the text."""
    rng = np.random.default_rng(seed)
    reads, wins, rl, wl = cs.planted_batch(rng, C, R, W)
    if edge:
        for b in range(C):
            wins[b, wl[b]:] = 255
    dp_wins = np.where(wins == 255, tdp.OFF_TEXT_CODE, wins).astype(np.uint8)
    fwd = tdp.sw_align(*(torch.from_numpy(a) for a in (reads, dp_wins, rl, wl)))
    return reads, wins, fwd.end_ref.numpy().astype(np.int64), fwd.end_read.numpy().astype(np.int64)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("chunk_bytes", [256 << 20, 3000])
def test_traceback_batch_equals_jax(edge, chunk_bytes):
    """Equal to the JAX function on seeded and edge batches, in one chunk
    and over chunk boundaries (3,000 bytes: 3 rows a chunk at 40 x 24)."""
    reads, wins, er, ej = _traceback_batch(7 + edge, 17, 24, 40, edge)
    got = tdp.sw_traceback_batch(reads, wins, er, ej, chunk_bytes=chunk_bytes)
    want = jdp.sw_traceback_batch(reads, wins, er, ej, chunk_bytes=chunk_bytes)
    for g, w in zip(got, want):
        if isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def test_traceback_batch_equals_ops_row_by_row():
    reads, wins, er, ej = _traceback_batch(9, 12, 24, 40, edge=True)
    sr, sj, cigars, edits = tdp.sw_traceback_batch(reads, wins, er, ej)
    for b in range(len(er)):
        i, j, ops = tdp.sw_traceback_ops(reads[b], wins[b], er[b], ej[b])
        assert (sr[b], sj[b]) == (i, j)
        assert cigars[b] == tdp._runlength(ops)
        assert edits[b] == sum(o in "XID" for o in ops)
        assert tdp.sw_traceback(reads[b], wins[b], er[b], ej[b]) == jdp.sw_traceback(
            reads[b], wins[b], er[b], ej[b])


# ---------------------------------------------------------------------------
# SAM (tests/test_sam.py)
# ---------------------------------------------------------------------------
def test_bwa_mapq_tables_equal_jax():
    for x0 in range(4):
        for x1 in (0, 1, 2, 7, 254, 255, 300):
            assert tsam.bwa_single_mapq(x0, x1) == jsam.bwa_single_mapq(x0, x1)
    cases = [(1, 0, 1, 0, 160, 1, 0, 0, 80, 80), (2, 0, 1, 0, 160, 1, 0, 0, 80, 80),
             (2, 0, 1, 0, 160, 1, 100, 1, 80, 80), (2, 0, 1, 0, 160, 1, 158, 1, 80, 80),
             (2, 0, 1, 0, 160, 2, 0, 0, 80, 80), (1, 3, 2, 1, 150, 1, 149, 4, 75, 90)]
    for c in cases:
        assert tsam.bwa_pair_mapq(*c) == jsam.bwa_pair_mapq(*c)
    assert tsam.bwa_pair_mapq(2, 0, 1, 0, 160, 1, 0, 0, 80, 80) == (36, 37)
    assert tsam._end_hit_counts([5, 5, 3, 3, 3], [1, 2, 4, 4, 6]) == (2, 2)


def _sam_world():
    """tests/test_sam.py's world: a 5 kbp sequence, 4 pairs at insert
    300, plus 4 pairs with substitutions and a read of other length."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    n, L, ins = 8, 80, 300
    reads1 = np.zeros((n, L), np.uint8)
    reads2 = np.zeros((n, L), np.uint8)
    for b in range(n):
        p = 100 + 550 * b
        reads1[b] = codes[p : p + L]
        reads2[b] = COMPLEMENT[codes[p + ins - L : p + ins][::-1]]
        if b >= 4:
            reads1[b, 10 * b % L] ^= 1
            reads2[b, 7 * b % L] ^= 2
    lens1 = np.full(n, L, np.int32)
    lens2 = lens1.copy()
    lens2[5] = 61
    return codes, reads1, lens1, reads2, lens2


def test_hits_to_sam_equals_jax(monkeypatch):
    """The port's SAM lines over the port engine's hits equal the JAX
    lines over the JAX engine's, and each package's batched traceback ran
    once, on every emitted hit (no row took the per-row catch-all)."""
    codes, reads1, lens1, reads2, lens2 = _sam_world()
    ref = pack_fasta([FastqRecord("chrT", decode_seq(codes), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)
    jref = jpack_fasta([JRecord("chrT", decode_seq(codes), "", "")])
    jfm = jbuild_fm_index(jref.codes, sa_interval=4, lut_k=6)
    mmp = dict(seed_min_length=12, reseed_len=13, good_seed_len=18)
    hits = AlignEngine(ref, fm, AlignParams(insert_high=400, mmp=MmpParams(**mmp)),
                       device=CPU).align_pairs(reads1, lens1, reads2, lens2)
    jhits = JEngine(jref, jfm, JParams(insert_high=400, mmp=JMmp(**mmp))).align_pairs(
        reads1, lens1, reads2, lens2)
    calls = {"port": [], "jax": []}

    def counting(key, fn):
        def run(reads, *a, **k):
            calls[key].append(len(reads))
            return fn(reads, *a, **k)
        return run

    monkeypatch.setattr(tsam, "sw_traceback_batch", counting("port", tsam.sw_traceback_batch))
    monkeypatch.setattr(jdp, "sw_traceback_batch", counting("jax", jdp.sw_traceback_batch))
    names = [f"rd{i}" for i in range(8)]
    quals = ["".join(chr(40 + (i + j) % 30) for j in range(80)) for i in range(8)]
    got = list(tsam.hits_to_sam(hits, ref, names, reads1, lens1, reads2, lens2,
                                quals1=quals, quals2=quals))
    want = list(jsam.hits_to_sam(jhits, jref, names, reads1, lens1, reads2, lens2,
                                 quals1=quals, quals2=quals))
    assert got == want and len(got) >= 16
    assert calls["port"] == calls["jax"] == [len(got)]
    buf, jbuf = io.StringIO(), io.StringIO()
    tsam.write_sam(buf, hits, ref, names, reads1, lens1, reads2, lens2)
    jsam.write_sam(jbuf, jhits, jref, names, reads1, lens1, reads2, lens2)
    assert buf.getvalue() == jbuf.getvalue()
    assert tsam.sam_header(ref) == jsam.sam_header(jref)


# ---------------------------------------------------------------------------
# BAM (tests/test_bam.py)
# ---------------------------------------------------------------------------
HEADER = (
    "@HD\tVN:1.6\tSO:unsorted\n"
    "@SQ\tSN:chr1\tLN:10000\n"
    "@SQ\tSN:chr2\tLN:5000\n"
    "@PG\tID:megapath-tpu\tPN:megapath-tpu\n"
)
LINES = [
    "r1\t99\tchr1\t100\t60\t50M\t=\t300\t250\t" + "A" * 50 + "\t" + "I" * 50 + "\tAS:i:48",
    "r1\t147\tchr1\t300\t60\t10S40M\t=\t100\t-250\t" + "C" * 50 + "\t" + "J" * 50 + "\tAS:i:40",
    "r2\t77\t*\t0\t0\t*\t*\t0\t0\tACGTN\tIIIII\tAS:i:0",
    "r3\t0\tchr2\t17\t13\t5M2I3M1D5M\t*\t0\t0\t" + "G" * 15 + "\t" + "K" * 15
    + "\tAS:i:9\tXX:Z:hello",
]


def test_bgzf_valid_and_block_walk():
    buf = io.BytesIO()
    w = tbam.BgzfWriter(buf)
    payload = bytes(range(256)) * 2000  # several 64 KB blocks
    w.write(payload)
    w.close()
    data = buf.getvalue()
    assert gzip.decompress(data) == payload == tbam.bgzf_decompress(data)
    pos, nblocks = 0, 0
    while pos < len(data):  # BSIZE + 1 bytes a block, as htslib walks them
        assert data[pos : pos + 4] == b"\x1f\x8b\x08\x04"
        xlen = struct.unpack("<H", data[pos + 10 : pos + 12])[0]
        bsize = struct.unpack("<H", data[pos + 16 : pos + 18])[0]
        block = data[pos : pos + bsize + 1]
        chunk = zlib.decompress(block[12 + xlen : -8], -15)
        crc, isize = struct.unpack("<II", block[-8:])
        assert len(chunk) == isize and zlib.crc32(chunk) == crc
        pos += bsize + 1
        nblocks += 1
    assert nblocks >= 8


def test_bam_roundtrip_equals_jax():
    buf, jbuf = io.BytesIO(), io.BytesIO()
    tbam.write_bam(buf, HEADER, LINES)
    jbam.write_bam(jbuf, HEADER, LINES)
    assert tbam.bgzf_decompress(buf.getvalue()) == jbam.bgzf_decompress(jbuf.getvalue())
    for b in (buf, jbuf):
        b.seek(0)
    assert tbam.read_bam(buf) == jbam.read_bam(jbuf) == (HEADER, LINES)


def _rec(name, ref, pos):
    return "\t".join([name, "0", ref, str(pos), "60", "4M", "*", "0", "0", "ACGT", "IIII"])


def test_sort_and_merge_bams_equal_jax():
    header = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chr2\tLN:500\n"
    parts = [[_rec("a", "chr2", 5), _rec("b", "chr1", 100)],
             [_rec("c", "chr1", 7), _rec("d", "chr2", 2), _rec("e", "*", 0)]]
    outs = []
    for mod in (tbam, jbam):
        ins = []
        for lines in parts:
            b = io.BytesIO()
            mod.write_bam(b, header, lines)
            b.seek(0)
            ins.append(b)
        out = io.BytesIO()
        mod.merge_bams(ins, out)
        out.seek(0)
        outs.append(mod.read_bam(out))
    assert outs[0] == outs[1]
    h, lines = outs[0]
    assert [l.split("\t")[0] for l in lines] == ["c", "b", "d", "a", "e"]
    assert tbam.sort_sam_lines(h, lines) == lines


def test_merge_shard_bams_equals_jax():
    """Shard BAMs with disjoint references: the @SQ union in input order,
    re-sorted under it."""
    hs = ["@HD\tVN:1.6\n@SQ\tSN:s1\tLN:900\n@PG\tID:x\n", "@HD\tVN:1.6\n@SQ\tSN:s2\tLN:800\n"]
    parts = [[_rec("a", "s1", 50), _rec("b", "s1", 5)], [_rec("c", "s2", 1)]]
    outs = []
    for mod in (tbam, jbam):
        ins = []
        for h, lines in zip(hs, parts):
            b = io.BytesIO()
            mod.write_bam(b, h, lines)
            b.seek(0)
            ins.append(b)
        out = io.BytesIO()
        mod.merge_shard_bams(ins, out)
        out.seek(0)
        outs.append(mod.read_bam(out))
    assert outs[0] == outs[1]
    assert [l.split("\t")[0] for l in outs[0][1]] == ["b", "a", "c"]


def test_merge_refuses_mismatched_headers():
    def bam(h):
        b = io.BytesIO()
        tbam.write_bam(b, h, [])
        b.seek(0)
        return b

    with pytest.raises(ValueError, match="differ"):
        tbam.merge_bams([bam("@SQ\tSN:chr1\tLN:1000\n"), bam("@SQ\tSN:chrX\tLN:99\n")],
                        io.BytesIO())
    with pytest.raises(ValueError, match="conflicting LN"):
        tbam.merge_shard_bams([bam("@SQ\tSN:chr1\tLN:1000\n"), bam("@SQ\tSN:chr1\tLN:99\n")],
                              io.BytesIO())


def test_bam_of_the_engines_sam_roundtrips():
    codes, reads1, lens1, reads2, lens2 = _sam_world()
    ref = pack_fasta([FastqRecord("g1", decode_seq(codes), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)
    hits = AlignEngine(ref, fm, AlignParams(), device=CPU).align_pairs(
        reads1, lens1, reads2, lens2)
    names = [f"q{i}" for i in range(8)]
    sam_lines = list(tsam.hits_to_sam(hits, ref, names, reads1, lens1, reads2, lens2))
    assert sam_lines
    buf = io.BytesIO()
    tbam.write_bam(buf, tsam.sam_header(ref), sam_lines)
    buf.seek(0)
    header, out_lines = tbam.read_bam(buf)
    assert header == tsam.sam_header(ref)
    assert out_lines == sam_lines
