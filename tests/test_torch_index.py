"""The port's own host index and input modules (``megapath_tpu_torch.index``
and ``.io``) against the reference's ``megapath_tpu.index`` and
``megapath_tpu.io.fastq``, and the chip smoke's toy workload against the
bench's. Every check is exact."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import bench
from chip_smoke import toy_workload, workload_digest
from megapath_tpu.index import fm as jfm
from megapath_tpu.index import pack as jpack
from megapath_tpu.index import suffix as jsuffix
from megapath_tpu.io import fastq as jfastq
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.index import pack as tpack
from megapath_tpu_torch.index import suffix as tsuffix
from megapath_tpu_torch.io import fastq as tfastq
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def _text(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 4, n).astype(np.uint8)
    if kind == "homopolymer":
        return np.full(n, 2, np.uint8)
    if kind == "repeat":  # a 7-mer tandem repeat with a few substitutions
        t = np.resize(rng.integers(0, 4, 7).astype(np.uint8), n)
        t[rng.integers(0, n, max(1, n // 50))] = 3
        return t
    if kind == "long_repeat":  # a 997-char unit, 3 substitutions: ~10 rounds
        t = np.resize(rng.integers(0, 4, 997).astype(np.uint8), n)
        q = rng.integers(0, n, 3)
        t[q] = (t[q] + 1) % 4
        return t
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind,n",
    [("random", 1), ("random", 2), ("random", 17), ("random", 5000),
     ("homopolymer", 300), ("repeat", 4000), ("long_repeat", 20000)],
)
def test_suffix_array_equals_reference(kind, n):
    codes = _text(kind, n)
    want = jsuffix.suffix_array(codes)
    got = tsuffix.suffix_array(codes, CPU)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if n > 1:
        wb, wp = jsuffix.bwt_from_sa(codes, want)
        gb, gp = tsuffix.bwt_from_sa(codes, got)
        assert gp == wp
        np.testing.assert_array_equal(gb, wb)


def _fm_equal(got, want):
    for f in dataclasses.fields(tfm.FMIndex):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize(
    "source,sa_interval,lut_k",
    [("align_genome.fa", 8, 8), ("wide/genome.fa", 8, 8),
     ("repeat", 4, 5), ("random", 1, 0)],
)
def test_fm_index_equals_reference(source, sa_interval, lut_k):
    if source.endswith(".fa"):
        codes = jpack.pack_fasta_file(FIX / source).codes
    else:
        codes = _text(source, 3000)
    want = jfm.build_fm_index(codes, sa_interval=sa_interval, lut_k=lut_k)
    got = tfm.build_fm_index(codes, sa_interval=sa_interval, lut_k=lut_k, device=CPU)
    _fm_equal(got, want)
    # locate every row of the full BWT: the positions of the suffix array
    rows = np.arange(1, len(codes) + 1)
    np.testing.assert_array_equal(got.locate(rows), want.locate(rows))
    rng = np.random.default_rng(1)
    lo = rng.integers(0, len(codes) + 1, 500)
    hi = np.minimum(lo + rng.integers(0, 50, 500), len(codes) + 1)
    c = rng.integers(0, 4, 500)
    for g, w in zip(got.extend_backward(lo, hi, c), want.extend_backward(lo, hi, c)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunk", [7, 384])
@pytest.mark.parametrize("kind,n", [("random", 5000), ("long_repeat", 20000)])
def test_chunked_build_equals_reference(monkeypatch, chunk, kind, n):
    """Every chunked pass of the build (the rank prefix sums and
    scatters, the BWT gather, the occ and word blocks, mark_rank and the
    sampled SA, the k-mer histogram) across many chunk boundaries: the
    index equals the reference's key by key."""
    monkeypatch.setattr(tsuffix, "CHUNK", chunk)
    codes = _text(kind, n)
    want = jfm.build_fm_index(codes, sa_interval=4, lut_k=5)
    stages = {}
    got = tfm.build_fm_index(codes, sa_interval=4, lut_k=5, device=CPU, stages=stages)
    _fm_equal(got, want)
    rounds = [k for k in stages if k.startswith("sort round")]
    assert rounds and list(stages)[len(rounds):] == ["tables", "k-mer table"]
    # a CPU build records seconds and no card peak
    assert all(sec >= 0 and peak is None for sec, peak in stages.values())
    if kind == "long_repeat":  # shared prefixes of ~10 kbp: 13 * 2^10 chars
        assert len(rounds) >= 10


def test_sort_pairs_is_torch_sort_on_the_cpu_and_refuses_other_devices():
    """The CPU takes torch.sort into the double buffers; the CUDA sort's
    wrapper refuses CPU tensors rather than sorting them some other way."""
    from megapath_tpu_torch.ops import sort_cuda

    keys = [torch.tensor([5, 1, 4, 1, 0], dtype=torch.int64), torch.empty(5, dtype=torch.int64)]
    vals = [torch.arange(5, dtype=torch.int32), torch.empty(5, dtype=torch.int32)]
    s = tsuffix._sort_pairs(keys, vals, 0, 3)
    assert keys[s].tolist() == [0, 1, 1, 4, 5]
    assert sorted(vals[s].tolist()[1:3]) == [1, 3] and vals[s][0] == 4
    with pytest.raises(ValueError, match="CUDA tensors"):
        sort_cuda.sort_pairs_cuda(keys, vals, 0, 3)
    meta = [k.to("meta") for k in keys]
    with pytest.raises(ValueError, match="no pair sort"):
        tsuffix._sort_pairs(meta, [v.to("meta") for v in vals], 0, 3)


@pytest.mark.parametrize(
    "name",
    ["align_genome.fa", "align_r1.fq", "align_golden.cfq", "mini.cfq",
     "wide/r2.fq", "eval_q.fa", "ambiguous.fa.gz"],
)
def test_read_fastx_and_pack_equal_reference(name, tmp_path):
    if name == "ambiguous.fa.gz":  # N runs, IUPAC codes, lower case, gzip
        import gzip

        path = tmp_path / name
        with gzip.open(path, "wt") as f:
            f.write(">s1 first sequence\nACGTNNNNac\ngtRYacgN\n>s2\tx=1\nnnACGT\n"
                    ">s3\n\n>s4 last\nGGGG\n")
    else:
        path = FIX / name
    want = list(jfastq.read_fastx(path))
    got = list(tfastq.read_fastx(path))
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert [tfastq.trim_readno(r.name) for r in got] == [
        jfastq.trim_readno(r.name) for r in want
    ]
    wref = jpack.pack_fasta(want)
    gref = tpack.pack_fasta(got)
    for f in dataclasses.fields(tpack.PackedReference):
        np.testing.assert_array_equal(
            np.asarray(getattr(gref, f.name)), np.asarray(getattr(wref, f.name)), f.name
        )
    pos = np.arange(-1, gref.total_len + 1)
    np.testing.assert_array_equal(gref.seq_of_pos(pos), wref.seq_of_pos(pos))
    for width in (5, 80):
        for g, w in zip(tpack.pack_reads([r.seq for r in got], width),
                        jpack.pack_reads([r.seq for r in want], width)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_toy_workload_draws_as_bench(monkeypatch, tmp_path):
    """The smoke's workload builder makes the bench's workload, here at
    a small size (the full size is checked on the card against the
    digest in tests/fixtures/torch_toy_hits.json)."""
    monkeypatch.setattr(bench, "CACHE", str(tmp_path))
    monkeypatch.setattr(bench, "GENOME_LEN", 3000)
    monkeypatch.setattr(bench, "N_PAIRS", 150)
    monkeypatch.setattr(bench, "LUT_K", 8)
    jref, jfm_, *jreads = bench.build_workload()
    tref, tfm_, *treads = toy_workload(CPU, seq_len=3000, n_pairs=150)
    assert workload_digest(tref.codes, *treads) == workload_digest(jref.codes, *jreads)
    assert tref.names == jref.names and tref.annotations == jref.annotations
    np.testing.assert_array_equal(tref.offsets, jref.offsets)
    _fm_equal(tfm_, jfm_)


def test_large_workload_draws_as_bench_shard(monkeypatch, tmp_path):
    """The smoke's 512 Mbp workload builder makes what
    tools/build_bench_shard.build() makes, here at 8 x 20 kbp and 200
    pairs (the constants the draws depend on, patched in both)."""
    import importlib.util

    from chip_smoke import large_workload

    spec = importlib.util.spec_from_file_location(
        "build_bench_shard", FIX.parents[1] / "tools" / "build_bench_shard.py"
    )
    bbs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bbs)
    monkeypatch.setattr(bbs, "CACHE", str(tmp_path))
    monkeypatch.setattr(bbs, "BIG_SEQ_LEN", 20_000)
    monkeypatch.setattr(bbs, "BIG_PAIRS", 200)
    assert (bbs.BIG_SEQS, bbs.READ_LEN, bbs.INSERT, bbs.SEED) == (8, 100, 350, 23)
    assert (bbs.LUT_K, bbs.SA_INTERVAL) == (8, 4)
    jref, jfm_, *jreads = bbs.build(force=True)
    tref, tfm_, *treads = large_workload(CPU, seq_len=20_000, n_pairs=200)
    assert workload_digest(tref.codes, *treads) == workload_digest(jref.codes, *jreads)
    assert tref.names == jref.names and tref.annotations == jref.annotations
    np.testing.assert_array_equal(tref.offsets, jref.offsets)
    np.testing.assert_array_equal(tref.ambiguous, jref.ambiguous)
    _fm_equal(tfm_, jfm_)
