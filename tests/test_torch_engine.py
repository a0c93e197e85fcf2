"""The port's engine on host seeding against the JAX engine and the
soap4 goldens.

The port runs on the CPU here (its plain DP); the JAX engine runs with
``device_seeding=False`` on the CPU. Each package packs the shard and
builds the FM index with its own modules, or the port takes the
reference's state through ``convert.engine_from_reference``. Every check
is exact.
"""

import collections
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import canonical_hits, golden_mismatches, parse_score_comment
from megapath_tpu.align import AlignEngine as JAlignEngine
from megapath_tpu.align import params as jparams
from megapath_tpu.index.fm import build_fm_index
from megapath_tpu.index.pack import pack_fasta_file, pack_reads
from megapath_tpu.io.fastq import read_fastx, trim_readno
from megapath_tpu_torch.align import params as tparams
from megapath_tpu_torch.align.engine import AlignEngine, _bucket
from megapath_tpu_torch.align.output import best_per_seq, format_comment
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.index import pack as tpack
from megapath_tpu_torch.io import fastq as tfastq
from megapath_tpu_torch.convert import (
    align_params_from_reference,
    engine_from_reference,
)
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def _read_pairs(d: pathlib.Path, r1: str, r2: str, width: int):
    s1 = [r.seq[:width] for r in read_fastx(d / r1)]
    s2 = [r.seq[:width] for r in read_fastx(d / r2)]
    return (*pack_reads(s1, width), *pack_reads(s2, width))


def _port_engine(fasta: pathlib.Path, params) -> AlignEngine:
    """The port on its own: its packer, its FM index, its engine."""
    ref = tpack.pack_fasta_file(fasta)
    fm = tfm.build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)
    return AlignEngine(ref, fm, params, device=CPU)


@pytest.fixture(scope="module")
def align_world():
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    return ref, fm, _read_pairs(FIX, "align_r1.fq", "align_r2.fq", 80)


def test_batch_hits_equal_jax_engine(align_world):
    ref, fm, batch = align_world
    jp = jparams.AlignParams()
    want = JAlignEngine(ref, fm, jp, device_seeding=False).align_pairs(*batch)
    port = engine_from_reference(ref, fm, jp, CPU)
    assert port._ref_words_dev.dtype == torch.int32 and port._ref_words_dev.device == CPU
    port.evict()
    assert port._ref_words_dev is None
    got = port.align_pairs(*batch)  # puts the shard back on its device
    assert port._ref_words_dev is not None
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name).dtype == getattr(want, f.name).dtype, f.name


def test_batch_hits_equal_jax_engine_own_index(align_world):
    """The port reads, packs and indexes the fixture with its own
    modules; its hits equal the JAX engine's on the reference's state."""
    ref, fm, batch = align_world
    jp = jparams.AlignParams()
    want = JAlignEngine(ref, fm, jp, device_seeding=False).align_pairs(*batch)
    port = _port_engine(FIX / "align_genome.fa", align_params_from_reference(jp))
    tbatch = []
    for name in ("align_r1.fq", "align_r2.fq"):
        seqs = [r.seq[:80] for r in tfastq.read_fastx(FIX / name)]
        tbatch.extend(tpack.pack_reads(seqs, 80))
    for g, w in zip(tbatch, batch):
        np.testing.assert_array_equal(g, w)
    got = port.align_pairs(*tbatch)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))


def test_soap4_golden_parity():
    """Twin of tests/test_parity_soap4.py: 0/200 read ends differ, the
    port packing, indexing and reading the fixture on its own."""
    engine = _port_engine(FIX / "align_genome.fa", tparams.AlignParams())
    bad, n = golden_mismatches(engine)
    assert n == 200
    assert not bad, f"{len(bad)}/{n} read-ends mismatch: {bad[:5]}"


def test_wide_parity_best_scores_and_hits():
    """Twin of test_wide_parity_best_scores_and_hits
    (tests/test_parity_wide.py): 600 mixed pairs at 150 bp, every read
    end's SCORE comment equal to soap4's golden."""
    wide = FIX / "wide"
    params = tparams.AlignParams()
    engine = _port_engine(wide / "genome.fa", params)
    ref = engine.ref
    batch = _read_pairs(wide, "r1.fq", "r2.fq", 150)
    hits = engine.align_pairs(*batch)
    r1 = list(read_fastx(wide / "r1.fq"))
    table = best_per_seq(hits, len(r1), params.megapath_mode)
    golden = {}
    seen = collections.Counter()
    for rec in read_fastx(wide / "golden.cfq"):
        nm = trim_readno(rec.name)
        golden[(nm, seen[nm])] = rec
        seen[nm] += 1
    mism = []
    for i, rec in enumerate(r1):
        nm = trim_readno(rec.name)
        for end in (0, 1):
            want = parse_score_comment(golden[(nm, end)].comment)
            mine = parse_score_comment(format_comment(table[end][i], ref, params, ""))
            if want != mine:
                mism.append((nm, end, want, mine))
    assert not mism, f"{len(mism)}/{2 * len(r1)} read-end mismatches: {mism[:3]}"


@pytest.mark.parametrize("name", ["NT_STAGE", "HUMAN_FILTER", "multi_round"])
def test_align_params_from_reference(name):
    if name == "multi_round":
        j = jparams.AlignParams(
            insert_high=500,
            extra_rounds=(jparams.MmpParams(seed_min_length=20, kill_ratio=0.0),),
        )
    else:
        j = getattr(jparams, name)
    t = align_params_from_reference(j)
    assert isinstance(t, tparams.AlignParams)
    assert isinstance(t.mmp, tparams.MmpParams)
    assert all(isinstance(m, tparams.MmpParams) for m in t.extra_rounds)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert len(t.seeding_rounds) == len(j.seeding_rounds)
    m = align_params_from_reference(j.mmp)
    assert isinstance(m, tparams.MmpParams) and dataclasses.asdict(m) == dataclasses.asdict(j.mmp)


def test_exact_direct_flip_agrees_with_jax(align_world):
    """A junk-heavy batch sends more than half its pairs to the exact
    rescue, which flips both engines to the direct exact walk; the next
    batch then runs exact outright. Hits and the flag agree at each step."""
    ref, fm, (reads1, lens1, reads2, lens2) = align_world
    rng = np.random.default_rng(9)
    n = len(lens1)
    junk = rng.random(n) < 0.7
    reads1, reads2 = reads1.copy(), reads2.copy()
    reads1[junk] = rng.integers(0, 4, (int(junk.sum()), reads1.shape[1]))
    reads2[junk] = rng.integers(0, 4, (int(junk.sum()), reads2.shape[1]))
    jp = jparams.AlignParams()
    jeng = JAlignEngine(ref, fm, jp, device_seeding=False)
    teng = engine_from_reference(ref, fm, jp, CPU)
    for step in range(2):
        want = jeng.align_pairs(reads1, lens1, reads2, lens2)
        got = teng.align_pairs(reads1, lens1, reads2, lens2)
        np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))
        assert teng._exact_direct == jeng._exact_direct, step
    assert teng._exact_direct


def test_bucket_matches_reference():
    from megapath_tpu.align.engine import _bucket as jbucket

    for n in (1, 255, 256, 257, 1000, 4096, 4097, 12289, 20000):
        assert _bucket(n) == jbucket(n)
