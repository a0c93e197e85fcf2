"""The port's engine on device seeding against the JAX engine on device
seeding and the soap4 goldens.

The port runs its plain PyTorch walk, locate and DP on the CPU; the JAX
engine runs ``AlignEngine(device_seeding=True)`` on the CPU. Every check
is exact.
"""

import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import _text, canonical_hits, golden_mismatches, world_workload
from megapath_tpu.align import AlignEngine as JAlignEngine
from megapath_tpu.align import params as jparams
from megapath_tpu.index.fm import build_fm_index
from megapath_tpu.index.pack import pack_fasta, pack_fasta_file, pack_reads
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu.io.fastq import read_fastx
from megapath_tpu_torch.align import params as tparams
from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.convert import engine_from_reference
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.index import pack as tpack
from megapath_tpu_torch.io.fastq import FastqRecord
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def _read_pairs(d: pathlib.Path, r1: str, r2: str, width: int):
    s1 = [r.seq[:width] for r in read_fastx(d / r1)]
    s2 = [r.seq[:width] for r in read_fastx(d / r2)]
    return (*pack_reads(s1, width), *pack_reads(s2, width))


WORLDS = {
    "align": (FIX / "align_genome.fa", FIX, "align_r1.fq", "align_r2.fq", 80),
    "wide": (FIX / "wide" / "genome.fa", FIX / "wide", "r1.fq", "r2.fq", 150),
}


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, (fasta, d, r1, r2, width) in WORLDS.items():
        ref = pack_fasta_file(fasta)
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        out[name] = (ref, fm, _read_pairs(d, r1, r2, width))
    return out


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_batch_hits_equal_jax_device_seeding(worlds, name):
    ref, fm, batch = worlds[name]
    jp = jparams.AlignParams()
    want = JAlignEngine(ref, fm, jp, device_seeding=True).align_pairs(*batch)
    port = engine_from_reference(ref, fm, jp, CPU, device_seeding=True)
    assert port.dfm is not None and port.dfm.rows.device == CPU
    got = port.align_pairs(*batch)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))
    for f in ("read", "end", "seq", "score", "start", "strand", "paired"):
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    # the DP of the batch went through the walk's resident walker matrix
    assert port._batch_dev is not None and port._ref_words_dev is not None


def test_soap4_golden_parity_device_seeding():
    """0/200 read ends differ from soap4 on the device-seeding path, the
    port packing and indexing the fixture on its own."""
    ref = tpack.pack_fasta_file(FIX / "align_genome.fa")
    fm = tfm.build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)
    engine = AlignEngine(ref, fm, tparams.AlignParams(), device=CPU, device_seeding=True)
    bad, n = golden_mismatches(engine)
    assert n == 200
    assert not bad, f"{len(bad)}/{n} read-ends mismatch: {bad[:5]}"


def test_exact_rescue_modes_agree_when_dial_is_lossless():
    """Twin of tests/test_engine.py:370 on the port: on a world where the
    dial loses nothing, the rescued, dial-only and direct-exact runs of
    the device-seeding engine give identical hit sets."""
    rng = np.random.default_rng(8)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, 60_000).astype(np.uint8)
    ref = tpack.pack_fasta([FastqRecord("g", decode[g].tobytes().decode(), "")])
    fm = tfm.build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)
    comp = np.array([3, 2, 1, 0], np.uint8)
    n, L, ins = 40, 100, 300
    r1 = np.zeros((n, L), np.uint8)
    r2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, len(g) - ins))
        r1[i] = g[p : p + L]
        r2[i] = comp[g[p + ins - L : p + ins][::-1]]
        if i % 3 == 0:  # junk pair: random bases, no hits anywhere
            r1[i] = rng.integers(0, 4, L)
            r2[i] = rng.integers(0, 4, L)
    lens = np.full(n, L, np.int32)

    def hitset(h):
        return {
            (int(a), int(b), int(c), int(d), int(e))
            for a, b, c, d, e in zip(h.read, h.end, h.score, h.start, h.stop)
        }

    def engine():
        return AlignEngine(ref, fm, tparams.AlignParams(), device=CPU, device_seeding=True)

    want = hitset(engine().align_pairs(r1, lens, r2, lens))
    assert want
    e2 = engine()
    e2.exact_rescue = False
    assert hitset(e2.align_pairs(r1, lens, r2, lens)) == want
    assert hitset(engine()._run_exact(r1, lens, r2, lens)) == want


def test_exact_direct_flip_agrees_with_jax_device_seeding(worlds):
    """A junk-heavy batch flips both device-seeding engines to the direct
    exact walk; hits and the flag agree at each step."""
    ref, fm, (reads1, lens1, reads2, lens2) = worlds["align"]
    rng = np.random.default_rng(9)
    n = len(lens1)
    junk = rng.random(n) < 0.7
    reads1, reads2 = reads1.copy(), reads2.copy()
    reads1[junk] = rng.integers(0, 4, (int(junk.sum()), reads1.shape[1]))
    reads2[junk] = rng.integers(0, 4, (int(junk.sum()), reads2.shape[1]))
    jp = jparams.AlignParams()
    jeng = JAlignEngine(ref, fm, jp, device_seeding=True)
    teng = engine_from_reference(ref, fm, jp, CPU, device_seeding=True)
    for step in range(2):
        want = jeng.align_pairs(reads1, lens1, reads2, lens2)
        got = teng.align_pairs(reads1, lens1, reads2, lens2)
        np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))
        assert teng._exact_direct == jeng._exact_direct, step
    assert teng._exact_direct


def test_device_tables_follow_commit_and_evict(worlds):
    ref, fm, batch = worlds["align"]
    eng = engine_from_reference(ref, fm, jparams.AlignParams(), CPU, device_seeding=True)
    first = canonical_hits(eng.align_pairs(*batch))
    token = eng._batch_dev.batch
    eng.evict()
    assert eng.dfm is None and eng._batch_dev is None and eng._ref_words_dev is None
    # the walk state is keyed by the batch token: a new batch never
    # finds an older batch's walker matrix
    again = canonical_hits(eng.align_pairs(*batch))
    assert eng.dfm is not None and eng._batch_dev.batch > token
    assert eng._walk_state(token) is None
    np.testing.assert_array_equal(again, first)
    host = engine_from_reference(ref, fm, jparams.AlignParams(), CPU)
    assert host.dfm is None and host.align_pairs(*batch) is not None
    assert host._batch_dev is None


@pytest.mark.parametrize("device_seeding", [True, False])
def test_250bp_mate_rescue_equals_jax(device_seeding):
    """2 x 250 bp pairs whose second end has a substitution every 12th
    base (chip_smoke.world_workload's rescue pairs): no seed survives on
    it, so the single-end DP places the first end and mate rescue, in a
    window of round_up(750 + 250 + 62, 128) = 1152 rows, the second.
    BatchHits equal the JAX engine's on both seeding paths."""
    world = world_workload(n=4)
    ref = pack_fasta([JRecord(n, _text(c), "", d) for n, d, c in world["nt"][0]])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
    pairs = [p for p in world["pairs"] if p[0].startswith("rescue")]
    batch = (*pack_reads([p[1] for p in pairs], 250), *pack_reads([p[3] for p in pairs], 250))
    jp = jparams.AlignParams()
    want = JAlignEngine(ref, fm, jp, device_seeding=device_seeding).align_pairs(*batch)
    port = engine_from_reference(ref, fm, jp, CPU, device_seeding=device_seeding)
    widths = []
    for name in ("_device_align_rows", "_device_align"):
        inner = getattr(port, name)

        def record(*a, _inner=inner):
            widths.append(a[-1])
            return _inner(*a)

        setattr(port, name, record)
    got = port.align_pairs(*batch)
    np.testing.assert_array_equal(canonical_hits(got), canonical_hits(want))
    assert 1152 in widths
    # every pair's second end came back, through the rescue
    assert set(got.read[got.end == 1].tolist()) == set(range(len(pairs)))
