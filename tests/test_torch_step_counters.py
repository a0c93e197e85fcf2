"""The one-program step's counters and the set-up's spans
(``parallel.spmd_full.step_rows``, ``step_pairs``, ``pack_ms``,
``upload_ms``; spans ``nt.pack`` and ``nt.upload``).

On small shards of random text (and one with a tandem repeat, whose seeds
each stand for ``sa_size_threshold + 1`` SA rows) through
``MegaPathPipeline._align_shards`` on a grid of CPU places: a batch adds
to ``step_rows`` exactly the SA rows the plain seeding locates on the
same padded reads, summed over the shards, and to ``step_pairs`` its real
pairs; a batch that climbs the ladder counts the level that served it
once; a batch that fails at every level counts nothing. The placement
records its two spans under a CPU profiler and adds to its two counters
on every call. Every check is exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu_torch.align.seeding_dev import DeviceFM, build_walkers, device_seed_pipeline_loc
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.parallel import spmd_full as sf
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
L = 80


def _shard(named_codes):
    ref = pack_fasta([FastqRecord(n, decode_seq(c), "") for n, c in named_codes])
    return ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)


def _pair(codes, p, insert=220):
    r1 = codes[p : p + L].copy()
    r2 = COMPLEMENT[codes[p + insert - L : p + insert][::-1]].astype(np.uint8)
    return r1, r2


def _batch(texts, n_each, rng, n_junk=0):
    """``n_each[i]`` pairs from ``texts[i]`` and ``n_junk`` random ones."""
    r1, r2 = [], []
    for codes, k in zip(texts, n_each):
        for _ in range(k):
            a, b = _pair(codes, int(rng.integers(0, len(codes) - 300)))
            r1.append(a)
            r2.append(b)
    for _ in range(n_junk):
        r1.append(rng.integers(0, 4, L).astype(np.uint8))
        r2.append(rng.integers(0, 4, L).astype(np.uint8))
    lens = np.full(len(r1), L, np.int32)
    return np.stack(r1), lens, np.stack(r2), lens.copy(), len(r1)


def _pipeline(shards, exact):
    cfg = PipelineConfig(read_len=L, max_read_len=L, skip_preprocess=True, skip_human=True,
                         spmd=True, device_seeding=True, exact=exact)
    return MegaPathPipeline(shards, cs.mini_taxdb(), config=cfg, devices=[CPU] * len(shards),
                            device=CPU)


def _recount(pipe, shards, batch):
    """The SA rows the plain seeding locates on the batch as the step takes
    it (padded to its block, [r1; r2] and their reverse complements, the
    step's seed slots and walk bound), summed over the shards."""
    Bl, Lp, (r1, r2, l1, l2) = pipe._spmd_args(*batch)
    reads = torch.as_tensor(np.concatenate([r1, r2]))
    lens = torch.as_tensor(np.concatenate([l1, l2]))
    mmp = pipe._spmd["params"].mmp
    max_seeds = int(min(16, max(4, Lp // 16 + 2)))
    chg = 3 * Lp + 64
    total = 0
    for _, fm in shards:
        _, pos = device_seed_pipeline_loc(DeviceFM.from_host(fm, CPU),
                                          *build_walkers(reads, lens), mmp, max_seeds, chg, chg)
        total += len(pos)
    return total


def _counts():
    return sf.step_rows, sf.step_pairs


@pytest.fixture(scope="module")
def two_shards():
    rng = np.random.default_rng(21)
    texts = [rng.integers(0, 4, n).astype(np.uint8) for n in (6000, 5000, 4000)]
    shards = [_shard([("a0", texts[0]), ("a1", texts[1])]), _shard([("b0", texts[2])])]
    return shards, texts


@pytest.fixture(scope="module")
def repeat_shard():
    rng = np.random.default_rng(7)
    rep = np.tile(rng.integers(0, 4, 200).astype(np.uint8), 40)
    plain = rng.integers(0, 4, 30000).astype(np.uint8)
    return [_shard([("rep", rep), ("plain", plain)])], (rep, plain)


def test_step_rows_are_the_plain_seedings_located_rows(two_shards):
    """A 1 x 2 grid with the exact rescue on (its own located rows are not
    the step's): pairs of both shards and random pairs, padded from 57 to
    the 256-pair block."""
    shards, texts = two_shards
    pipe = _pipeline(shards, exact=True)
    batch = _batch(texts, (20, 15, 12), np.random.default_rng(3), n_junk=10)
    want = _recount(pipe, shards, batch)
    rows0, pairs0 = _counts()
    hits = pipe._align_shards(*batch)
    rows, pairs = _counts()
    assert pipe._spmd["tried"] == ["lean"]
    assert sum(len(h) for h in hits) > 0
    assert want > batch[4] and rows - rows0 == want
    assert pairs - pairs0 == 57  # the real pairs, not the block's 256
    # a second batch adds its own
    batch2 = _batch(texts, (5, 5, 5), np.random.default_rng(4))
    want2 = _recount(pipe, shards, batch2)
    pipe._align_shards(*batch2)
    assert _counts() == (rows + want2, pairs + 15)


def test_an_empty_batch_counts_nothing(two_shards):
    shards, _ = two_shards
    pipe = _pipeline(shards, exact=False)
    z = np.zeros((0, L), np.uint8)
    before = _counts()
    pipe._align_shards(z, np.zeros(0, np.int32), z, np.zeros(0, np.int32), 0)
    assert _counts() == before


def test_a_batch_that_climbs_the_ladder_counts_once(repeat_shard):
    """Four pairs from the tandem repeat overflow a lean cap; the robust
    level serves the batch, and only its rows count (the walk, and so the
    rows located, is the same at both levels)."""
    shards, (rep, plain) = repeat_shard
    pipe = _pipeline(shards, exact=False)
    batch = _batch((rep, plain), (4, 196), np.random.default_rng(11))
    want = _recount(pipe, shards, batch)
    before = _counts()
    pipe._align_shards(*batch)
    assert pipe._spmd["tried"] == ["lean", "robust"]
    assert _counts() == (before[0] + want, before[1] + 200)
    # the next batch of the shape starts at the robust level
    pipe._align_shards(*batch)
    assert pipe._spmd["tried"] == ["lean", "robust", "robust"]
    assert _counts() == (before[0] + 2 * want, before[1] + 400)


def test_a_batch_that_overflows_every_level_counts_nothing(repeat_shard):
    shards, (rep, plain) = repeat_shard
    pipe = _pipeline(shards, exact=False)
    batch = _batch((rep, plain), (16, 184), np.random.default_rng(12))
    before = _counts()
    with pytest.raises(RuntimeError, match="spmd_full cap overflow"):
        pipe._align_shards(*batch)
    assert pipe._spmd["tried"] == ["lean", "robust"]
    assert _counts() == before


def test_placement_spans_and_its_counters_grow_on_every_call(two_shards):
    shards, _ = two_shards
    mesh = sf.make_mesh([CPU] * 2, 2)
    meta = sf.fm_meta([fm for _, fm in shards])
    for _ in range(2):
        pack0, up0 = sf.pack_ms, sf.upload_ms
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            inputs = sf.place_spmd_full_inputs(mesh, meta, shards)
        assert len(inputs.placed) == 2
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert names.count("nt.pack") == 1 and names.count("nt.upload") == 1
        assert sf.pack_ms > pack0 and sf.upload_ms > up0
