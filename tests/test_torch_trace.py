"""The port's spans and counters inside stage 2 (``utils.timing.span``,
``align.engine.rescue_pairs`` and ``rescue_seen_pairs``).

One stage-2 batch of the cascade's pairs and a few random pairs (ends that
miss, so each shard's exact rescue runs its whole pass) through the
one-program step on a 1 x 2 grid of CPU places: with no profiler it
opens no ``record_function`` at all; under a CPU ``torch.profiler`` it
records the span tree (``nt.batch`` over ``nt.pad``, ``nt.step`` with its
upload, enqueue and read-back, ``nt.gather`` and one ``align.rescue`` a
shard with its parts and its pass); the counters equal counts made from
the step's own hits; and the hits do not depend on the profiler. Every
check is exact.
"""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu_torch.align import engine as engine_mod
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import pack_fasta_file, pack_reads
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from megapath_tpu_torch.utils import timing
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CAS = pathlib.Path(__file__).parent / "fixtures" / "cascade"
N_JUNK = 6

# each child span and the span it must lie in
PARENT = {
    "nt.pad": "nt.batch", "nt.step": "nt.batch", "nt.gather": "nt.batch",
    "align.rescue": "nt.batch",
    "nt.step.upload": "nt.step", "nt.step.enqueue": "nt.step", "nt.step.readback": "nt.step",
    "align.rescue.select": "align.rescue", "align.rescue.splice": "align.rescue",
    "align.pass.seed": "align.rescue", "align.pass.pair": "align.rescue",
    "align.pass.deep_dp": "align.rescue", "align.pass.single": "align.rescue",
    "align.pass.splice": "align.rescue",
}


@pytest.fixture(scope="module")
def stage2():
    """A pipeline on the cascade's two shards (a 1 x 2 grid) and one batch:
    the cascade's pairs and N_JUNK random ones, packed as ``run_records``
    packs them."""
    shards = []
    for i in (0, 1):
        ref = pack_fasta_file(CAS / f"shard{i}.fa")
        shards.append((ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)))
    cfg = PipelineConfig(read_len=80, max_read_len=80, skip_preprocess=True, skip_human=True,
                         spmd=True)
    pipe = MegaPathPipeline(shards, cs.mini_taxdb(), config=cfg, devices=[CPU] * 2, device=CPU)
    recs1, recs2 = cs.cascade_reads()
    rng = np.random.default_rng(19)
    junk = ["".join("ACGT"[c] for c in rng.integers(0, 4, 80)) for _ in range(2 * N_JUNK)]
    reads1, lens1 = pack_reads([r.seq for r in recs1] + junk[:N_JUNK], 80)
    reads2, lens2 = pack_reads([r.seq for r in recs2] + junk[N_JUNK:], 80)
    return pipe, (reads1, lens1, reads2, lens2, len(lens1))


def _same_hits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("read", "end", "seq", "score", "raw_score", "start", "stop", "strand",
                  "paired"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


def _spans(prof):
    """The program's host spans (``nt.*``, ``align.*``) of a finished
    profiler session as (name, start_ns, end_ns), in order of start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("nt.", "align.")):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda t: t[1])


@pytest.fixture(scope="module")
def traced(stage2):
    """The batch aligned with no profiler, then under a CPU profiler."""
    pipe, batch = stage2
    off = pipe._align_shards(*batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = pipe._align_shards(*batch)
    return off, on, _spans(prof)


def test_no_profiler_opens_no_record_function(stage2, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pipe, batch = stage2
    rescued = engine_mod.rescue_pairs
    hits = pipe._align_shards(*batch)
    assert engine_mod.rescue_pairs > rescued  # the rescue's parts ran
    assert sum(len(h) for h in hits) > 0
    assert timing.span("nt.batch") is timing.span("nt.pad")


def test_the_span_tree_of_one_batch(traced, stage2):
    _, _, spans = traced
    pipe, _ = stage2
    names = [s[0] for s in spans]
    assert set(names) == set(PARENT) | {"nt.batch"}
    assert names.count("nt.batch") == 1
    assert names.count("align.rescue") == len(pipe.nt_engines)
    assert names.count("align.rescue.select") == len(pipe.nt_engines)
    # one upload for the grid's one data row, one enqueue a cell
    assert names.count("nt.step.upload") == names.count("nt.step")
    assert names.count("nt.step.enqueue") == 2 * names.count("nt.step")
    for name, a, b in spans:
        if name == "nt.batch":
            continue
        parents = [(pa, pb) for n, pa, pb in spans if n == PARENT[name]]
        assert any(pa <= a and b <= pb for pa, pb in parents), (name, a, b)


def test_hits_do_not_depend_on_the_profiler(traced):
    off, on, _ = traced
    _same_hits(off, on)


def test_counters_equal_counts_from_the_steps_hits(stage2):
    """``rescue_pairs`` adds each shard's pairs with an end the step left
    without a hit, counted here from the step's own tables (the rescue
    off); ``rescue_seen_pairs`` adds pairs x shards."""
    pipe, batch = stage2
    n = batch[-1]
    pipe.cfg.exact = False
    try:
        step_hits = pipe._align_shards(*batch)
    finally:
        pipe.cfg.exact = True
    needy = 0
    for h in step_hits:
        both = set(h.read[h.end == 0].tolist()) & set(h.read[h.end == 1].tolist())
        needy += n - len(both)
    assert needy > 0
    rescued, seen = engine_mod.rescue_pairs, engine_mod.rescue_seen_pairs
    pipe._align_shards(*batch)
    assert engine_mod.rescue_pairs - rescued == needy
    assert engine_mod.rescue_seen_pairs - seen == n * len(pipe.nt_engines)


def test_an_empty_batch_counts_nothing(stage2):
    pipe, batch = stage2
    before = (engine_mod.rescue_pairs, engine_mod.rescue_seen_pairs)
    hits = pipe._align_shards(*batch[:4], 0)
    assert len(hits) == len(pipe.nt_engines) and not any(len(h) for h in hits)
    assert (engine_mod.rescue_pairs, engine_mod.rescue_seen_pairs) == before


def test_host_path_spans_tell_the_pass_from_the_rescue(stage2):
    """Without ``spmd`` each shard's engine runs its own pass, then its
    exact rescue, inside ``nt.batch``: the pass's ``align.pass.*`` spans
    lie outside ``align.rescue``, the rescue's own pass inside it."""
    pipe, (reads1, lens1, reads2, lens2, n) = stage2
    shards = [(e.ref, e.fm) for e in pipe.nt_engines]
    host = MegaPathPipeline(shards, cs.mini_taxdb(),
                            config=PipelineConfig(read_len=80, max_read_len=80,
                                                  skip_preprocess=True, skip_human=True),
                            device=CPU)
    k = 24  # a few pairs keep the host path quick; the random ones need the rescue
    sub = (reads1[-k:], lens1[-k:], reads2[-k:], lens2[-k:], k)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        host._align_shards(*sub)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("nt.batch") == 1
    assert names.count("align.rescue") == len(shards)
    (_, ba, bb), = [s for s in spans if s[0] == "nt.batch"]
    assert all(ba <= a and b <= bb for _, a, b in spans)
    rescues = [(a, b) for name, a, b in spans if name == "align.rescue"]
    inside = lambda a, b: any(ra <= a and b <= rb for ra, rb in rescues)  # noqa: E731
    seeds = [(a, b) for name, a, b in spans if name == "align.pass.seed"]
    assert any(inside(a, b) for a, b in seeds)
    assert any(not inside(a, b) for a, b in seeds)
    assert all(inside(a, b) for name, a, b in spans if name.startswith("align.rescue."))


def test_span_records_only_under_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    with timing.span("nt.x"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert isinstance(timing.span("nt.x"), torch.profiler.record_function)
        with timing.span("nt.x"):
            torch.ones(2).add_(1)
    assert [s[0] for s in _spans(prof)] == ["nt.x"]
