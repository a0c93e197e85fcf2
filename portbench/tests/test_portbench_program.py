"""The per-layer metrics that read the program's own spans and counters
(``nt.*`` and ``align.*`` spans of ``utils.timing.span``;
``align.engine.rescue_pairs`` and ``rescue_seen_pairs``): each reader on
hand-made spans and counters, its empty case, and one traced run at a
tiny size on the CPU that reads all four."""

import statistics

import pytest
import torch

from portbench import spec
from portbench.metrics import (
    entry_host_ms_per_batch,
    rescue_ms_per_batch,
    rescue_pair_pct,
    step_wait_ms_per_batch,
)
from portbench.run import Bench, run_cell
from portbench.tests.tiny import write_world

CPU = torch.device("cpu")
MS = 10**6  # ns
NEW = ("rescue_pair_pct", "rescue_ms_per_batch", "entry_host_ms_per_batch",
       "step_wait_ms_per_batch")


def _batches(k):
    """``k`` batches of 100 ms, each with its parts at fixed lengths."""
    host = []
    for i in range(k):
        t = i * 100 * MS
        host += [("nt.batch", t, t + 100 * MS), ("portbench.spmd_args", t, t + 5 * MS),
                 ("nt.pad", t, t + 4 * MS), ("nt.step", t + 5 * MS, t + 40 * MS),
                 ("nt.step.readback", t + 30 * MS, t + 40 * MS), ("aten::copy_", t + 31 * MS,
                                                                  t + 33 * MS),
                 ("nt.gather", t + 40 * MS, t + 46 * MS), ("align.rescue", t + 50 * MS,
                                                           t + 70 * MS),
                 ("align.rescue", t + 70 * MS, t + 100 * MS)]
    return {"host": sorted(host, key=lambda h: h[1]), "dev": [], "lo": 0, "hi": k * 100 * MS}


def test_span_readers_on_hand_made_spans():
    ctx = _batches(3)
    assert rescue_ms_per_batch.read(ctx) == pytest.approx(50.0)
    assert entry_host_ms_per_batch.read(ctx) == pytest.approx(10.0)
    assert step_wait_ms_per_batch.read(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("reader", [rescue_ms_per_batch, entry_host_ms_per_batch,
                                    step_wait_ms_per_batch])
def test_span_readers_read_nothing_without_batch_spans(reader):
    """A program without the spans (the benchmark's own alone)."""
    ctx = {"host": [("portbench.spmd_step", 0, 10), ("aten::add", 2, 3)], "dev": [],
           "lo": 0, "hi": 10}
    assert reader.read(ctx) is None


def test_span_readers_count_only_spans_inside_a_batch():
    """An engine's rescue outside stage 2 (another stage's filter) and a
    pad span after the last batch are not the batches' time."""
    ctx = _batches(2)
    ctx["host"] = sorted(ctx["host"] + [("align.rescue", 200 * MS, 260 * MS),
                                        ("nt.pad", 260 * MS, 270 * MS),
                                        ("align.rescue", 95 * MS, 105 * MS)],
                         key=lambda h: h[1])
    assert rescue_ms_per_batch.read(ctx) == pytest.approx(50.0)
    assert entry_host_ms_per_batch.read(ctx) == pytest.approx(10.0)


def test_rescue_pair_share_on_hand_made_counters(monkeypatch):
    from megapath_tpu_torch.align import engine

    assert rescue_pair_pct.share(77, 400) == pytest.approx(19.25)
    assert rescue_pair_pct.share(0, 0) is None
    monkeypatch.setattr(engine, "rescue_pairs", 30)
    monkeypatch.setattr(engine, "rescue_seen_pairs", 1200)
    assert rescue_pair_pct.read({}) == pytest.approx(2.5)
    monkeypatch.setattr(engine, "rescue_seen_pairs", 0)
    assert rescue_pair_pct.read({}) is None
    monkeypatch.delattr(engine, "rescue_seen_pairs")  # a program without the counters
    assert rescue_pair_pct.read({}) is None


def test_a_traced_run_reads_the_programs_spans_and_counters(tmp_path):
    """The window is sized from the tiny world's batch time so that the
    traced stretch holds a whole batch or more."""
    path = write_world(tmp_path)
    cell = spec.load_cell("t1", path, tmp_path)
    b = Bench(cell, 3900000019, CPU)
    per_batch = statistics.median(b.window(0, batches=3)["lat"])
    b.release()
    res, _ = run_cell(cell, 3900000019, 4 * per_batch, True, CPU)
    print({k: res["metrics"].get(k) for k in NEW})
    assert res["correct"] is True
    for k in NEW:
        assert res["metrics"][k]["value"] > 0, k
    assert res["metrics"]["rescue_pair_pct"]["value"] < 100
    assert {m["name"] for m in cell.per_layer} >= set(NEW)
