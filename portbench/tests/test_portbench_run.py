"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped), the reference against the port, and the timed path broken
underneath in each way the cells can break it: ``correct`` must come out
false for every one."""

import dataclasses
import json

import pytest
import torch

from portbench import spec
from portbench.run import Bench, is_correct, run_cell
from portbench.tests.tiny import write_world

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    return root, write_world(root)


@pytest.fixture(scope="module")
def one_shard(world):
    root, path = world
    b = Bench(spec.load_cell("t1", path, root), 20240611, CPU)
    return b, b.expected()


@pytest.fixture(scope="module")
def two_shards(world):
    root, path = world
    b = Bench(spec.load_cell("t2", path, root), 2**31 + 99, CPU)
    return b, b.expected()


def test_reference_imports_nothing_of_either_package():
    import ast

    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "megapath_tpu",
                                                   "megapath_tpu_torch"), (path, n)


@pytest.mark.parametrize("fixture", ["one_shard", "two_shards"])
def test_the_program_equals_the_reference(fixture, request):
    b, want = request.getfixturevalue(fixture)
    win = b.window(0, batches=2)
    checks = b.checks(want, win)
    assert is_correct(checks), checks
    assert checks["compared_pairs"]["value"] == 2 * len(want.pairs[0])
    # the sample holds pairs with loci and pairs with none (absent genomes)
    n_loci = [sum(len(x) for s in want.loci[p] for x in s[k])
              for p in range(len(want.pairs)) for k in range(len(want.pairs[p]))]
    assert max(n_loci) > 0 and min(n_loci) == 0


def test_a_whole_run_prints_the_contracts_keys(world):
    root, path = world
    res, checks = run_cell(spec.load_cell("t1", path, root), 7, 0.01, False, CPU)
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"align_reads_per_s", "batch_p90_ms", "setup_s"}
    assert res["attempted"] >= 160 and res["failed"] == 0
    json.dumps(res)


def _broken(monkeypatch, b, want, patch):
    patch(monkeypatch)
    win = b.window(0, batches=2)
    monkeypatch.undo()
    return is_correct(b.checks(want, win))


def _patch_tables(fn):
    """Patch the step's hit tables where they are made."""
    from megapath_tpu_torch.parallel import spmd_full

    real = spmd_full.spmd_hits_to_batch

    def patch(mp):
        mp.setattr(spmd_full, "spmd_hits_to_batch", lambda out, bl: fn(real(out, bl), bl))
    return patch


def _rows(h, keep):
    return type(h)(**{f.name: getattr(h, f.name)[keep] for f in dataclasses.fields(h)})


def _patch_stage(fn):
    """Patch what stage 2 returns, after the exact rescue (which would
    heal a pair left without hits upstream of it)."""
    from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline

    real = MegaPathPipeline._align_shards_spmd

    def patch(mp):
        mp.setattr(MegaPathPipeline, "_align_shards_spmd", lambda self, *a: fn(real(self, *a)))
    return patch


def test_half_of_the_batch_left_out(one_shard, monkeypatch):
    b, want = one_shard
    half = _patch_stage(lambda tabs: [_rows(h, h.read < b.n // 2) for h in tabs])
    assert not _broken(monkeypatch, b, want, half)


def test_an_answer_altered_where_it_is_made(one_shard, monkeypatch):
    b, want = one_shard

    def alter(tabs, bl):
        for h in tabs:
            h.start[h.read % 3 == 0] += 1
        return tabs
    assert not _broken(monkeypatch, b, want, _patch_tables(alter))


def test_a_step_that_returns_its_state_unchanged(one_shard, monkeypatch):
    """Every batch gets the first batch's tables back."""
    from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline

    b, want = one_shard
    real = MegaPathPipeline._align_shards_spmd
    first = []

    def stale(self, *a):
        if not first:
            first.append(real(self, *a))
        return first[0]
    assert not _broken(monkeypatch, b, want,
                       lambda mp: mp.setattr(MegaPathPipeline, "_align_shards_spmd", stale))


def test_a_shards_tables_left_out_of_the_gather(two_shards, monkeypatch):
    from megapath_tpu_torch.align.engine import BatchHits

    b, want = two_shards
    drop_last = _patch_stage(lambda tabs: tabs[:-1] + [BatchHits.empty()])
    assert not _broken(monkeypatch, b, want, drop_last)
