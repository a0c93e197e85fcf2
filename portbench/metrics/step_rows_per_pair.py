"""The SA rows the one-program step locates a pair, over every shard: the
program's counters ``parallel.spmd_full.step_rows`` over ``step_pairs``,
both counted in ``MegaPathPipeline._align_shards_spmd`` for the ladder
level that served each batch (the rows before any cap, the batch's real
pairs). The harness takes the launch counters alone at the window's ends,
so this reads the process's totals: the warm batches' and the window's,
all drawn from the one pool. A program without the counters reads
nothing."""

import sys


def per_pair(rows: int, pairs: int):
    if not pairs:
        return None
    return rows / pairs


def read(ctx):
    step = sys.modules.get("megapath_tpu_torch.parallel.spmd_full")
    return per_pair(getattr(step, "step_rows", 0), getattr(step, "step_pairs", 0))
