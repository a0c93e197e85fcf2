"""The share of the pairs given to the engines' exact rescues that they
re-ran through the undialed walk: the program's counters
``align.engine.rescue_pairs`` over ``align.engine.rescue_seen_pairs``,
both counted in ``AlignEngine._exact_rescue`` (a pair counts once a shard
it is rescued against). The harness takes the launch counters alone at
the window's ends, so this reads the process's totals: the warm batches'
and the window's, all drawn from the one pool. A program without the
counters reads nothing."""

import sys


def share(rescued: int, seen: int):
    if not seen:
        return None
    return 100.0 * rescued / seen


def read(ctx):
    engine = sys.modules.get("megapath_tpu_torch.align.engine")
    return share(getattr(engine, "rescue_pairs", 0), getattr(engine, "rescue_seen_pairs", 0))
