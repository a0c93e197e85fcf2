"""Per-batch times of the program's own spans (``utils.timing.span`` in
``megapath_tpu_torch``) over the traced stretch: the summed length of the
named spans that lie inside an ``nt.batch`` span (one a stage-2 batch),
over the number of those. The stretch starts and stops between batches,
so it holds whole batches. A program without these spans reads
nothing."""

import bisect


def ms_per_batch(ctx, names):
    batches = sorted((a, b) for name, a, b in ctx["host"] if name == "nt.batch")
    if not batches:
        return None
    starts = [a for a, _ in batches]
    total = 0
    for name, a, b in ctx["host"]:
        if name in names:
            k = bisect.bisect_right(starts, a) - 1
            if k >= 0 and b <= batches[k][1]:
                total += b - a
    return total / 1e6 / len(batches)
