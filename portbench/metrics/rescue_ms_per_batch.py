"""The exact rescue's host-clock time a stage-2 batch (``align.rescue``
inside ``nt.batch``: each shard's ``AlignEngine._exact_rescue``, the
needy pairs' selection, the undialed walk, pairing and DPs over them, and
the splice), over the traced stretch."""

from portbench.metrics._spans import ms_per_batch


def read(ctx):
    return ms_per_batch(ctx, {"align.rescue"})
