"""The stage-2 entry's own host work a batch: ``nt.pad`` (the batch
re-padded to the step's [D * Bl, L]) and ``nt.gather`` (the step's hit
tables turned into each shard's rows and trimmed to the batch's pairs),
over the traced stretch."""

from portbench.metrics._spans import ms_per_batch


def read(ctx):
    return ms_per_batch(ctx, {"nt.pad", "nt.gather"})
