"""The time a batch the host waits in the one-program step's read-back
(``nt.step.readback``: the hit tables copied back once a device, which
waits for every cell's enqueued work), over the traced stretch."""

from portbench.metrics._spans import ms_per_batch


def read(ctx):
    return ms_per_batch(ctx, {"nt.step.readback"})
