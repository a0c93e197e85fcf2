"""``mp_dp_full`` (the shard engines' DPs in the exact rescue) as a share
of its roofline, over the traced stretch."""

from portbench.metrics._dp_roofline import share


def read(ctx):
    return share(ctx, "full")
