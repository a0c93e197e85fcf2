"""``mp_dp_fwd`` (the one-program step's four DPs) as a share of its
roofline, over the traced stretch."""

from portbench.metrics._dp_roofline import share


def read(ctx):
    return share(ctx, "fwd")
