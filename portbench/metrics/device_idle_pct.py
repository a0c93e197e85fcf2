"""The card's idle share over the traced stretch: the wall time outside
the union of its kernel, copy and set intervals."""

from portbench.tracing import busy_ns


def read(ctx):
    span = ctx["hi"] - ctx["lo"]
    if span <= 0 or not ctx["dev"]:
        return None
    return 100.0 * (1 - busy_ns(ctx["dev"]) / span)
