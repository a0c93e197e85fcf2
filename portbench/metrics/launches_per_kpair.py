"""Kernel launches a thousand pairs: the port's own launch counters
(``ops/seed_cuda`` walk and locate, ``ops/dp_cuda`` forward and full DP,
``ops/sort_cuda``), summed over the window, over its pairs / 1,000."""


def read(ctx):
    pairs = ctx["pairs"]
    if not pairs:
        return None
    return sum(ctx["launches"].values()) / (pairs / 1000)
