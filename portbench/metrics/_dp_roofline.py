"""A DP kernel's share of its roofline over the traced stretch: the least
time its launches could take (``peaks.bound_s`` of the cells and bytes
each launch was given, ``peaks.dp_work``) over the time the profiler
saw the kernel run. Both entry points of ``csrc/dp_full.cu`` launch the
one template ``dp_wave_kernel<G, CH, kBwd>``: ``kBwd`` false is
``mp_dp_fwd``, true is ``mp_dp_full``."""

import re

from portbench.peaks import bound_s, dp_work

_NAME = re.compile(r"dp_wave_kernel<([^>]*)>")


def kernel_seconds(dev, backward: bool) -> float:
    want = "true" if backward else "false"
    total = 0
    for name, a, b in dev:
        m = _NAME.search(name)
        if m and m.group(1).split(",")[-1].strip() == want:
            total += b - a
    return total / 1e9


def share(ctx, kind: str):
    calls = ctx["dp_calls"][kind]
    seconds = kernel_seconds(ctx["dev"], kind == "full")
    if not calls or seconds <= 0:
        return None
    least = 0.0
    for R, W, rl, wl, *ends in calls:
        cells, nbytes = dp_work(rl, wl, R, W, *ends)
        least += bound_s(cells, nbytes)[0]
    return 100.0 * least / seconds
