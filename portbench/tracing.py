"""What the traced run reads from ``torch.profiler``, and the arithmetic
over its intervals.

The profiler's kineto events are turned into plain tuples
(``read_events``): device operations (kernels, copies, sets) and host
spans (the benchmark's own ``record_function`` spans around the calls into
the program's layers, and the operators and runtime calls inside them),
each as (name, start_ns, end_ns). Everything after that is arithmetic on
intervals, tested on hand-made ones: the union of the device's busy
intervals, the idle gaps between them and what the host was doing in
each, and device time by operation name.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[str, int, int]  # (name, start_ns, end_ns)


def read_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host spans) of a finished ``torch.profiler``
    session, each sorted by start. The device timeline's copies of host
    annotations (``record_function`` ranges mirrored onto the GPU) are
    not device work and are left out."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if "annotation" not in kind.lower() and not annotation:
                dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return dev, host


def extent(*lists: Sequence[Interval]) -> Tuple[int, int]:
    """(first start, last end) over the intervals of all ``lists``."""
    items = [t for lst in lists for t in lst]
    if not items:
        return 0, 0
    return min(t[1] for t in items), max(t[2] for t in items)


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of ``intervals`` inside [lo, hi)."""
    out = []
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((name, a, b))
    return out


def merged(intervals: Iterable[Interval]) -> List[Tuple[int, int]]:
    """The union of the intervals as disjoint (start, end), in order."""
    out: List[List[int]] = []
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(intervals: Iterable[Interval]) -> int:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in merged(intervals))


def gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for a, b in merged(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def host_label(covering: Sequence[Interval], prefix: str) -> str:
    """What the host was doing, from the host spans that cover one
    instant: the innermost span named with ``prefix`` (the benchmark's own
    spans) and the innermost other span; "host: none" where none covers
    it."""
    ours = [h for h in covering if h[0].startswith(prefix)]
    inner = [h for h in covering if not h[0].startswith(prefix)]
    outer = max(ours, key=lambda h: h[1])[0] if ours else ""
    op = max(inner, key=lambda h: h[1])[0] if inner else ""
    return " / ".join(x for x in (outer, op) if x) or "host: none"


def labels_at(host: Sequence[Interval], times: Sequence[int], prefix: str) -> List[str]:
    """``host_label`` at each of ``times``, by one sweep over the host
    spans (sorted by start)."""
    out = [""] * len(times)
    active: List[Interval] = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(host) and host[i][1] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] > t]
        out[k] = host_label(active, prefix)
    return out


def idle_by_host(dev: Sequence[Interval], host: Sequence[Interval], lo: int, hi: int,
                 prefix: str, top: int = 10) -> List[list]:
    """Idle seconds of the device in [lo, hi), summed by what the host was
    doing at each gap's middle: the ``top`` largest, as [label, s]."""
    spans = gaps(dev, lo, hi)
    by = defaultdict(int)
    for (a, b), label in zip(spans, labels_at(host, [(a + b) // 2 for a, b in spans], prefix)):
        by[label] += b - a
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_time_by_name(dev: Iterable[Interval]) -> dict:
    """Summed seconds of the device operations by name."""
    by = defaultdict(int)
    for name, a, b in dev:
        by[name] += b - a
    return {k: v / 1e9 for k, v in by.items()}


def top_ops(dev: Iterable[Interval], top: int = 10) -> List[list]:
    """The ``top`` device operations by summed seconds, as [name, s]."""
    by = device_time_by_name(dev)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
