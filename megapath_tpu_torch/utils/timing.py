"""Stage timing / tracing (the [TIMESTAMP]/[TIMER] lines of the
reference pipeline script, runMegaPath.sh:112-123, as a reusable context).

The port's copy of ``megapath_tpu/utils/timing.py``. It reads the host
clock: a stage that ends in a pull from the card (every engine call does)
includes that card work.

``span`` names a part of the program on ``torch.profiler``'s clock, the
one its device trace uses, so that the card's idle time can be put down to
the host work under way. It records only while a profiler records on the
calling thread; otherwise it costs one flag read. To get the spans, run the
pipeline under ``torch.profiler.profile`` (e.g. ``export_chrome_trace``)."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO

import torch

_OFF = nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range called ``name`` while a
    profiler records on this thread (torch's profiler records the thread
    that started it only), else a shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@dataclass
class StageTimer:
    out: Optional[TextIO] = None
    records: List[Dict] = field(default_factory=list)

    @contextmanager
    def stage(self, name: str, **meta):
        fp = self.out if self.out is not None else sys.stderr
        fp.write(f"[TIMESTAMP] {time.strftime('%c')} {name}...\n")
        fp.flush()
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            fp.write(f"[TIMER] {name} took {dt:.2f} sec.\n")
            fp.flush()
            self.records.append({"stage": name, "seconds": dt, **meta})

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out
