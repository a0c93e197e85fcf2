"""Stage timing / tracing (the [TIMESTAMP]/[TIMER] lines of the
reference pipeline script, runMegaPath.sh:112-123, as a reusable context).

The port's copy of ``megapath_tpu/utils/timing.py``. It reads the host
clock: a stage that ends in a pull from the card (every engine call does)
includes that card work."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO


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
