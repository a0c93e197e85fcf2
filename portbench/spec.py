"""A cell of ``BENCHMARK.json`` found by name, and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a file of its own: the configuration's ``file`` and
``portbench/traffic/<mix>.json``, both under the checkout. A per-layer
metric is a module ``metrics/<name>.py`` with ``read(ctx)``. Adding a
cell, a configuration, a mix or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              base: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics, read
    from ``bench_path`` and the files it names under ``base``."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(base) / confs[w["config"]]["file"]).read_text())
    traffic = json.loads((Path(base) / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
