"""Readings for the limits of ``correct``: the program and its control on
several seeds, at the cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one set-up, then every pool batch once through the
program as the cell runs it, then once under each control: the program
with one of its own switches set against a guarantee the configuration
states: ``exact_off``, the exact rescue switched off
(``PipelineConfig.exact``); ``dials_tight``, the walk's
speed/sensitivity dial set for speed (``MmpParams.kill_ratio`` 2.0,
``kill_base`` 64, against the stated 2.5 and 80). A configuration's
``control`` names its own, the default. Planted faults are read off the
program's own outputs: half of each batch's pairs left out, a score
altered where the table is made, and (with several shards) one shard's
table left out. Each is compared with the plain reference as a run
compares, and every reading of ``check.READINGS`` printed, as one JSON
line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.run import Bench, log  # noqa: E402


def _set_params(b, **mmp):
    """The NT shards' parameters with ``mmp`` changed in the step and in
    every engine; returns the old ones."""
    sp = b.pipe._spmd
    old = sp["params"]
    new = old.with_(mmp=dataclasses.replace(old.mmp, **mmp))
    sp["params"] = new
    sp["steps"].clear()
    sp["ladder_start"].clear()
    for eng in b.pipe.nt_engines:
        eng.params = new
    return old


def _restore(b, old):
    sp = b.pipe._spmd
    sp["params"] = old
    sp["steps"].clear()
    sp["ladder_start"].clear()
    for eng in b.pipe.nt_engines:
        eng.params = old


def _window_with(b, k, exact=True, **mmp):
    old_cfg = b.pipe.cfg
    b.pipe.cfg = dataclasses.replace(old_cfg, exact=exact)
    old = _set_params(b, **mmp) if mmp else None
    try:
        return b.window(0, batches=k)
    finally:
        b.pipe.cfg = old_cfg
        if old is not None:
            _restore(b, old)


CONTROLS = {
    "exact_off": dict(exact=False),
    "dials_tight": dict(kill_ratio=2.0, kill_base=64),
}


def _rows(h, keep):
    return type(h)(**{f.name: getattr(h, f.name)[keep] for f in dataclasses.fields(h)})


def half_left_out(per_shard, n):
    return [_rows(h, h.read < n // 2) for h in per_shard]


def score_altered(per_shard, n):
    out = []
    for h in per_shard:
        h = _rows(h, slice(None))
        h.score = h.score.copy()
        h.score[h.read % 7 == 0] += 1
        out.append(h)
    return out


def shard_left_out(per_shard, n):
    return [type(h).empty() if s == len(per_shard) - 1 else h for s, h in enumerate(per_shard)]


def main(argv=None) -> int:
    import torch

    from portbench import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+", choices=list(CONTROLS),
                    help="default: the configuration's own control")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    controls = args.controls or [cell.config["control"]]
    faults = {"half_left_out": half_left_out, "score_altered": score_altered}
    if int(cell.config["shards"]) > 1:
        faults["shard_left_out"] = shard_left_out
    for seed in args.seeds:
        b = Bench(cell, seed, torch.device("cuda", 0))
        k = len(b.pool)
        prog = b.window(0, batches=k)
        ctrl = {name: _window_with(b, k, **CONTROLS[name]) for name in controls}
        b.release()
        want = b.expected()
        rows = {"seed": seed, "program": b.checks(want, prog, every=True)}
        rows.update({name: b.checks(want, w, every=True) for name, w in ctrl.items()})
        for name, fault in faults.items():
            bad = dict(prog, outs=[fault(o, b.n) for o in prog["outs"]])
            rows[name] = b.checks(want, bad, every=True)
        rows = {k2: ({m: c["value"] for m, c in v.items()} if isinstance(v, dict) else v)
                for k2, v in rows.items()}
        print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
