#!/usr/bin/env python
"""Write the JAX command line's records of the CLI phase's inputs, for
``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_cli_records.py

Runs the reference ``megapath_tpu.cli`` on the CPU over the files that
``chip_smoke.py`` writes for its phase 11 and writes
``torch_cli_records.json``:

- ``world``: ``chip_smoke.world_workload(WORLD_PAIRS_PER_KIND)`` written
  by ``chip_smoke.write_world_files``, indexed by the JAX ``build-index``
  (``chip_smoke.world_build_argvs``) and run by the JAX ``run -b``
  (``chip_smoke.world_run_argv``) on device and on host seeding.
- ``e2e``: ``tools/e2e_eval.py``'s community (``chip_smoke.e2e_workload``)
  written by ``chip_smoke.write_e2e_files``, indexed by the JAX
  ``build-index`` with ``chip_smoke.E2E_INDEX_ARGS`` and run by the JAX
  ``run`` (``chip_smoke.e2e_run_argv``, ``-L 100``) without a human index,
  whose 512 Mbp shard is built only on the card: ``alone`` on the
  community's pairs and ``with_hg_kept`` on the community followed by
  ``chip_smoke.LARGE_HG_KEPT``'s pairs (drawn by ``chip_smoke.large_draw``,
  ~5 GB for a few seconds). The card's realistic run from files reaches
  its NT stage with one of those two inputs.

Each record is ``chip_smoke.cli_record``: both reports, the sha256 of both
LSAM.id files and (world) of the merged and per-shard BAM content, beside
the sha256 of the workload's pairs.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from megapath_tpu.cli import main as jax_cli  # noqa: E402

OUT = FIX / "torch_cli_records.json"


def world_records(n: int) -> dict:
    world = cs.world_workload(n)
    out = {"workload": f"chip_smoke.world_workload({n}) through write_world_files",
           "input_sha256": cs.pairs_digest(world["pairs"])}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cs.write_world_files(world, d)
        for argv in cs.world_build_argvs(d):
            jax_cli(argv)
        for device_seeding, key in ((True, "device_seeding"), (False, "host_seeding")):
            prefix = str(d / key)
            jax_cli(cs.world_run_argv(d, prefix, device_seeding))
            out[key] = cs.cli_record(prefix, n_shards=2)
    return out


def e2e_records() -> dict:
    genomes, pairs = cs.e2e_workload()
    _, *batch = cs.large_draw()
    kept = cs.human_pairs(*batch, rows=cs.LARGE_HG_KEPT)
    out = {"workload": "chip_smoke.e2e_workload() through write_e2e_files, -L 100, "
                       "no human index",
           "input_sha256": cs.pairs_digest(pairs), "hg_kept": [p[0] for p in kept]}
    for key, reads in (("alone", pairs), ("with_hg_kept", pairs + kept)):
        with tempfile.TemporaryDirectory() as d:
            d = Path(d)
            cs.write_e2e_files(d, genomes, reads)
            jax_cli(["build-index", str(d / "community.fa"), str(d / "nt" / "nt"),
                     *cs.E2E_INDEX_ARGS])
            jax_cli(cs.e2e_run_argv(d, str(d / "run")))
            out[key] = cs.cli_record(str(d / "run"))
    return out


def main() -> None:
    t = time.time()
    out = {"world": world_records(cs.WORLD_PAIRS_PER_KIND)}
    print(f"world: {time.time() - t:.1f} s", file=sys.stderr)
    t = time.time()
    out["e2e"] = e2e_records()
    print(f"e2e: {time.time() - t:.1f} s", file=sys.stderr)
    OUT.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
