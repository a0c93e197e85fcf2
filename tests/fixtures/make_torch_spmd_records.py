#!/usr/bin/env python
"""Write the JAX command line's record of ``run --spmd`` on the world, for
``tests/test_torch_spmd_pipeline.py``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_spmd_records.py

Runs the reference ``megapath_tpu.cli`` on the CPU (conftest's eight
virtual devices: a 4 x 2 mesh for the world's two NT shards) over
``chip_smoke.world_workload(WORLD_N)`` written by
``chip_smoke.write_world_files`` and indexed by the JAX ``build-index``
(``chip_smoke.world_build_argvs``), then ``run --spmd -b``
(``chip_smoke.world_run_argv``, device seeding for the hg and ribo
filters), and writes ``torch_spmd_records.json``: ``chip_smoke.cli_record``
(both reports, the sha256 of both LSAM.id files and of the merged and
per-shard BAM content) beside the sha256 of the workload's pairs.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = Path(__file__).resolve().parents[2]
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from megapath_tpu.cli import main as jax_cli  # noqa: E402

OUT = FIX / "torch_spmd_records.json"
WORLD_N = 1  # pairs of each kind, as tests/test_torch_cli.py's world


def world_record() -> dict:
    world = cs.world_workload(WORLD_N)
    out = {"workload": f"chip_smoke.world_workload({WORLD_N}) through write_world_files, "
                       "run --spmd -b on the JAX CLI's 4 x 2 mesh",
           "input_sha256": cs.pairs_digest(world["pairs"])}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cs.write_world_files(world, d)
        for argv in cs.world_build_argvs(d):
            jax_cli(argv)
        prefix = str(d / "spmd")
        jax_cli(cs.world_run_argv(d, prefix, True) + ["--spmd"])
        out["spmd"] = cs.cli_record(prefix, n_shards=2)
    return out


def main() -> None:
    import jax

    t0 = time.time()
    rec = {"world": world_record(), "jax_devices": len(jax.devices())}
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
