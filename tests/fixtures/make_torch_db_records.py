#!/usr/bin/env python
"""Write the JAX command line's record of ``chip_smoke.py``'s db phase
(phase 13).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_db_records.py

Runs the reference ``megapath_tpu.cli`` on the CPU over the files that
``chip_smoke.write_db_files`` writes for
``chip_smoke.world_workload(WORLD_PAIRS_PER_KIND)``: ``build-db``
(``chip_smoke.db_build_argv``) and then ``run`` on its shards on device
seeding (``chip_smoke.db_run_argv``), and writes
``torch_db_records.json``: ``chip_smoke.db_records`` (the curated FASTA's
sha256, every member of every shard file, both reports and the sha256 of
both LSAM.id files) beside the sha256 of the workload's pairs. ~1 min:
the JAX device walk compiles.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from megapath_tpu.cli import main as jax_cli  # noqa: E402

OUT = FIX / "torch_db_records.json"


def main() -> None:
    t = time.time()
    OUT.write_text(json.dumps(cs.db_records(jax_cli), indent=1) + "\n")
    print(f"db: {time.time() - t:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
