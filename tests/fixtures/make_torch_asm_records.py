#!/usr/bin/env python
"""Write the JAX command line's record of ``chip_smoke.py``'s assembly
phase (phase 14).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_asm_records.py

Runs the reference ``megapath_tpu.cli`` on the CPU over the files that
``chip_smoke.write_asm_files`` writes: ``build-index`` of the world, then
the world part (``chip_smoke.asm_world_records``: the world's pairs plus a
dense SARS-CoV-2 tiling through ``run -A`` on device and on host seeding)
and the realistic part (``chip_smoke.asm_realistic_record``: the world's
pairs plus two novel viruses' 9,000 pairs through ``run`` and then ``run
-A``), and writes ``torch_asm_records.json``: each run's contigs FASTA,
the sha256 and line count of its r2c LSAM, both reports and the sha256 of
both LSAM.id files, the realistic assembly's measures, and the sha256 of
each part's pairs. Refuses to write a record in which a virus is
recovered below ``MIN_RECOVERY``. ~5 min.
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
from megapath_tpu.pipeline import assembly as jax_assembly  # noqa: E402

OUT = FIX / "torch_asm_records.json"
MIN_RECOVERY = 0.9


def main() -> None:
    t = time.time()
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    rec = {"workload": "chip_smoke.write_asm_files: build-index of the world, run -A of "
                       "asm_world_pairs on both seeding paths (asm_world_records), run then "
                       "run -A of the world's pairs + asm_realistic_workload "
                       "(asm_realistic_record)",
           **cs.asm_digests(world)}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cs.write_asm_files(world, d)
        rec["world"] = cs.asm_world_records(jax_cli, d)
        rec["realistic"] = cs.asm_realistic_record(jax_cli, jax_assembly, d)
    for key in ("device_seeding", "host_seeding"):
        if not rec["world"][key]["contigs_fa"] or not rec["world"][key]["r2c_lines"]:
            raise SystemExit(f"the world part assembled nothing on {key}")
    stats = rec["realistic"]["stats"]
    low = {k: v for k, v in stats["recovery"].items() if v < MIN_RECOVERY}
    if low:
        raise SystemExit(f"recovery below {MIN_RECOVERY}: {low}")
    if stats["kept_pairs"] >= stats["extracted_pairs"]:
        raise SystemExit("bbnorm tossed no pair: the deep virus is not deep enough")
    OUT.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"asm: {time.time() - t:.1f} s; {json.dumps(stats)}", file=sys.stderr)


if __name__ == "__main__":
    main()
