#!/usr/bin/env python
"""Write the JAX package's record of ``chip_smoke.py``'s protein work
(phase 14's realistic part with ``--protein-db`` and phase 15).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_protein_records.py

Runs the reference ``megapath_tpu`` on the CPU and writes
``torch_protein_records.json``:

- ``acd``: ``blastx_m8``'s lines on the ac-diamond fixture
  (``tests/fixtures/protein``, ``chip_smoke.acd_inputs``);
- ``world``: the JAX CLI over the files of ``chip_smoke.write_asm_files``
  and ``write_protein_files``: ``build-index`` of the world, then ``run -A
  --protein-db`` of the world's pairs plus the SARS-CoV-2 tiling on device
  seeding (``chip_smoke.protein_world_record``);
- ``realistic``: the realistic part of phase 14 (``run``, then ``run -A
  --protein-db`` with the realistic protein DB,
  ``chip_smoke.asm_realistic_record(protein=True)``), whose assembly fields
  must equal ``torch_asm_records.json``'s;

each with the NR LSAM.id and NR report texts and the r2g LSAM.id's sha256
and line count (``chip_smoke.protein_record``), and the sha256 of both
protein DBs and of the fixture's files. Refuses to write a record in which
a protein output is empty. ~21 min, nearly all of it the realistic part's
DP: JAX pads every candidate to the longest query frame, 10,413
candidates x 9,873 x 297 cells at ~30 M cells/s.
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
from megapath_tpu.classify.protein import ProteinDB, blastx_m8  # noqa: E402
from megapath_tpu.cli import main as jax_cli  # noqa: E402
from megapath_tpu.pipeline import assembly as jax_assembly  # noqa: E402

OUT = FIX / "torch_protein_records.json"
ASM_FIELDS = ("contigs_fa", "r2c_sha256", "r2c_lines", "report", "ra_report", "lsam_sha256",
              "ra_lsam_sha256", "stats")


def main() -> None:
    t = time.time()
    world = cs.world_workload(cs.WORLD_PAIRS_PER_KIND)
    rec = {"workload": "chip_smoke.acd_inputs through blastx_m8 (acd); write_asm_files + "
                       "write_protein_files: build-index of the world, run -A --protein-db "
                       "of the world part on device seeding (protein_world_record), run then "
                       "run -A --protein-db of the realistic part (asm_realistic_record)",
           **cs.protein_digests(world)}
    prots, queries = cs.acd_inputs()
    rec["acd"] = blastx_m8(queries, ProteinDB.build(prots))
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cs.write_asm_files(world, d)
        cs.write_protein_files(world, d)
        for argv in cs.world_build_argvs(d):
            if jax_cli(argv) != 0:
                raise SystemExit(f"{argv[0]} exited non-zero")
        rec["world"] = cs.protein_world_record(jax_cli, d)
        print(f"world: {time.time() - t:.1f} s", file=sys.stderr)
        rec["realistic"] = cs.asm_realistic_record(jax_cli, jax_assembly, d, protein=True)
    asm = json.loads((FIX / "torch_asm_records.json").read_text())
    for part, want in (("world", asm["world"]["device_seeding"]), ("realistic", asm["realistic"])):
        bad = [k for k in ASM_FIELDS if k in want and rec[part][k] != want[k]]
        if bad:
            raise SystemExit(f"{part}: the assembly differs from torch_asm_records.json: {bad}")
        if not (rec[part]["nr_lsam_id"] and rec[part]["r2g_lines"] and rec[part]["nr_report"]):
            raise SystemExit(f"{part}: a protein output is empty")
    OUT.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"protein: {time.time() - t:.1f} s; nr.lsam.id lines "
          f"{ {k: rec[k]['nr_lsam_id'].count(chr(10)) for k in ('world', 'realistic')} }",
          file=sys.stderr)


if __name__ == "__main__":
    main()
