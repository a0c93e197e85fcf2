#!/usr/bin/env python
"""Write ``torch_toy_hits.json``: the JAX engine's hits on the toy workload.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_toy_digest.py

Runs the reference ``AlignEngine(device_seeding=False)`` on the CPU over
``bench.build_workload()`` (4 x 2 Mbp, seed 11, 20,000 pairs x 100 bp)
and records the digest of the workload's inputs, the digest of the
canonically sorted hits and the hit count. ``chip_smoke.py`` requires the
port's hits on the card to have the same digest.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
from chip_smoke import hits_digest, workload_digest  # noqa: E402
from megapath_tpu.align import AlignEngine, AlignParams  # noqa: E402


def main() -> None:
    ref, fm, reads1, lens1, reads2, lens2 = bench.build_workload()
    engine = AlignEngine(ref, fm, AlignParams(), device_seeding=False)
    t = time.time()
    hits = engine.align_pairs(reads1, lens1, reads2, lens2)
    print(f"JAX engine (host seeding, CPU): {len(hits)} hits in "
          f"{time.time() - t:.1f} s", file=sys.stderr)
    out = {
        "workload": "bench.build_workload() (toy hash "
                    f"{bench.toy_hash()}): {len(lens1)} pairs x "
                    f"{reads1.shape[1]} bp, {ref.total_len} bp shard",
        "engine": "megapath_tpu AlignEngine(device_seeding=False), "
                  "AlignParams(), one align_pairs call",
        "input_sha256": workload_digest(ref.codes, reads1, lens1, reads2, lens2),
        "hits_sha256": hits_digest(hits),
        "n_hits": len(hits),
    }
    path = Path(__file__).with_name("torch_toy_hits.json")
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
