#!/usr/bin/env python
"""Write the JAX engine's hits on the toy workload, for ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_toy_digest.py
    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_toy_digest.py --device-seeding

Runs the reference ``AlignEngine`` on the CPU over
``bench.build_workload()`` (4 x 2 Mbp, seed 11, 20,000 pairs x 100 bp)
and records the digest of the workload's inputs, the digest of the
canonically sorted hits and the hit count: with host seeding
(``device_seeding=False``) into ``torch_toy_hits.json``, with
``--device-seeding`` (``device_seeding=True``, the JAX device walk and
locate on the CPU) into ``torch_toy_hits_devseed.json``. ``chip_smoke.py``
requires the port's hits on the card to have the same digest on each
path.
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
    device_seeding = "--device-seeding" in sys.argv[1:]
    ref, fm, reads1, lens1, reads2, lens2 = bench.build_workload()
    engine = AlignEngine(ref, fm, AlignParams(), device_seeding=device_seeding)
    t = time.time()
    hits = engine.align_pairs(reads1, lens1, reads2, lens2)
    path = "device" if device_seeding else "host"
    print(f"JAX engine ({path} seeding, CPU): {len(hits)} hits in "
          f"{time.time() - t:.1f} s", file=sys.stderr)
    out = {
        "workload": "bench.build_workload() (toy hash "
                    f"{bench.toy_hash()}): {len(lens1)} pairs x "
                    f"{reads1.shape[1]} bp, {ref.total_len} bp shard",
        "engine": f"megapath_tpu AlignEngine(device_seeding={device_seeding}), "
                  "AlignParams(), one align_pairs call",
        "input_sha256": workload_digest(ref.codes, reads1, lens1, reads2, lens2),
        "hits_sha256": hits_digest(hits),
        "n_hits": len(hits),
    }
    name = "torch_toy_hits_devseed.json" if device_seeding else "torch_toy_hits.json"
    path = Path(__file__).with_name(name)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
