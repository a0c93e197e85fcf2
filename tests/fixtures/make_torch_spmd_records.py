#!/usr/bin/env python
"""Write the JAX package's records of its grid steps, for
``tests/test_torch_spmd_pipeline.py``, ``tests/test_torch_spmd.py``,
``tests/test_torch_dist.py`` and ``chip_smoke.py`` phase 19 (b).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_spmd_records.py

Runs the reference on the CPU (conftest's eight virtual devices):

- ``world``: the ``megapath_tpu.cli`` over ``chip_smoke.world_workload(
  WORLD_N)`` written by ``chip_smoke.write_world_files`` and indexed by the
  JAX ``build-index`` (``chip_smoke.world_build_argvs``), then ``run --spmd
  -b`` (``chip_smoke.world_run_argv``, device seeding for the hg and ribo
  filters, a 4 x 2 mesh for the world's two NT shards):
  ``chip_smoke.cli_record`` (both reports, the sha256 of both LSAM.id files
  and of the merged and per-shard BAM content) beside the sha256 of the
  workload's pairs.
- ``small``: ``parallel/spmd.py``'s reduced step on ``chip_smoke``'s small
  worlds (``small_spmd_world`` with ``small_spmd_planted``, and
  ``small_spmd_edge``) with ``spmd_report`` of the first, and
  ``parallel/dist.py``'s step on ``small_dist_world``, each on a 4 x 2 mesh:
  every output field, beside the sha256 of the worlds' arrays.
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


def jax_mini_taxdb():
    from megapath_tpu.taxonomy import TaxDB

    db = TaxDB(size=1024)
    db.read_nodes(FIX / "nodes.dmp")
    db.read_names(FIX / "names.dmp")
    db.read_acc2tid(FIX / "acc2tid.map")
    return db


def jax_spmd_runs() -> dict:
    """The JAX reduced step on the 4 x 2 mesh of the eight virtual devices,
    over the planted batch of ``small_spmd_world`` and the edge world's
    batch: {tag: {fms, padded, true_n, batch, out}}, and the planted
    batch's ``spmd_report`` under "report"."""
    import jax

    from megapath_tpu.align.params import AlignParams
    from megapath_tpu.parallel import spmd

    mesh = spmd.make_mesh_for(jax.devices())
    world = cs.small_spmd_world()
    edge_world, edge_batch = cs.small_spmd_edge(world)
    runs = {}
    for tag, w, batch in (("planted", world, cs.small_spmd_planted(world)),
                          ("edge", edge_world, edge_batch)):
        fms, padded, true_n = spmd.pad_and_index_shards(
            w["codes"], sa_interval=cs.SPMD_SA_INTERVAL, lut_k=8)
        sfm, meta = spmd.stack_fms(fms)
        step = spmd.build_spmd_engine_step(mesh, meta, read_len=cs.SPMD_L,
                                           n_species=w["n_species"],
                                           params=AlignParams(**cs.SPMD_PARAMS))
        r1, r2, lens = batch
        sfm_p, placed = spmd.place_spmd_inputs(
            mesh, sfm, ref_codes=padded, true_n=true_n, seq_offsets=w["seq_offsets"],
            seq_species=w["seq_species"], reads1=r1, reads2=r2, lens1=lens, lens2=lens)
        out = step(sfm_p, *(placed[k] for k in ("ref_codes", "true_n", "seq_offsets",
                                                 "seq_species", "reads1", "reads2",
                                                 "lens1", "lens2")))
        runs[tag] = dict(fms=fms, padded=padded, true_n=true_n, batch=batch, out=out)
    lens = runs["planted"]["batch"][2]
    runs["report"] = spmd.spmd_report(runs["planted"]["out"], cs.SPMD_TIDS, jax_mini_taxdb(),
                                      lens, lens)
    return runs


def jax_dist_out():
    """The JAX dist step on ``small_dist_world`` over ``make_mesh(8)``."""
    from megapath_tpu.parallel import dist

    mesh = dist.make_mesh(8)
    w = cs.small_dist_world()
    step = dist.build_dist_align_step(mesh, width=w["width"], n_species=w["n_species"])
    keys = ("ref_shards", "seq_offsets", "seq_species", "reads", "read_lens", "cand_pos")
    placed = dist.shard_arrays(mesh, **{k: w[k] for k in keys})
    return step(*(placed[k] for k in keys))


def small_record(runs: dict, dist_out) -> dict:
    return {"input_sha256": cs.small_worlds_digest(),
            "spmd": {"planted": dict(cs.out_record(runs["planted"]["out"]),
                                     report=runs["report"]),
                     "edge": cs.out_record(runs["edge"]["out"])},
            "dist": cs.out_record(dist_out)}


def main() -> None:
    import jax

    t0 = time.time()
    rec = {"world": world_record(), "small": small_record(jax_spmd_runs(), jax_dist_out()),
           "jax_devices": len(jax.devices())}
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
