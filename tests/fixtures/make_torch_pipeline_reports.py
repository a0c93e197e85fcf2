#!/usr/bin/env python
"""Write the JAX pipeline's records of the world and e2e workloads, for
``chip_smoke.py``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_pipeline_reports.py

Runs the reference ``MegaPathPipeline`` on the CPU and writes
``torch_pipeline_reports.json``:

- ``world``: ``chip_smoke.world_workload()`` (every stage at 2 x 250 bp:
  bbduk with the TruSeq adapter table, the human filter, the ribosome
  filter, two NT shards), once with ``device_seeding=True`` and once with
  ``device_seeding=False``: the two JAX paths may differ at 250 bp (the
  float32/float64 reseed divergence of ROADMAP section C), so each has its
  own record.
- ``e2e``: ``tools/e2e_eval.py``'s simulated community (50,000 pairs x
  100 bp, 25 genomes of 400 kbp, seed 67) run as ``e2e_eval.run_ours``
  runs it (bbduk on, no adapters, no human stage, device seeding); and,
  under ``with_hg_kept``, the same run over the community followed by the
  human pairs that the realistic cell's hg stage keeps
  (``chip_smoke.LARGE_HG_KEPT``, drawn here by ``chip_smoke.large_draw``;
  the 512 Mbp draw takes ~5 GB for a few seconds). Those pairs reach the
  NT stage in the card's run, so its reports are this record's.

Each record holds both reports, the sha256 of both LSAM.id texts and the
five counters (``chip_smoke.pipeline_record``), beside the sha256 of the
workload's inputs. ``chip_smoke.py`` requires the port's pipeline on the
card to reproduce them.
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

import chip_smoke  # noqa: E402
from megapath_tpu.filters.bbduk import build_kmer_ref  # noqa: E402
from megapath_tpu.index.fm import build_fm_index  # noqa: E402
from megapath_tpu.index.pack import decode_seq, pack_fasta, pack_fasta_file  # noqa: E402
from megapath_tpu.io.fastq import FastqRecord, read_fastx  # noqa: E402
from megapath_tpu.pipeline.megapath import MegaPathPipeline, PipelineConfig  # noqa: E402
from megapath_tpu.taxonomy.taxdb import TaxDB  # noqa: E402

OUT = FIX / "torch_pipeline_reports.json"
WORLD_N = chip_smoke.WORLD_PAIRS_PER_KIND


def mini_taxdb() -> TaxDB:
    db = TaxDB(size=1024)
    db.read_nodes(FIX / "nodes.dmp")
    db.read_names(FIX / "names.dmp")
    db.read_acc2tid(FIX / "acc2tid.map")
    return db


def world_config(device_seeding: bool) -> PipelineConfig:
    return PipelineConfig(read_len=250, max_read_len=250, device_seeding=device_seeding)


def jax_world_pipeline(world, device_seeding: bool, taxdb) -> MegaPathPipeline:
    """The reference pipeline over the world's shards, as the port's
    chip_smoke.phase_pipeline_world builds its own."""

    def shard(seqs):
        ref = pack_fasta([FastqRecord(name, decode_seq(codes), "", desc)
                          for name, desc, codes in seqs])
        return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6)

    return MegaPathPipeline(
        [shard(s) for s in world["nt"]], taxdb, hg_shard=shard(world["hg"]),
        adapters=build_kmer_ref([chip_smoke.TRUSEQ], k=27, hdist=1),
        config=world_config(device_seeding), ribo_shard=shard(world["ribo"]),
    )


def records(pairs):
    """(recs1, recs2) of the reference's FastqRecord."""
    return ([FastqRecord(n, s1, q1) for n, s1, q1, _, _ in pairs],
            [FastqRecord(n, s2, q2) for n, _, _, s2, q2 in pairs])


def jax_world_record(n: int, device_seeding: bool) -> dict:
    world = chip_smoke.world_workload(n)
    pipe = jax_world_pipeline(world, device_seeding, mini_taxdb())
    return chip_smoke.pipeline_record(pipe.run_records(*records(world["pairs"])))


def jax_e2e_records() -> dict:
    """tools/e2e_eval.py's files and taxonomy, run as its run_ours, alone
    and followed by the human pairs the realistic cell's hg stage keeps."""
    from tools import e2e_eval

    with tempfile.TemporaryDirectory() as d:
        fa, fq1, fq2, _ = e2e_eval.simulate(d)
        e2e_eval.write_taxonomy(d)
        db = TaxDB(size=4096)
        db.read_nodes(os.path.join(d, "nodes.dmp"))
        db.read_names(os.path.join(d, "names.dmp"))
        db.read_acc2tid(os.path.join(d, "acc2tid.map"))
        ref = pack_fasta_file(fa)
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        recs1, recs2 = list(read_fastx(fq1)), list(read_fastx(fq2))
    cfg = PipelineConfig(read_len=e2e_eval.READ_LEN, skip_human=True,
                         device_seeding=True, max_read_len=e2e_eval.READ_LEN)
    rec = chip_smoke.pipeline_record(
        MegaPathPipeline([(ref, fm)], db, config=cfg).run_records(recs1, recs2))
    rec["input_sha256"] = chip_smoke.pairs_digest(
        [(a.name, a.seq, a.qual, b.seq, b.qual) for a, b in zip(recs1, recs2)]
    )
    _, *batch = chip_smoke.large_draw()
    kept = chip_smoke.human_pairs(*batch, rows=chip_smoke.LARGE_HG_KEPT)
    k1, k2 = records(kept)
    rec["hg_kept"] = [p[0] for p in kept]
    rec["with_hg_kept"] = chip_smoke.pipeline_record(
        MegaPathPipeline([(ref, fm)], db, config=cfg).run_records(recs1 + k1, recs2 + k2))
    rec["pipeline"] = ("megapath_tpu MegaPathPipeline as tools/e2e_eval.run_ours: "
                       "read_len=100, skip_human, device_seeding, max_read_len=100")
    return rec


def main() -> None:
    out = {
        "world": {
            "workload": f"chip_smoke.world_workload({WORLD_N}): 2 x 250 bp, insert 600",
            "pipeline": "megapath_tpu MegaPathPipeline, world_config(), TruSeq "
                        "adapters, hg and ribo shards, 2 NT shards",
            "input_sha256": chip_smoke.pairs_digest(chip_smoke.world_workload(WORLD_N)["pairs"]),
        },
    }
    for device_seeding in (True, False):
        t = time.time()
        key = "device_seeding" if device_seeding else "host_seeding"
        out["world"][key] = jax_world_record(WORLD_N, device_seeding)
        print(f"world, {key}: {time.time() - t:.1f} s", file=sys.stderr)
    t = time.time()
    out["e2e"] = jax_e2e_records()
    print(f"e2e: {time.time() - t:.1f} s", file=sys.stderr)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    for name, rec in (("world, device seeding", out["world"]["device_seeding"]),
                      ("world, host seeding", out["world"]["host_seeding"]),
                      ("e2e", out["e2e"]), ("e2e with hg kept", out["e2e"]["with_hg_kept"])):
        print(f"{name}: {rec['counters']}")


if __name__ == "__main__":
    main()
