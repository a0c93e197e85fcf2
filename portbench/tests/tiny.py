"""A tiny world for the CPU tests: the cells' configurations and mix cut
to a few 30 kbp genomes and a few hundred pairs, written as files under a
directory in the layout a checkout has."""

import json
from pathlib import Path

from portbench import spec

HERE = spec.HERE


def write_world(root: Path, pairs: int = 160, **mix_overrides) -> Path:
    """BENCHMARK.json, two configurations (1 and 2 shards) and one mix
    under ``root``; returns the BENCHMARK.json path. Cells: ``t1``, ``t2``."""
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    base = json.loads((HERE / "configs" / "nt4-512m.json").read_text())
    base["database"].update(genome_bp=30000, n_random=4, n_strains=4, partitions=2)
    base["batch_size"] = pairs
    base["pipeline"]["max_read_len"] = 152
    base.pop("limits", None)  # the harness's own limits
    for name, shards in (("tiny1", 1), ("tiny2", 2)):
        c = dict(base, name=name, shards=shards)
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(c))
    mix = json.loads((HERE / "traffic" / "community.json").read_text())
    mix.update(absent_genomes=2, pool_batches=2, sample_pairs=80, **mix_overrides)
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": n, "source": "test", "file": f"portbench/configs/{n}.json", "reduced": [],
         "why": "test"} for n in ("tiny1", "tiny2")]
    bench["workloads"] = [
        {"name": "t1", "config": "tiny1", "traffic": "tiny", "chips": 1, "why": "test"},
        {"name": "t2", "config": "tiny2", "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
