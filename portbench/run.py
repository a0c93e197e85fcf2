"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration (a
deployment of MegaPath's NT-alignment stage) and a traffic mix; the
window drives stage 2 of the port's pipeline exactly as ``run --spmd``
calls it, ``MegaPathPipeline._align_shards``, one batch at a time in a
closed loop (the next batch handed over when the last returns).

Set-up (counted in ``setup_s``, from the start of this process to the
first timed batch): the database and a pool of batches drawn on the card
from the seed, each shard's FM index built on the card by the port's
``build_fm_index``, the pipeline constructed (which packs and commits
the shards' tables), and the cell's batch shape warmed. The window then
runs for ``--seconds`` and closes when the first batch to end past that
time returns; ``align_reads_per_s`` is the reads (2 a pair) of every batch
it completed over its length, ``batch_p90_ms`` the 90th percentile of the
batches' turnaround. After the window the card's peak is read, the
program's state freed, and a sample of pairs drawn from the seed is
worked out by the plain reference (``check.py``): ``correct`` holds when
the hit tables of every completed batch keep to it on the sample, within
each number's limit.

With ``--trace 1`` the run reports the cell's per-layer metrics instead:
``torch.profiler`` records a steady stretch in the middle of the window,
with the benchmark's own spans around the calls into the program's layers
and the DP launches' lengths, and each ``metrics/<name>.py`` reads its
number from that, from the port's launch counters, or from nothing (the
metric is then left out).

Exits 2, printing no result, when the card is missing, and 3 when a
module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel and compiler caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "megapath_tpu")
SPAN = "portbench."  # the prefix of the benchmark's own profiler spans
STRETCH_S = 6.0  # the traced stretch, whole batches from a third into the window
COUNTERS = {  # module -> its launch counters
    "megapath_tpu_torch.ops.seed_cuda": ("walk_launches", "locate_launches"),
    "megapath_tpu_torch.ops.dp_cuda": ("launches", "fwd_launches"),
    "megapath_tpu_torch.ops.sort_cuda": ("sort_launches",),
}


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


def p90(values) -> float:
    """The 90th percentile (inclusive linear interpolation)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _taxdb(n_genomes: int):
    """One species per genome under one superkingdom, as the community's
    taxonomy files say it."""
    from megapath_tpu_torch.taxonomy.taxdb import TaxDB

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "nodes.dmp").write_text(
            "1\t|\t1\t|\tno rank\t|\t\n2\t|\t1\t|\tsuperkingdom\t|\t\n"
            + "".join(f"{10 + i}\t|\t2\t|\tspecies\t|\t\n" for i in range(n_genomes)))
        (d / "names.dmp").write_text(
            "1\t|\troot\t|\t\t|\tscientific name\t|\n2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
            + "".join(f"{10 + i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n"
                      for i in range(n_genomes)))
        (d / "acc2tid.map").write_text(
            "accession\taccession.version\ttaxid\tgi\n"
            + "".join(f"genome{i}\tgenome{i}.1\t{10 + i}\t0\n" for i in range(n_genomes)))
        db = TaxDB(size=16 + n_genomes)
        db.read_nodes(d / "nodes.dmp")
        db.read_names(d / "names.dmp")
        db.read_acc2tid(d / "acc2tid.map")
    return db


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    out = {}
    for mod, names in COUNTERS.items():
        m = sys.modules.get(mod)
        for n in names:
            out[f"{mod.rsplit('.', 1)[-1]}.{n}"] = getattr(m, n, 0) if m else 0
    return out


class Tracer:
    """The traced stretch: the profiler, the benchmark's spans around the
    calls into the program's layers, and the lengths every DP launch was
    given. ``start`` installs them, ``stop`` removes them."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.prof = None
        self.stopped = False
        self.dp_calls = {"fwd": [], "full": []}
        self._undo = []

    def _wrap_attr(self, obj, name, make):
        old = getattr(obj, name)
        own = name in vars(obj)  # a module's function, not a bound method
        setattr(obj, name, make(old))
        self._undo.append((obj, name, old if own else None))

    def _span(self, label):
        import torch

        def make(fn):
            def wrapped(*a, **k):
                with torch.profiler.record_function(SPAN + label):
                    return fn(*a, **k)
            return wrapped
        return make

    def _record(self, kind):
        def make(fn):
            def wrapped(reads, refs, read_lens, ref_lens, *a, **k):
                out = fn(reads, refs, read_lens, ref_lens, *a, **k)
                R, W = reads.shape[1], refs.shape[1]
                ends = (out.end_read.clone(), out.end_ref.clone()) if kind == "full" else ()
                self.dp_calls[kind].append((R, W, read_lens.clone(), ref_lens.clone(), *ends))
                return out
            return wrapped
        return make

    def start(self):
        import torch
        from megapath_tpu_torch.ops import dp_cuda
        from megapath_tpu_torch.parallel import spmd_full

        steps = self.pipe._spmd["steps"]
        self._steps = dict(steps)
        for key in list(steps):
            steps[key] = self._span("spmd_step")(steps[key])
        self._wrap_attr(self.pipe, "_spmd_args", self._span("spmd_args"))
        self._wrap_attr(spmd_full, "spmd_hits_to_batch", self._span("spmd_hits_to_batch"))
        self._wrap_attr(spmd_full, "spmd_payload_stats", self._span("spmd_payload_stats"))
        for eng in self.pipe.nt_engines:
            self._wrap_attr(eng, "_exact_rescue", self._span("exact_rescue"))
            self._wrap_attr(eng, "_align_pairs_impl", self._span("rescue_align_pairs"))
        self._wrap_attr(dp_cuda, "sw_align_cuda", self._record("fwd"))
        self._wrap_attr(dp_cuda, "sw_align_full_cuda", self._record("full"))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.pipe.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.started = time.perf_counter()

    def stop(self):
        self.prof.__exit__(None, None, None)
        self.stopped = True
        self.pipe._spmd["steps"].update(self._steps)
        for obj, name, old in reversed(self._undo):
            if old is None:
                delattr(obj, name)  # the class's method again
            else:
                setattr(obj, name, old)
        self._undo = []

    def calls(self) -> dict:
        """Each DP launch of the stretch as (R, W, read lengths, window
        lengths[, end_read, end_ref]) on the host."""
        return {k: [c[:2] + tuple(x.cpu().numpy() for x in c[2:]) for c in v]
                for k, v in self.dp_calls.items()}


class Bench:
    """One cell's set-up on a device: the drawn database and pool, each
    shard's text, and the program's pipeline (``None`` once released)."""

    def __init__(self, cell, seed: int, device):
        """Draw the inputs from ``seed``, build every shard's index on the
        device with the port's ``build_fm_index``, construct the pipeline
        (which packs and commits the shards' tables) and warm the cell's
        batch shape; ``split`` holds the seconds of each step."""
        import numpy as np
        import torch

        from portbench import gen
        from megapath_tpu_torch.index.fm import build_fm_index
        from megapath_tpu_torch.index.pack import PackedReference
        from megapath_tpu_torch.pipeline.megapath import MegaPathPipeline, PipelineConfig

        self.cell, self.seed = cell, seed
        self.dev = dev = torch.device(device)
        conf, mix = cell.config, cell.traffic
        S, self.n = int(conf["shards"]), int(conf["batch_size"])
        self.split = {}
        t = time.perf_counter()
        g = gen.generator(seed, dev)
        self.database = gen.draw_database(conf["database"], S, mix["absent_genomes"], g, dev)
        self.pool = gen.draw_batches(mix, self.database, self.n, mix["pool_batches"],
                                     conf["pipeline"]["max_read_len"], g)
        self.codes = [self.database.shard_codes(s) for s in range(S)]
        _sync(dev)
        self.split["draw"] = time.perf_counter() - t

        t = time.perf_counter()
        shards = []
        for s in range(S):
            names = self.database.names(s)
            ref = PackedReference(
                codes=self.codes[s], names=names, annotations=list(names),
                offsets=np.arange(len(names) + 1, dtype=np.int64) * self.database.genome_bp,
                ambiguous=np.zeros((0, 2), np.int64),
            )
            fm = build_fm_index(self.codes[s], sa_interval=conf["index"]["sa_interval"],
                                lut_k=conf["index"]["lut_k"], device=dev)
            shards.append((ref, fm))
        _sync(dev)
        self.split["index_build"] = time.perf_counter() - t

        t = time.perf_counter()
        cfg = PipelineConfig(batch_size=self.n, **conf["pipeline"])
        self.pipe = MegaPathPipeline(shards, _taxdb(self.database.n_db), config=cfg,
                                     devices=[dev] * S, device=dev)
        del shards
        _sync(dev)
        self.split["commit_pack"] = time.perf_counter() - t

        t = time.perf_counter()
        for b in self.pool[: mix["warm_batches"]]:
            self.pipe._align_shards(b.reads1, b.lens1, b.reads2, b.lens2, b.n)
        _sync(dev)
        self.split["warm"] = time.perf_counter() - t

    def window(self, seconds: float, trace: bool = False, batches: int = 0) -> dict:
        """Batches of the pool, in turn, through ``_align_shards`` in a
        closed loop until the first to end ``seconds`` after the start
        (or ``batches`` of them). With ``trace`` a stretch in its middle
        runs under the ``Tracer``. Returns the window's record."""
        import torch

        launches0 = _launches()
        tracer = Tracer(self.pipe) if trace else None
        t_lo = seconds / 3
        stretch = min(STRETCH_S, seconds / 3)
        lat, outs, failed = [], [], []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            if tracer is not None:
                now = time.perf_counter()
                if tracer.prof is None and now - t_start >= t_lo:
                    tracer.start()
                elif (tracer.prof is not None and not tracer.stopped
                      and now - tracer.started >= stretch):
                    tracer.stop()
            b = self.pool[i % len(self.pool)]
            a = time.perf_counter()
            try:
                per_shard = self.pipe._align_shards(b.reads1, b.lens1, b.reads2, b.lens2, b.n)
            except Exception:  # a batch the program cannot align counts as failed
                traceback.print_exc(file=sys.stderr)
                per_shard = None
                failed.append(i)
            z = time.perf_counter()
            lat.append(z - a)
            outs.append(per_shard)
            i += 1
            if (batches and i >= batches) or (not batches and z >= deadline):
                break
        if tracer is not None and not tracer.stopped:
            tracer.stop()
        tried = list(self.pipe._spmd["tried"]) if self.pipe._spmd else []
        return {
            "t_start": t_start, "window_s": z - t_start, "lat": lat, "outs": outs,
            "failed": failed, "tracer": tracer, "tried": tried,
            "launches": {k: v - launches0[k] for k, v in _launches().items()},
            "peak": torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0,
        }

    def prime_profiler(self) -> None:
        """Start and stop the profiler once on the device, so that its
        first start (CUPTI's set-up, seconds) falls into set-up."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=self.dev).add_(1)
            _sync(self.dev)

    def release(self) -> None:
        """Free the program's state on the device."""
        import torch

        self.pipe.close()
        self.pipe = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self):
        """The plain reference's answers on the sample drawn from the seed
        (run after ``release``)."""
        from portbench import check

        conf, mix = self.cell.config, self.cell.traffic
        pairs = check.sample(self.seed, len(self.pool), self.n, mix["sample_pairs"])
        t = time.perf_counter()
        want = check.reference(conf, self.database, self.pool, pairs, self.dev)
        log(f"reference {time.perf_counter() - t:.3f} s")
        return want

    def checks(self, expected, win: dict, every: bool = False) -> dict:
        """Every number compared, with its limit: the sampled pairs that
        differ in at least one of the window's completed batches (a pair
        of a pool batch that comes round many times counts once, however
        often it differs). Where some differ, which batches, what differs
        in the first, and the counts summed over the batches go to
        standard error."""
        import numpy as np

        from portbench import check

        limits = {**check.LIMITS, **self.cell.config.get("limits", {})}
        names = check.READINGS if every else tuple(limits)
        # per number and pool batch: the sampled pairs that differ in some
        # completed batch, and how many times a pair differed in all
        union = {k: [np.zeros(len(q), bool) for q in expected.pairs] for k in names}
        summed = {k: 0 for k in names}
        compared, shown = 0, []
        for j, per_shard in enumerate(win["outs"]):
            if per_shard is None:
                continue
            p = j % len(self.pool)
            diff = expected.differing(p, per_shard)
            for k in names:
                union[k][p] |= diff[k]
                summed[k] += int(diff[k].sum())
            compared += len(expected.pairs[p])
            bad = np.flatnonzero(np.any([diff[k] for k in limits], axis=0))
            if len(bad):
                shown.append(f"batch {j} (pool {p}): {len(bad)}")
                if len(shown) == 1:  # what differs, in the first batch that differs
                    kk = int(bad[0])
                    q = int(expected.pairs[p][kk])
                    log(f"pair {q} of pool batch {p}: " + ", ".join(
                        f"{k} {bool(v[kk])}" for k, v in diff.items()))
                    for s, hits in enumerate(per_shard):
                        m = np.flatnonzero(np.asarray(hits.read) == q)
                        got = sorted(tuple(int(np.asarray(getattr(hits, f))[i])
                                           for f in check.FIELDS) for i in m)
                        log(f"  shard {s} program ({', '.join(check.FIELDS)}): {got[:8]}")
                        log(f"  shard {s} reference (end, locus): "
                            f"{[(e, x) for e in (0, 1) for x in expected.loci[p][s][kk][e]][:8]}")
        if shown:
            log("sampled pairs that differ, by batch: " + "; ".join(shown[:40]))
            log("differing pairs summed over the completed batches: " + json.dumps(summed))
        out = {k: {"value": int(sum(int(u.sum()) for u in union[k])), "limit": limits.get(k)}
               for k in names}
        out["failed_batches"] = {"value": len(win["failed"]), "limit": 0}
        out["compared_pairs"] = {"value": compared, "limit": 1, "at_least": True}
        return out


def is_correct(checks: dict) -> bool:
    return all((c["value"] >= c["limit"]) if c.get("at_least") else (c["value"] <= c["limit"])
               for c in checks.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0) -> tuple:
    """Set up, measure and check one cell on ``device``. Returns (result
    dict, checks dict); the result's keys are the contract's, ``checks``
    the numbers compared with their limits."""
    import torch

    from portbench import spec

    c = Bench(cell, seed, device)
    if trace:
        c.prime_profiler()
    print("setup split (s): " + json.dumps({k: round(v, 4) for k, v in c.split.items()}),
          flush=True)
    win = c.window(seconds, trace)
    setup_s = win["t_start"] - t0
    lat, failed, n = win["lat"], win["failed"], c.n
    pairs_done = n * (len(lat) - len(failed))
    log(f"window {win['window_s']:.3f} s, {len(lat)} batches ({len(failed)} failed), "
        f"batch ms median {1e3 * statistics.median(lat):.2f} max {1e3 * max(lat):.2f}; "
        f"step levels {sorted(set(win['tried']))} ({win['tried'].count('robust')} robust); "
        f"launches {win['launches']}")

    metrics, breakdown, dev_info = {}, None, {}
    if trace:
        from portbench import tracing

        tracer = win.pop("tracer")
        dev_ev, host_ev = tracing.read_events(tracer.prof)
        # the stretch: whole batches, from its first operation to its last
        lo, hi = tracing.extent(dev_ev, host_ev)
        ctx = {"pairs": pairs_done, "launches": win["launches"], "dev": dev_ev,
               "host": host_ev, "lo": lo, "hi": hi, "dp_calls": tracer.calls()}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = {"busy_s": tracing.busy_ns(dev_ev) / 1e9, "window_s": (hi - lo) / 1e9}
        breakdown = {"device_ops": tracing.top_ops(dev_ev),
                     "idle_gaps": tracing.idle_by_host(dev_ev, host_ev, lo, hi, SPAN)}
        del tracer, ctx, dev_ev, host_ev
    else:
        for m in cell.end_to_end:
            value = {"align_reads_per_s": 2 * pairs_done / win["window_s"],
                     "batch_p90_ms": 1e3 * p90(lat),
                     "setup_s": setup_s}.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    c.release()
    checks = c.checks(c.expected(), win)
    kind = torch.cuda.get_device_name(c.dev) if c.dev.type == "cuda" else "cpu"
    result = {
        "correct": is_correct(checks),
        "attempted": n * len(lat),
        "failed": n * len(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if c.dev.type == "cuda" else c.dev.type, "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(win["peak"]), **dev_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package is loaded before set-up: {found}")
        return 3
    import torch

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded by the run: {found}")
        return 3
    log(f"card: {power_limit()}")
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        rel = "at least" if c.get("at_least") else "at most"
        log(f"check {k}: {c['value']} (limit: {rel} {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
