"""Shard placement and wave rotation in the port (``devices=``) against the
JAX package's.

Twins of ``tests/test_shard_rotation.py`` (4 shards, more than devices:
the NT engines are lazy and rotate in waves) and of
``tests/test_cascade_parity.py::dist_cascade_result`` (2 shards, each on
its own place, dispatched from the pool); ``run_files`` over several
batches under rotation; the lazy engine's contract (it raises until it is
committed, evict keeps the cross-batch state, a re-commit uploads the
tables its first commit packed); and the kernel library's loader and
launch counts under threads. The port runs on the CPU, ``devices`` being
places on the one CPU; the JAX package on conftest's virtual CPU devices,
on host seeding (its device walk compiles for ~30 s a device on the CPU).
On these exact reads both walks seed alike, so the port's device-seeding
runs are held to it too; ``tests/test_torch_pipeline.py`` holds the port's
device seeding to the JAX device seeding. Every check is exact.
"""

import concurrent.futures
import os
import pathlib
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.index.fm import build_fm_index as jbuild_fm_index
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.io.fastq import FastqRecord as JRecord
from megapath_tpu.pipeline import MegaPathPipeline as JPipeline
from megapath_tpu.pipeline import PipelineConfig as JConfig
from megapath_tpu.taxonomy.taxdb import TaxDB as JTaxDB
from megapath_tpu_torch.align import seeding_dev
from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, pack_fasta, pack_reads
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.ops import _build, dp_cuda, protein_cuda, seed_cuda, sort_cuda
from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig
from megapath_tpu_torch.taxonomy.taxdb import TaxDB
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CAS = pathlib.Path(__file__).parent / "fixtures" / "cascade"
OUTPUTS = (".nt.report", ".nt.ra.report", ".nt.lsam.id", ".nt.ra.lsam.id")


# ---------------------------------------------------------------------------
# tests/test_shard_rotation.py's world: 4 shards of 4,000 random bp
# ---------------------------------------------------------------------------
def _write_taxonomy(d: pathlib.Path, n: int) -> None:
    """One species a shard (accession seq<i>, taxid 10 + i) under one
    superkingdom, as test_shard_rotation._taxdb_for writes it."""
    (d / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\t\n2\t|\t1\t|\tsuperkingdom\t|\t\n"
                                 + "".join(f"{10 + i}\t|\t2\t|\tspecies\t|\t\n"
                                           for i in range(n)))
    (d / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
        + "".join(f"{10 + i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n" for i in range(n)))
    (d / "acc.map").write_text("accession\taccession.version\ttaxid\tgi\n"
                               + "".join(f"seq{i}\tseq{i}.1\t{10 + i}\t0\n" for i in range(n)))


def _taxdb(cls, d: pathlib.Path):
    db = cls(size=4096)
    db.read_nodes(d / "nodes.dmp")
    db.read_names(d / "names.dmp")
    db.read_acc2tid(d / "acc.map")
    return db


def _reads(texts, n_per, L=80, insert=200, seed=3):
    """test_shard_rotation._reads with the port's records."""
    rng = np.random.default_rng(seed)
    qual = "I" * L
    r1, r2 = [], []
    for s, c in enumerate(texts):
        for i in range(n_per):
            p = int(rng.integers(0, len(c) - insert))
            a = c[p : p + L]
            b = COMPLEMENT[c[p + insert - L : p + insert][::-1]]
            r1.append(FastqRecord(f"s{s}r{i}", cs._text(a), qual))
            r2.append(FastqRecord(f"s{s}r{i}", cs._text(b), qual))
    return r1, r2


def _jax(recs):
    return [JRecord(r.name, r.seq, r.qual) for r in recs]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(77)
    shards, jshards, texts = [], [], []
    for s in range(4):
        c = rng.integers(0, 4, 4000).astype(np.uint8)
        ref = pack_fasta([FastqRecord(f"seq{s}.1 sp{s}", cs._text(c), "", "")])
        shards.append((ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)))
        jref = jpack_fasta([JRecord(f"seq{s}.1 sp{s}", cs._text(c), "", "")])
        jshards.append((jref, jbuild_fm_index(jref.codes, sa_interval=8, lut_k=8)))
        texts.append(c)
    d = tmp_path_factory.mktemp("tax4")
    _write_taxonomy(d, 4)
    return {"nt": shards, "jnt": jshards, "texts": texts, "taxdb": _taxdb(TaxDB, d),
            "jtaxdb": _taxdb(JTaxDB, d)}


def _config(cls, device_seeding=True, **kw):
    return cls(read_len=80, skip_preprocess=True, skip_human=True,
               device_seeding=device_seeding, **kw)


def _peak_counting(pipe):
    """Count, after every NT commit, how many NT engines are resident
    (test_shard_rotation's probe). Returns the dict holding the peak."""
    peak = {"v": 0, "commits": 0}
    for eng in pipe.nt_engines:
        def counting(eng=eng, orig=eng.commit):
            orig()
            peak["commits"] += 1
            peak["v"] = max(peak["v"], sum(e.committed for e in pipe.nt_engines))
        eng.commit = counting
    return peak


@pytest.fixture(scope="module")
def rotation_runs(world4):
    """The JAX package's waved run (2 virtual devices, host seeding) and
    the port's resident run (device seeding) of the 4 shards' 20 pairs."""
    r1, r2 = _reads(world4["texts"], 5)
    jpipe = JPipeline(world4["jnt"], world4["jtaxdb"], config=_config(JConfig, False),
                      devices=jax.devices()[:2])
    assert jpipe._wave_shards
    resident = MegaPathPipeline(world4["nt"], world4["taxdb"], config=_config(PipelineConfig),
                                device=CPU)
    return {"reads": (r1, r2), "jax": jpipe.run_records(_jax(r1), _jax(r2)),
            "resident": resident.run_records(r1, r2)}


@pytest.mark.parametrize("n_devices,device_seeding", [(1, True), (2, True), (2, False)])
def test_wave_rotation_bounds_residency_and_matches(world4, rotation_runs, n_devices,
                                                    device_seeding):
    pipe = MegaPathPipeline(world4["nt"], world4["taxdb"],
                            config=_config(PipelineConfig, device_seeding),
                            devices=[CPU] * n_devices, device=CPU)
    assert pipe._wave_shards
    assert not any(e.committed for e in pipe.nt_engines)  # lazy: nothing at construction
    assert all(e.lazy_device for e in pipe.nt_engines)
    assert pipe._pool is not None and pipe._pool._max_workers == n_devices
    peak = _peak_counting(pipe)
    got = pipe.run_records(*rotation_runs["reads"])
    assert 0 < peak["v"] <= n_devices, peak
    assert peak["commits"] == 4  # one commit a shard a batch
    assert not any(e.committed for e in pipe.nt_engines)  # evicted after
    lines = [r.to_line() for r in got.lsam_id]
    for key in ("jax", "resident"):
        want = rotation_runs[key]
        assert got.report == want.report, key
        assert got.ra_report == want.ra_report, key
        assert lines == [r.to_line() for r in want.lsam_id], key
        assert [r.to_line() for r in got.ra_lsam_id] == [r.to_line() for r in want.ra_lsam_id]
    assert "Species 3" in got.report


def test_a_failing_shard_raises_and_its_wave_is_evicted(world4, rotation_runs):
    """An exception in a pool thread comes out of run_records; no shard
    stays on its device."""
    pipe = MegaPathPipeline(world4["nt"], world4["taxdb"], config=_config(PipelineConfig),
                            devices=[CPU, CPU], device=CPU)

    def boom(*a, **k):
        raise ZeroDivisionError("shard 1 failed")

    pipe.nt_engines[1].align_pairs = boom
    with pytest.raises(ZeroDivisionError, match="shard 1 failed"):
        pipe.run_records(*rotation_runs["reads"])
    assert not any(e.committed for e in pipe.nt_engines)


# ---------------------------------------------------------------------------
# tests/test_cascade_parity.py::dist_cascade_result: each shard resident on
# its own place, the shards' alignments dispatched from the pool
# ---------------------------------------------------------------------------
def test_distributed_cascade_byte_identical():
    pipe = cs.cascade_pipeline(CPU, True, devices=[CPU, CPU])
    assert not pipe._wave_shards and pipe._pool is not None
    assert all(e.committed and e.dfm is not None for e in pipe.nt_engines)
    # two engines, two table sets: each shard's own
    assert pipe.nt_engines[0].dfm.rows.data_ptr() != pipe.nt_engines[1].dfm.rows.data_ptr()
    threads = set()
    for eng in pipe.nt_engines:
        def on_thread(*a, orig=eng.align_pairs, **k):
            threads.add(threading.current_thread().name)
            return orig(*a, **k)
        eng.align_pairs = on_thread
    res = pipe.run_records(*cs.cascade_reads())
    assert threads and all(t.startswith("nt-shard") for t in threads), threads
    assert res.report == (CAS / "cascade.report").read_text()
    golden = cs.lsam_id_table(open(CAS / "cascade.lsam.id"))
    ours = cs.lsam_id_table(r.to_line() for r in res.lsam_id)
    assert set(golden) == set(ours)
    assert [k for k in golden if golden[k] != ours[k]] == []
    assert all(e.committed for e in pipe.nt_engines)  # resident: nothing evicted


# ---------------------------------------------------------------------------
# run_files: every batch rotates every shard
# ---------------------------------------------------------------------------
def test_run_files_under_rotation_equals_jax(world4, rotation_runs, tmp_path):
    """20 pairs in batches of 7 (3 batches x 4 shards = 12 commits on one
    place, device seeding) against the JAX package's run_files on 2
    virtual devices."""
    r1, r2 = rotation_runs["reads"]
    paths = []
    for end, recs in ((1, r1), (2, r2)):
        paths.append(str(tmp_path / f"r{end}.fq"))
        with open(paths[-1], "w") as f:
            f.writelines(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in recs)
    pipe = MegaPathPipeline(world4["nt"], world4["taxdb"],
                            config=_config(PipelineConfig, batch_size=7), devices=[CPU],
                            device=CPU)
    peak = _peak_counting(pipe)
    got = pipe.run_files(*paths, str(tmp_path / "port"))
    assert peak["v"] == 1 and peak["commits"] == 12, peak
    assert not any(e.committed for e in pipe.nt_engines)
    jpipe = JPipeline(world4["jnt"], world4["jtaxdb"],
                      config=_config(JConfig, False, batch_size=7), devices=jax.devices()[:2])
    want = jpipe.run_files(*paths, str(tmp_path / "jax"))
    for suf in OUTPUTS:
        assert (tmp_path / f"port{suf}").read_bytes() == (tmp_path / f"jax{suf}").read_bytes(), suf
    for k in cs.PIPELINE_COUNTERS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.report == rotation_runs["resident"].report


# ---------------------------------------------------------------------------
# the lazy engine
# ---------------------------------------------------------------------------
def _batch(world4, n=6):
    r1, r2 = _reads(world4["texts"][:1], n)
    return (*pack_reads([r.seq for r in r1], 80), *pack_reads([r.seq for r in r2], 80))


@pytest.mark.parametrize("device_seeding", [False, True])
def test_lazy_engine_raises_until_committed(world4, device_seeding):
    ref, fm = world4["nt"][0]
    batch = _batch(world4)
    lazy = AlignEngine(ref, fm, AlignParams(), device=CPU, device_seeding=device_seeding,
                       lazy_device=True)
    assert not lazy.committed and lazy.dfm is None
    with pytest.raises(RuntimeError, match="not committed"):
        lazy.align_pairs(*batch)
    lazy.commit()
    assert lazy.committed and (lazy.dfm is not None) == device_seeding
    want = AlignEngine(ref, fm, AlignParams(), device=CPU,
                       device_seeding=device_seeding).align_pairs(*batch)
    assert len(want)
    assert np.array_equal(cs.canonical_hits(lazy.align_pairs(*batch)), cs.canonical_hits(want))
    lazy.evict()
    assert not lazy.committed
    with pytest.raises(RuntimeError, match="not committed"):
        lazy.align_pairs(*batch)
    # a non-lazy engine that was evicted commits itself again, as before
    eager = AlignEngine(ref, fm, AlignParams(), device=CPU, device_seeding=device_seeding)
    eager.evict()
    assert np.array_equal(cs.canonical_hits(eager.align_pairs(*batch)), cs.canonical_hits(want))
    assert eager.committed


def test_evict_keeps_the_cross_batch_state(world4):
    """A junk batch flips the engine to the direct exact walk; evict and
    commit keep it (and exact_rescue), so the next batch takes the path an
    engine that never left its device takes."""
    ref, fm = world4["nt"][0]
    rng = np.random.default_rng(9)
    junk = (rng.integers(0, 4, (8, 80)).astype(np.uint8), np.full(8, 80, np.int32),
            rng.integers(0, 4, (8, 80)).astype(np.uint8), np.full(8, 80, np.int32))
    lazy = AlignEngine(ref, fm, AlignParams(), device=CPU, device_seeding=True,
                       lazy_device=True)
    eager = AlignEngine(ref, fm, AlignParams(), device=CPU, device_seeding=True)
    lazy.commit()
    for eng in (lazy, eager):
        eng.align_pairs(*junk)
        assert eng._exact_direct
    lazy.evict()
    lazy.commit()
    assert lazy._exact_direct and lazy.exact_rescue
    batch = _batch(world4)
    assert np.array_equal(cs.canonical_hits(lazy.align_pairs(*batch)),
                          cs.canonical_hits(eager.align_pairs(*batch)))
    assert lazy._exact_direct == eager._exact_direct


def test_recommit_uploads_the_tables_the_first_commit_packed(world4, monkeypatch):
    """HostFM.pack(fm).upload == DeviceFM.from_host, table by table and bit
    by bit; a lazy engine packs once and its re-commit uploads the same
    tables and packed text."""
    ref, fm = world4["nt"][1]
    want = seeding_dev.DeviceFM.from_host(fm, CPU)
    host = seeding_dev.HostFM.pack(fm)
    got = host.upload(CPU)
    fields = ("rows", "counts", "lut_lo", "lut_hi", "mark_rows", "sa_sampled")
    for f in ("n", "primary", "lut_k", "sa_interval"):
        assert getattr(got, f) == getattr(want, f), f
    for f in fields:
        assert getattr(got, f).dtype == getattr(want, f).dtype == torch.int32, f
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.nbytes == want.nbytes == sum(getattr(host, f).nbytes for f in fields)
    eng = AlignEngine(ref, fm, AlignParams(), device=CPU, device_seeding=True, lazy_device=True)
    eng.commit()
    batch = _batch(world4)
    eng.align_pairs(*batch)
    first = {f: getattr(eng.dfm, f).clone() for f in fields}
    words = eng._ref_words_dev.clone()

    def no_pack(*a, **k):
        raise AssertionError("a re-commit packed the tables again")

    monkeypatch.setattr(seeding_dev.HostFM, "pack", no_pack)
    monkeypatch.setattr("megapath_tpu_torch.align.engine.pack_ref_words", no_pack)
    for _ in range(2):
        eng.evict()
        eng.commit()
        for f in fields:
            assert torch.equal(getattr(eng.dfm, f), first[f]), f
            assert torch.equal(getattr(eng.dfm, f), getattr(want, f)), f
        assert torch.equal(eng._ref_words_dev, words)
        eng.align_pairs(*batch)


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"], ["cuda:0"]])
def test_mixed_device_types_are_refused(world4, devices):
    with pytest.raises(ValueError, match="mixes device types"):
        MegaPathPipeline(world4["nt"], world4["taxdb"], config=_config(PipelineConfig),
                         devices=devices, device=CPU)


def test_empty_devices_is_the_single_device_pipeline(world4):
    for devices in (None, []):
        pipe = MegaPathPipeline(world4["nt"], world4["taxdb"], config=_config(PipelineConfig),
                                devices=devices, device=CPU)
        assert pipe._pool is None and not pipe._wave_shards
        assert all(e.committed and not e.lazy_device for e in pipe.nt_engines)


# ---------------------------------------------------------------------------
# the kernel library under threads (no nvcc here: a stub build and load)
# ---------------------------------------------------------------------------
N_THREADS = (os.cpu_count() or 1) + 4  # more threads than cores


def _at_once(fn, n=N_THREADS):
    """``fn()`` on ``n`` threads released together, the interpreter
    switching threads every microsecond; their results (each waited for at
    most 60 s)."""
    gate = threading.Barrier(n)

    def run():
        gate.wait(timeout=60)
        return fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            return [f.result(timeout=60) for f in [pool.submit(run) for _ in range(n)]]
    finally:
        sys.setswitchinterval(interval)


def test_load_builds_and_loads_once_under_threads(monkeypatch):
    calls = {"build": 0, "cdll": 0}

    def slow_build(force=False):
        calls["build"] += 1
        time.sleep(0.05)
        return 0.05

    def cdll(path):
        calls["cdll"] += 1
        return types.SimpleNamespace(path=path)

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "bind", lambda lib: lib)
    libs = _at_once(_build.load)
    assert calls == {"build": 1, "cdll": 1}
    assert all(lib is libs[0] for lib in libs)


def test_launch_counts_are_exact_under_threads():
    counts = types.SimpleNamespace(launches=0)

    def bump():
        for _ in range(2000):
            _build.count(counts, "launches")

    _at_once(bump)
    assert counts.launches == N_THREADS * 2000


def test_counts_of_many_are_exact_under_threads():
    """``count(module, name, n)`` adds ``n`` (the pairs a stage handled),
    under the same lock."""
    counts = types.SimpleNamespace(pairs=0)

    def bump():
        for k in range(2000):
            _build.count(counts, "pairs", k % 7)

    _at_once(bump)
    assert counts.pairs == N_THREADS * sum(k % 7 for k in range(2000))


@pytest.mark.parametrize("module,names", [
    (dp_cuda, ("launches", "fwd_launches")),
    (seed_cuda, ("walk_launches", "locate_launches")),
    (protein_cuda, ("launches",)),
    (sort_cuda, ("sort_launches",)),
])
def test_every_launch_count_goes_through_the_lock(module, names):
    """Each wrapper adds to its count through ``_build.count`` (under its
    lock), once, where it launches; none adds to it bare."""
    src = pathlib.Path(module.__file__).read_text()
    for name in names:
        assert isinstance(getattr(module, name), int)
        assert f'_build.count(sys.modules[__name__], "{name}")' in src, name
        assert f"{name} += 1" not in src, name


def test_occupancy_is_asked_once_under_threads(monkeypatch):
    calls = []

    def occ(out):
        calls.append(1)
        time.sleep(0.05)
        for i, v in enumerate((128, 10584, 4, 132, 0, 4)):
            out[i] = v
        return 0

    lib = types.SimpleNamespace(mp_sw_subst_occupancy=occ)
    monkeypatch.setattr(protein_cuda, "_occupancy", {})
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: threading.Lock())
    got = _at_once(lambda: protein_cuda.occupancy(torch.device("cuda", 0)))
    assert len(calls) == 1
    assert all(g == got[0] for g in got) and got[0]["sms"] == 132
