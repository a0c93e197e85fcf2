"""The port and the chip smoke import without jax and without the JAX
package, and without a card the port refuses to run its kernels instead
of carrying on on the CPU."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from megapath_tpu_torch.align.params import MmpParams
from megapath_tpu_torch.align.seeding_dev import DeviceFM
from megapath_tpu_torch.ops import _build, dp_cuda, seed_cuda
from megapath_tpu_torch.ops.dp import DPParams

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "megapath_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import megapath_tpu_torch
import megapath_tpu_torch.align
import megapath_tpu_torch.align.engine
import megapath_tpu_torch.align.seeding_dev
from megapath_tpu_torch.align.device import (
    align_rows_walk, align_step, deep_dp_fused_walk, gather_windows_packed,
    pair_align_step,
)
import megapath_tpu_torch.convert
import megapath_tpu_torch.index.fm
import megapath_tpu_torch.io.fastq
import megapath_tpu_torch.ops.dp_cuda
import megapath_tpu_torch.ops.seed_cuda
import megapath_tpu_torch.ops.sort_cuda
import megapath_tpu_torch.index.suffix
import megapath_tpu_torch.classify.reassign
import megapath_tpu_torch.filters.bbduk
import megapath_tpu_torch.filters.spike
import megapath_tpu_torch.io.lsam
import megapath_tpu_torch.io.stream
import megapath_tpu_torch.native
import megapath_tpu_torch.pipeline
import megapath_tpu_torch.taxonomy.report
import megapath_tpu_torch.taxonomy.taxdb
import megapath_tpu_torch.utils.timing
import megapath_tpu_torch.cli
import megapath_tpu_torch.classify.taxlookup
import megapath_tpu_torch.index.shard
import megapath_tpu_torch.io.bam
import megapath_tpu_torch.io.sam
import megapath_tpu_torch.classify.extras
import megapath_tpu_torch.io.sam2cfq
import megapath_tpu_torch.utils.accuracy
import megapath_tpu_torch.index.dbtools
import megapath_tpu_torch.filters.bbnorm
import megapath_tpu_torch.pipeline.multik
import megapath_tpu_torch.pipeline.assembly
import megapath_tpu_torch.classify.protein
import megapath_tpu_torch.ops.protein_cuda
import chip_smoke

# the subcommands import their modules when they run: run each host tool
# once so that a jax import inside one would show here
import io, os, tempfile
from megapath_tpu_torch import cli
with tempfile.TemporaryDirectory() as d:
    m8 = os.path.join(d, "a.m8")
    with open(m8, "w") as f:
        f.write("q1\t562\t99\t50\t0\t0\t1\t50\t10\t59\t1e-9\t90\n")
    lsam = os.path.join(d, "a.lsam")
    with open(lsam, "w") as f:
        f.write("r1\t64\t50\tACGT\tIIII\t50,562\nr1\t128\t10\tTTAA\tIIII\t*\n")
    sam = os.path.join(d, "a.sam")
    with open(sam, "w") as f:
        f.write("r9\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII\tNM:i:0\n")
    out = sys.stdout
    sys.stdout = io.StringIO()
    try:
        for argv in (["m8-to-lsam", m8], ["m8-cov", m8], ["maplen-hist", m8],
                     ["extract", "-t", "40", lsam], ["cleanup", lsam], ["sam2cfq", sam],
                     ["r2c-to-r2g", lsam, lsam],
                     ["count-table", "tests/fixtures/nodes.dmp", "tests/fixtures/names.dmp", lsam]):
            assert cli.main(argv) == 0, argv
    finally:
        sys.stdout = out

# run -A --protein-db on the CPU: a dense tiling of the world's SARS-CoV-2
# genome against an NT index of HCoV-229E alone, so every pair is unmapped
# and goes through bbnorm, the multi-k assembler and the contig engine, and
# the contig through blastx against the world protein DB; one torch thread,
# as tests/torch_cpu.py pins the test processes it runs beside
import contextlib
import torch
import chip_smoke as cs
torch.set_num_threads(1)
(_, _, g), hcov = cs.world_workload(n=0)["nt"][1]
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stderr(io.StringIO()), \
        contextlib.redirect_stdout(io.StringIO()):
    cs.write_fasta(os.path.join(d, "nt.fa"), [hcov])
    cs.write_protein_fasta(os.path.join(d, "prot.fa"), cs.protein_world_db(cs.world_workload()))
    os.mkdir(os.path.join(d, "nt"))
    assert cli.main(["build-index", os.path.join(d, "nt.fa"), os.path.join(d, "nt", "nt"),
                     "--sa-interval", "4", "--lut-k", "6", "--device", "cpu"]) == 0
    for end, fn in ((1, lambda p: g[p : p + 80]),
                    (2, lambda p: cs._COMP[g[p + 220 : p + 300][::-1]])):
        with open(os.path.join(d, f"r{end}.fq"), "w") as f:
            for i, p in enumerate(range(1000, 1400, 10)):
                f.write(f"@v{i}/{end}\n{cs._text(fn(p))}\n+\n{'I' * 80}\n")
    prefix = os.path.join(d, "asm")
    assert cli.main(["run", "-1", os.path.join(d, "r1.fq"), "-2", os.path.join(d, "r2.fq"),
                     "-p", prefix, "--nt-index", os.path.join(d, "nt", "shard0"),
                     "--nodes", "tests/fixtures/nodes.dmp", "--names", "tests/fixtures/names.dmp",
                     "--acc2tid", "tests/fixtures/acc2tid.map", "-L", "80", "--skip-preprocess",
                     "-A", "--protein-db", os.path.join(d, "prot.fa"), "--device", "cpu"]) == 0
    assert open(prefix + ".contigs.fa").read().startswith(">ctg0")
    assert open(prefix + ".r2c.lsam").read()
    assert "694009" in open(prefix + ".nr.lsam.id").read()

bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    """jax and every ``megapath_tpu`` module are blocked; nothing of them
    may load."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


def _batch(device="cpu"):
    C, R, W = 4, 8, 16
    return (
        torch.zeros((C, R), dtype=torch.uint8, device=device),
        torch.zeros((C, W), dtype=torch.uint8, device=device),
        torch.full((C,), R, dtype=torch.int32, device=device),
        torch.full((C,), W, dtype=torch.int32, device=device),
    )


def test_kernel_entry_refuses_cpu_tensors():
    before = dp_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.sw_align_full_cuda(*_batch(), DPParams())
    assert dp_cuda.launches == before


def test_fwd_kernel_entry_refuses_cpu_tensors():
    before = dp_cuda.fwd_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.sw_align_cuda(*_batch(), DPParams())
    assert dp_cuda.fwd_launches == before


def _cpu_tables():
    from megapath_tpu_torch.index.fm import build_fm_index

    codes = np.random.default_rng(1).integers(0, 4, 300).astype(np.uint8)
    fm = build_fm_index(codes, sa_interval=4, lut_k=4, device=torch.device("cpu"))
    return DeviceFM.from_host(fm, torch.device("cpu"))


def test_seed_kernel_entries_refuse_cpu_tensors():
    dfm = _cpu_tables()
    before = (seed_cuda.walk_launches, seed_cuda.locate_launches)
    walkers = torch.zeros((4, 20), dtype=torch.uint8)
    lens = torch.full((4,), 20, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        seed_cuda.mmp_seed_cuda(dfm, walkers, lens, MmpParams())
    with pytest.raises(ValueError, match="CUDA tensors"):
        seed_cuda.locate_cuda(dfm, torch.ones(3, dtype=torch.int32))
    assert (seed_cuda.walk_launches, seed_cuda.locate_launches) == before


def test_seed_tables_must_be_aligned_for_the_kernels():
    """The kernels read an occ row as four uint4s and a mark row as one
    uint2: a misaligned table is refused before a launch."""
    import dataclasses

    dfm = _cpu_tables()
    flat = torch.zeros(dfm.rows.numel() + 1, dtype=torch.int32)
    odd = dataclasses.replace(dfm, rows=flat[1:].view(dfm.rows.shape))
    with pytest.raises(ValueError, match="16-byte"):
        seed_cuda._check_tables(odd, torch.device("cpu"))
    seed_cuda._check_tables(dfm, torch.device("cpu"))


def test_engine_on_cuda_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    from megapath_tpu_torch.align.engine import AlignEngine
    from megapath_tpu_torch.align.params import AlignParams
    from megapath_tpu_torch.index.fm import build_fm_index
    from megapath_tpu_torch.index.pack import PackedReference

    codes = np.random.default_rng(0).integers(0, 4, 400).astype(np.uint8)
    ref = PackedReference(codes, ["s"], ["s"], np.array([0, 400]), np.zeros((0, 2), np.int64))
    fm = build_fm_index(codes, sa_interval=8, lut_k=4, device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlignEngine(ref, fm, AlignParams(), device=torch.device("cuda"))


def test_kernel_build_refuses_without_nvcc():
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is present: the build can run")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)
