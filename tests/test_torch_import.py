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
import chip_smoke

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
