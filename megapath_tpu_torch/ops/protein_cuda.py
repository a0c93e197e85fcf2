"""ctypes wrapper of the hand-written CUDA substitution-matrix DP
(``csrc/sw_subst.cu``).

``sw_align_substmat_cuda`` ports ``megapath_tpu/ops/dp.py::
sw_align_substmat`` (a jit ``lax.scan``), the DP of the protein path's
``blastx``: the contract of the plain ``ops.dp.sw_align_substmat``, in
JAX's layout at the public function (reads [B, R], refs [B, W], lengths
[B], subst [n_codes, n_codes]). The kernel launches on the current
stream, synchronises nothing and allocates nothing; this wrapper checks
its inputs, allocates the outputs and, for windows wider than a tile,
the scratch rows that carry a tile's last row to the next, computes the
kernel's schedule on the card (``schedule``: the candidates longest
first, and how many of them take a whole block) and raises when the
launch is refused. The grid is the card's resident blocks
(``occupancy``), capped by the batch.
"""

from __future__ import annotations

import ctypes
import sys
import threading

import torch

from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp import DPParams, DPResult
from megapath_tpu_torch.ops.dp_cuda import check_tensor

# the largest alphabet the kernel's shared-memory table holds
MAX_CODES = 32
# subject rows a tile holds (``kTile`` in sw_subst.cu): wider windows are
# cut into tiles that hand their last row on through scratch
TILE_ROWS = 512
# a candidate is long, and takes a whole block, when its critical path is
# at least LONG_FACTOR times the batch's total over the card's resident
# warps: alone in a warp it would outlast twice the even share of the
# batch a warp gets (None: no candidate is long). At 1, 457 of the main
# shape's 3,072 candidates (3072, 3334, 320) went long and it ran 1.17x
# slower (NVIDIA H100, tools/kernel_turns.py --subst-scan); at 1, 2 and 4
# the padded batch's 64 long frames go long alike.
LONG_FACTOR = 2

# Kernel launches since the last reset; chip_smoke.py zeroes it and reads
# it back to show that the protein path went through the kernel.
launches = 0


def schedule(read_lens: torch.Tensor, ref_lens: torch.Tensor, R: int, W: int,
             resident_warps: int, long_factor=LONG_FACTOR) -> tuple:
    """The kernel's schedule, on the lengths' device: ``order`` int32 [B],
    the candidates by decreasing critical path (n_cols * ceil(n_rows /
    32), lengths clamped to R and W), ties in index order, and
    ``sched`` int32 [2]: 0 (the kernel's item counter, which the launch
    zeroes anyway) and the number of long candidates, which stand first in
    ``order``: those with a critical path > 0 and at least
    ``long_factor`` x the batch's total / ``resident_warps`` (none when
    ``long_factor`` is None)."""
    # one warp's steps times rows a lane, n_cols * ceil(n_rows / 32)
    cost = read_lens.long().clamp(0, R) * ((ref_lens.long().clamp(0, W) + 31) // 32)
    order = torch.sort(-cost, stable=True).indices.to(torch.int32)
    sched = torch.zeros(2, dtype=torch.int32, device=cost.device)
    if long_factor is not None:
        long = (cost > 0) & (cost * resident_warps >= long_factor * cost.sum())
        sched[1] = long.sum()
    return order, sched


_occupancy = {}
_occupancy_lock = threading.Lock()


def occupancy(dev: torch.device) -> dict:
    """What the kernel gets on ``dev``'s card (``mp_sw_subst_occupancy``):
    registers a thread, static shared memory a block, resident blocks an
    SM, SMs, local memory a thread (spills) and warps a block. Asked once a
    card, also when several threads ask at once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _build.load()
    key = (index, id(lib))
    with _occupancy_lock:
        if key not in _occupancy:
            out = (ctypes.c_int * 6)()
            with torch.cuda.device(index):
                err = lib.mp_sw_subst_occupancy(out)
            if err != 0:
                raise RuntimeError(f"mp_sw_subst_occupancy failed: CUDA error {err}")
            keys = ("registers", "shared_bytes", "blocks_per_sm", "sms", "local_bytes",
                    "warps")
            _occupancy[key] = dict(zip(keys, out))
        return _occupancy[key]


def sw_align_substmat_cuda(
    reads: torch.Tensor,  # uint8 [B, R] query codes on a CUDA device
    refs: torch.Tensor,  # uint8 [B, W] subject window codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    subst: torch.Tensor,  # int32 [n_codes, n_codes]
    params: DPParams = DPParams(),
    long_factor=LONG_FACTOR,
) -> DPResult:
    """The substitution-matrix DP on the card: (score, end_ref, end_read)
    per candidate, equal to ``ops.dp.sw_align_substmat``. ``long_factor``
    sets which candidates take a whole block (``schedule``)."""
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA substitution DP kernel needs CUDA tensors, got {dev}")
    check_tensor("reads", reads, torch.uint8, 2, dev)
    check_tensor("refs", refs, torch.uint8, 2, dev)
    check_tensor("read_lens", read_lens, torch.int32, 1, dev)
    check_tensor("ref_lens", ref_lens, torch.int32, 1, dev)
    check_tensor("subst", subst, torch.int32, 2, dev)
    B, R = reads.shape
    W = refs.shape[1]
    if refs.shape[0] != B or read_lens.shape[0] != B or ref_lens.shape[0] != B:
        raise ValueError(
            f"row counts differ: reads {B}, refs {refs.shape[0]}, "
            f"read_lens {read_lens.shape[0]}, ref_lens {ref_lens.shape[0]}"
        )
    n_codes = subst.shape[0]
    if subst.shape[1] != n_codes or not 1 <= n_codes <= MAX_CODES:
        raise ValueError(f"subst is {tuple(subst.shape)}: the kernel takes a square "
                         f"table of 1 to {MAX_CODES} codes")
    lib = _build.load()
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B == 0:
        return DPResult(*out)
    carry = (torch.empty((B, 2, R, 2), dtype=torch.int32, device=dev)
             if W > TILE_ROWS else None)
    occ = occupancy(dev)
    resident = occ["blocks_per_sm"] * occ["sms"]
    order, sched = schedule(read_lens, ref_lens, R, W, resident * occ["warps"], long_factor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp_sw_subst(
            reads.data_ptr(), refs.data_ptr(), read_lens.data_ptr(), ref_lens.data_ptr(),
            subst.data_ptr(), *(out[k].data_ptr() for k in range(3)),
            None if carry is None else carry.data_ptr(), order.data_ptr(), sched.data_ptr(),
            B, R, W, n_codes, params.gap_open, params.gap_extend, min(resident, B), stream,
        )
    if err != 0:
        raise RuntimeError(f"mp_sw_subst launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "launches")
    return DPResult(*out)
