"""ctypes wrapper of the hand-written CUDA substitution-matrix DP
(``csrc/sw_subst.cu``).

``sw_align_substmat_cuda`` ports ``megapath_tpu/ops/dp.py::
sw_align_substmat`` (a jit ``lax.scan``), the DP of the protein path's
``blastx``: the contract of the plain ``ops.dp.sw_align_substmat``, in
JAX's layout at the public function (reads [B, R], refs [B, W], lengths
[B], subst [n_codes, n_codes]). The kernel launches on the current
stream, synchronises nothing and allocates nothing; this wrapper checks
its inputs, allocates the outputs and, for windows wider than a tile,
the scratch rows that carry a tile's last row to the next, and raises
when the launch is refused.
"""

from __future__ import annotations

import torch

from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp import DPParams, DPResult
from megapath_tpu_torch.ops.dp_cuda import check_tensor

# the largest alphabet the kernel's shared-memory table holds
MAX_CODES = 32
# subject rows a tile holds (``kTile`` in sw_subst.cu): wider windows are
# cut into tiles that hand their last row on through scratch
TILE_ROWS = 512

# Kernel launches since the last reset; chip_smoke.py zeroes it and reads
# it back to show that the protein path went through the kernel.
launches = 0


def sw_align_substmat_cuda(
    reads: torch.Tensor,  # uint8 [B, R] query codes on a CUDA device
    refs: torch.Tensor,  # uint8 [B, W] subject window codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    subst: torch.Tensor,  # int32 [n_codes, n_codes]
    params: DPParams = DPParams(),
) -> DPResult:
    """The substitution-matrix DP on the card: (score, end_ref, end_read)
    per candidate, equal to ``ops.dp.sw_align_substmat``."""
    global launches
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp_sw_subst(
            reads.data_ptr(), refs.data_ptr(), read_lens.data_ptr(), ref_lens.data_ptr(),
            subst.data_ptr(), *(out[k].data_ptr() for k in range(3)),
            None if carry is None else carry.data_ptr(), B, R, W, n_codes,
            params.gap_open, params.gap_extend, stream,
        )
    if err != 0:
        raise RuntimeError(f"mp_sw_subst launch failed: CUDA error {err}")
    launches += 1
    return DPResult(*out)
