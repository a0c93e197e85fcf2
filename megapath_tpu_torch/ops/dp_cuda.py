"""ctypes wrappers of the hand-written CUDA DP kernel (``csrc/dp_full.cu``).

``sw_align_full_cuda`` ports ``sw_align_full_pallas_t`` and
``sw_align_cuda`` ports ``sw_align_pallas`` (the forward-only
``_dp_kernel``), both in ``megapath_tpu/ops/dp_pallas.py``: the same
contracts as the plain ``ops.dp.sw_align_full`` and ``ops.dp.sw_align``,
in JAX's layout at the public function (reads [C, R], refs [C, W],
lengths [C]). The kernel launches on the current stream, synchronises
nothing and allocates nothing; these wrappers check their inputs (the
int16 score range too, ``int16_range_error``, before the library is
loaded; only a batch whose padded widths fail it has its lengths read
back), allocate the outputs and raise when the launch is refused.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp import DPFullResult, DPParams, DPResult

# The widest window the kernel takes (``kMaxWidth`` in dp_full.cu): the
# engine's widest is the mate rescue's round_up(750 + L + 62, 128) = 1920
# at its longest read, L = 1023.
MAX_WIDTH = 2048

# The kernel's scores are int16; its running best keys a cell as
# H * 64 + (63 - row in the lane), which must fit 16 bits unsigned.
MAX_SCORE = 1023


def int16_range_error(R: int, W: int, params: DPParams, span: Optional[int] = None
                      ) -> Optional[str]:
    """Why the int16x2 kernel cannot take reads of width R, windows of W
    and these scores, or None when it can. The best local score is at
    most span * match, where ``span`` is the batch's largest min(read
    length, window length) (at most, and by default, min(R, W)); a cell
    past a read or window length must score below a real one (mismatch
    and gap open < 0, gap extend <= 0); the substitution score comes from
    a 9-bit code difference scaled by 64, so match - mismatch <= 64."""
    m, mm, go, ge = params
    if m < 1:
        return f"match {m} < 1"
    if mm >= 0 or go >= 0 or ge > 0:
        return (f"mismatch {mm} and gap_open {go} must be < 0 and gap_extend {ge} "
                "<= 0: a cell past a read or window length must not score")
    if m - mm > 64:
        return f"match - mismatch = {m - mm} > 64 leaves the substitution code's range"
    if go < -1024:
        return f"gap_open {go} < -1024 leaves the int16 range"
    span = min(R, W) if span is None else min(span, R, W)
    if span * m > MAX_SCORE:
        return (f"min(read length, window length) * match = {span * m} > {MAX_SCORE}: "
                "the scores leave the kernel's int16 range")
    return None


def longest_span(read_lens: torch.Tensor, ref_lens: torch.Tensor, R: int, W: int) -> int:
    """The batch's largest min(read length, window length), the lengths
    clamped to [0, R] and [0, W] as the kernel clamps them (0 for an
    empty batch)."""
    if read_lens.numel() == 0:
        return 0
    return int(torch.minimum(read_lens.clamp(0, R), ref_lens.clamp(0, W)).max())


# Kernel launches since the last reset, one count per entry point;
# chip_smoke.py zeroes them and reads them back to show that the main
# path went through the kernels.
launches = 0  # mp_dp_full
fwd_launches = 0  # mp_dp_fwd


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_batch(reads, refs, read_lens, ref_lens, params: DPParams):
    """Validate one DP batch for the kernel; returns (lib, C, R, W)."""
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA DP kernel needs CUDA tensors, got {dev}")
    check_tensor("reads", reads, torch.uint8, 2, dev)
    check_tensor("refs", refs, torch.uint8, 2, dev)
    check_tensor("read_lens", read_lens, torch.int32, 1, dev)
    check_tensor("ref_lens", ref_lens, torch.int32, 1, dev)
    C, R = reads.shape
    W = refs.shape[1]
    if refs.shape[0] != C or read_lens.shape[0] != C or ref_lens.shape[0] != C:
        raise ValueError(
            f"row counts differ: reads {C}, refs {refs.shape[0]}, "
            f"read_lens {read_lens.shape[0]}, ref_lens {ref_lens.shape[0]}"
        )
    if params.gap_open > params.gap_extend:
        # the kernel's in-column gap chain runs through H with its E term,
        # which equals the plain chain through H_noE only while opening
        # costs at least as much as extending (ops/dp.py)
        raise ValueError(f"gap_open > gap_extend is outside the kernel's contract: {params}")
    if W < 1 or W > MAX_WIDTH:
        raise ValueError(f"window width {W} outside 1..{MAX_WIDTH}")
    why = int16_range_error(R, W, params)
    if why and min(R, W) * params.match > MAX_SCORE:
        # reads padded past their lengths (the pipeline pads to
        # max_read_len): the bound is the batch's own, one read-back
        why = int16_range_error(R, W, params, longest_span(read_lens, ref_lens, R, W))
    if why:
        raise ValueError(f"outside the int16 kernel's contract: {why}")
    return _build.load(), C, R, W


def sw_align_full_cuda(
    reads: torch.Tensor,  # uint8 [C, R] on a CUDA device
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Forward + backward DP on the card: (score, end, start) per row."""
    lib, C, R, W = _check_batch(reads, refs, read_lens, ref_lens, params)
    dev = reads.device
    # the kernel writes every row of all five outputs
    out = torch.empty((5, C), dtype=torch.int32, device=dev)
    if C == 0:
        return DPFullResult(*out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp_dp_full(
            reads.data_ptr(), refs.data_ptr(), read_lens.data_ptr(),
            ref_lens.data_ptr(), *(out[k].data_ptr() for k in range(5)),
            C, R, W, params.match, params.mismatch, params.gap_open,
            params.gap_extend, stream,
        )
    if err != 0:
        raise RuntimeError(f"mp_dp_full launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "launches")
    return DPFullResult(*out)


def sw_align_cuda(
    reads: torch.Tensor,  # uint8 [C, R] on a CUDA device
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPResult:
    """Forward DP alone on the card: (score, end_ref, end_read) per row."""
    lib, C, R, W = _check_batch(reads, refs, read_lens, ref_lens, params)
    dev = reads.device
    out = torch.empty((3, C), dtype=torch.int32, device=dev)
    if C == 0:
        return DPResult(*out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp_dp_fwd(
            reads.data_ptr(), refs.data_ptr(), read_lens.data_ptr(),
            ref_lens.data_ptr(), *(out[k].data_ptr() for k in range(3)),
            C, R, W, params.match, params.mismatch, params.gap_open,
            params.gap_extend, stream,
        )
    if err != 0:
        raise RuntimeError(f"mp_dp_fwd launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "fwd_launches")
    return DPResult(*out)
