"""ctypes wrapper of the index build's pair sort on the card.

``sort_pairs_cuda`` launches ``csrc/sort_pairs.cu`` (CUB's radix sort
over double buffers) for ``index/suffix.py``'s prefix doubling. It sorts
in the caller's buffers, launches on the current stream and synchronises
nothing; the wrapper checks its inputs, allocates CUB's temporary and
raises when a launch is refused. The plain version is ``torch.sort``,
which ``index/suffix.py`` takes for CPU tensors.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp_cuda import check_tensor

# Sort launches since the last reset (chip_smoke.py reads them).
sort_launches = 0


def sort_pairs_cuda(keys: list, vals: list, src: int, end_bit: int) -> int:
    """Sort ``keys[src]`` (int64, every key in [0, 2**end_bit)) and carry
    ``vals[src]`` (int32) with it, stably, using ``keys[1 - src]`` and
    ``vals[1 - src]`` as the other halves of CUB's double buffers.
    Returns the index in ``keys``/``vals`` of the sorted pairs."""
    dev = keys[src].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA pair sort needs CUDA tensors, got {dev}")
    n = keys[0].shape[0]
    for i in (0, 1):
        check_tensor(f"keys[{i}]", keys[i], torch.int64, 1, dev)
        check_tensor(f"vals[{i}]", vals[i], torch.int32, 1, dev)
        if keys[i].shape[0] != n or vals[i].shape[0] != n:
            raise ValueError("the double buffers differ in length")
    if not 1 <= n < 2**31:
        raise ValueError(f"the pair sort takes 1 to 2^31 - 1 pairs, got {n}")
    if not 1 <= end_bit <= 64:
        raise ValueError(f"end_bit {end_bit} outside 1..64")
    lib = _build.load()
    nbytes = ctypes.c_size_t(0)
    err = lib.mp_sort_pairs_temp_bytes(n, end_bit, ctypes.byref(nbytes))
    if err != 0:
        raise RuntimeError(f"mp_sort_pairs_temp_bytes failed: CUDA error {err}")
    temp = torch.empty(max(1, nbytes.value), dtype=torch.uint8, device=dev)
    selector = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.mp_sort_pairs(
            temp.data_ptr(), nbytes.value, keys[src].data_ptr(), keys[1 - src].data_ptr(),
            vals[src].data_ptr(), vals[1 - src].data_ptr(), n, end_bit,
            ctypes.byref(selector), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0 or selector.value not in (0, 1):
        raise RuntimeError(f"mp_sort_pairs launch failed: CUDA error {err}")
    _build.count(sys.modules[__name__], "sort_launches")
    return src if selector.value == 0 else 1 - src
