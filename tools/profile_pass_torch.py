#!/usr/bin/env python
"""Profile of one warm ``align_pairs`` pass of the PyTorch port on one
CUDA card, on the toy workload of ``chip_smoke.py`` phase 5.

Usage: python tools/profile_pass_torch.py

After one warm-up pass it runs two more:

1. a pass with each DP kernel launch timed by CUDA events (its shape
   and ms), the host seed split into the walk (``mmp_seed``) and the
   decode (``decode_seeds``), and cProfile over the whole pass;
2. a pass under ``torch.profiler``, whose device time over the pass's
   wall time is the card's busy share.

It prints a summary and writes the cProfile and torch.profiler tables to
``chiprun_out/profile_pass_torch.txt``. It imports torch, numpy and
``megapath_tpu_torch``, and nothing of jax.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import time
from collections import defaultdict

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this profile needs one NVIDIA card")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import megapath_tpu_torch.align.engine as eng_mod
    from megapath_tpu_torch.align.engine import AlignEngine
    from megapath_tpu_torch.align.params import AlignParams
    from megapath_tpu_torch.ops import dp_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    ref, fm, reads1, lens1, reads2, lens2 = chip_smoke.toy_workload(dev)
    engine = AlignEngine(ref, fm, AlignParams(), device=dev)
    engine.align_pairs(reads1, lens1, reads2, lens2)  # warm-up

    # pass 1: per-launch CUDA events, walk/decode split, cProfile
    kernel = dp_cuda.sw_align_full_cuda
    launches = []

    def timed_kernel(reads, refs, read_lens, ref_lens, params):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = kernel(reads, refs, read_lens, ref_lens, params)
        b.record()
        launches.append((tuple(reads.shape), refs.shape[1], a, b))
        return out

    split = defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[name] += time.perf_counter() - t
        return run

    walk, decode = eng_mod.mmp_seed, eng_mod.decode_seeds
    dp_cuda.sw_align_full_cuda = timed_kernel
    eng_mod.mmp_seed = timed("walk", walk)
    eng_mod.decode_seeds = timed("decode", decode)
    prof = cProfile.Profile()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof.enable()
        hits = engine.align_pairs(reads1, lens1, reads2, lens2)
        prof.disable()
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t
    finally:
        dp_cuda.sw_align_full_cuda = kernel
        eng_mod.mmp_seed, eng_mod.decode_seeds = walk, decode
    print(f"[profile] pass 1 (cProfile on): {pass_s} s, {len(hits)} hits; "
          f"walk {split['walk']} s, decode {split['decode']} s [{smi}]")
    kernel_ms = 0.0
    for (C, R), W, a, b in launches:
        ms = a.elapsed_time(b)
        kernel_ms += ms
        print(f"[profile] launch C={C} R={R} W={W}: {ms} ms")
    print(f"[profile] {len(launches)} launches, {kernel_ms} ms of CUDA events")
    cp = io.StringIO()
    st = pstats.Stats(prof, stream=cp)
    st.sort_stats("cumulative").print_stats(30)
    st.sort_stats("tottime").print_stats(15)

    # pass 2: torch.profiler, the card's busy share
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        engine.align_pairs(reads1, lens1, reads2, lens2)
        torch.cuda.synchronize()
    pass2_s = time.perf_counter() - t
    events = tp.key_averages()
    key = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    # the kernels' own rows (CPU ops carry their children's device time)
    device_us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    print(f"[profile] pass 2 (torch.profiler on): {pass2_s} s, device time "
          f"{device_us / 1e3} ms, busy share {device_us / 1e6 / pass2_s} [{smi}]")
    table = events.table(sort_by=key, row_limit=15)
    print(table)

    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_pass_torch.txt"), "w") as f:
        f.write(f"{smi}\n\n# cProfile, pass 1\n{cp.getvalue()}\n"
                f"# torch.profiler, pass 2\n{table}\n")
    print(cp.getvalue()[:5000])


if __name__ == "__main__":
    main()
