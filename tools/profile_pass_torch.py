#!/usr/bin/env python
"""Profile of one warm ``align_pairs`` pass of the PyTorch port on one
CUDA card.

Usage: python tools/profile_pass_torch.py [--host-seeding] [--large]

The workload is ``chip_smoke.py``'s toy workload, or with ``--large`` its
512 Mbp shard; the engine seeds on the device unless ``--host-seeding``.
After one warm-up pass it runs three more:

1. a pass with no instrumentation: its wall time;
2. a pass with each kernel launch timed by CUDA events (name, shape,
   ms), the host stages timed (seeding leg, decode, pairing, DP calls;
   each bracketed by ``torch.cuda.synchronize()``) and cProfile over
   the whole pass;
3. a pass under ``torch.profiler``, whose device time over the pass's
   wall time is the card's busy share.

It prints a summary and writes the cProfile and torch.profiler tables to
``chiprun_out/profile_pass_torch_<toy|large>[_host].txt``. It imports torch, numpy and
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
    from megapath_tpu_torch.ops import dp_cuda, seed_cuda

    host_seeding = "--host-seeding" in sys.argv[1:]
    large = "--large" in sys.argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build = chip_smoke.large_workload if large else chip_smoke.toy_workload
    ref, fm, *batch = build(dev)
    engine = AlignEngine(ref, fm, AlignParams(), device=dev,
                         device_seeding=not host_seeding)
    what = (f"{'512 Mbp' if large else 'toy'} workload, "
            f"{'host' if host_seeding else 'device'} seeding")
    print(f"[profile] {what} [{smi}]")
    engine.align_pairs(*batch)  # warm-up

    # pass 1: wall time, nothing instrumented
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.align_pairs(*batch)
    torch.cuda.synchronize()
    pass0_s = time.perf_counter() - t
    print(f"[profile] pass 1 (no instrumentation): {pass0_s} s, "
          f"{2 * len(batch[1]) / pass0_s} reads/s")

    # pass 2: per-launch CUDA events, host stages, cProfile
    launches = []

    def timed_kernel(name, fn, shape_of):
        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            launches.append((name, shape_of(*a), ev))
            return out
        return run

    split = defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                split[name] += time.perf_counter() - t
        return run

    kernels = {
        (dp_cuda, "sw_align_full_cuda"): ("dp_full", lambda r, w, *_: f"C={r.shape[0]} R={r.shape[1]} W={w.shape[1]}"),
        (seed_cuda, "mmp_seed_cuda"): ("mmp_seed", lambda d, w, *_: f"walkers={w.shape[0]} L={w.shape[1]}"),
        (seed_cuda, "locate_cuda"): ("locate", lambda d, r: f"rows={r.shape[0]}"),
    }
    stages = {
        (eng_mod, "decode_seeds"): "decode",
        (eng_mod, "pair_candidates"): "pairing",
        (eng_mod, "mmp_seed"): "host walk",
        (eng_mod, "device_seed_pipeline_loc"): "device seeding leg",
    }
    saved = {k: getattr(*k) for k in (*kernels, *stages)}
    for (mod, attr), (name, shape_of) in kernels.items():
        setattr(mod, attr, timed_kernel(name, getattr(mod, attr), shape_of))
    for (mod, attr), name in stages.items():
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    for attr in ("_deep_dp_walk_call", "_device_align_rows",
                 "_deep_dp_fused_call", "_device_align"):
        setattr(engine, attr, timed("DP calls", getattr(engine, attr)))
    prof = cProfile.Profile()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof.enable()
        hits = engine.align_pairs(*batch)
        prof.disable()
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    print(f"[profile] pass 2 (cProfile and timers on): {pass_s} s, {len(hits)} hits; "
          + ", ".join(f"{k} {v} s" for k, v in sorted(split.items())) + f" [{smi}]")
    per = defaultdict(float)
    for name, shape, (a, b) in launches:
        ms = a.elapsed_time(b)
        per[name] += ms
        print(f"[profile] {name} {shape}: {ms} ms")
    print(f"[profile] {len(launches)} launches; CUDA-event ms by kernel: {dict(per)}")
    cp = io.StringIO()
    st = pstats.Stats(prof, stream=cp)
    st.sort_stats("cumulative").print_stats(30)
    st.sort_stats("tottime").print_stats(15)

    # pass 3: torch.profiler, the card's busy share
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        engine.align_pairs(*batch)
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
    print(f"[profile] pass 3 (torch.profiler on): {pass2_s} s, device time "
          f"{device_us / 1e3} ms, busy share {device_us / 1e6 / pass2_s} [{smi}]")
    table = events.table(sort_by=key, row_limit=20)
    print(table)

    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    tag = ("large" if large else "toy") + ("_host" if host_seeding else "")
    with open(os.path.join(out, f"profile_pass_torch_{tag}.txt"), "w") as f:
        f.write(f"{smi}\n{what}\n\n# cProfile, pass 2\n{cp.getvalue()}\n"
                f"# torch.profiler, pass 3\n{table}\n")
    print(cp.getvalue()[:4000])


if __name__ == "__main__":
    main()
