"""The arithmetic of the metrics on hand-made numbers and intervals."""

import numpy as np
import pytest

from portbench import peaks, tracing
from portbench.metrics import (
    _dp_roofline,
    device_idle_pct,
    dp_full_roofline,
    dp_fwd_roofline,
    launches_per_kpair,
)
from portbench.run import p90

FWD = "void (anonymous namespace)::dp_wave_kernel<32, 24, false>(unsigned char const*, int)"
FULL = "void (anonymous namespace)::dp_wave_kernel<16, 8, true>(unsigned char const*, int)"


def test_p90_of_a_hundred_batches():
    assert p90(list(range(1, 101))) == pytest.approx(90.1)
    assert p90([5.0]) == 5.0


def test_union_gaps_and_idle_labels():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)]
    assert tracing.merged(dev) == [(10, 30), (50, 60)]
    assert tracing.busy_ns(dev) == 30
    assert tracing.gaps(dev, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert tracing.extent(dev, [("h", 5, 70)]) == (5, 70)
    host = [("portbench.step", 0, 100), ("aten::add", 35, 45), ("portbench.gather", 60, 100)]
    got = tracing.idle_by_host(dev, host, 0, 100, "portbench.")
    assert got == [["portbench.gather", 40e-9], ["portbench.step / aten::add", 20e-9],
                   ["portbench.step", 10e-9]]
    assert tracing.labels_at([], [5], "portbench.") == ["host: none"]
    assert tracing.top_ops(dev, top=1) == [["k2", 15e-9]]


def test_device_idle_share():
    ctx = {"dev": [("k", 0, 25), ("k", 50, 75)], "lo": 0, "hi": 100}
    assert device_idle_pct.read(ctx) == pytest.approx(50.0)
    assert device_idle_pct.read({"dev": [], "lo": 0, "hi": 100}) is None


def test_launches_per_kpair():
    ctx = {"pairs": 200000, "launches": {"a": 30, "b": 10}}
    assert launches_per_kpair.read(ctx) == pytest.approx(0.2)
    assert launches_per_kpair.read({"pairs": 0, "launches": {}}) is None


def test_dp_work_and_bound():
    cells, nbytes = peaks.dp_work([150, 150, 300], [200, 10, 200], R=160, W=256)
    assert cells == 150 * 200 + 150 * 10 + 160 * 200
    assert nbytes == 3 * (160 + 256 + 8 + 12)
    cells2, nbytes2 = peaks.dp_work([150], [200], 160, 256, end_read=[100], end_ref=[120])
    assert cells2 == 150 * 200 + 100 * 120 and nbytes2 == 160 + 256 + 8 + 20
    s, by = peaks.bound_s(10**12, 10)
    assert by == "operations" and s == pytest.approx(10**12 / peaks.DP_CELLS_PER_S)
    s, by = peaks.bound_s(0, 3.35e12)
    assert by == "bytes" and s == pytest.approx(1.0)


def test_dp_roofline_share_from_a_trace():
    rl, wl = np.full(1000, 150), np.full(1000, 256)
    cells, nbytes = peaks.dp_work(rl, wl, 512, 576)
    least = peaks.bound_s(cells, nbytes)[0]
    ns = int(4 * least * 1e9)
    ctx = {"dev": [(FWD, 0, ns), (FULL, 0, 5), ("other", 0, 10**9)],
           "dp_calls": {"fwd": [(512, 576, rl, wl)], "full": []}}
    assert dp_fwd_roofline.read(ctx) == pytest.approx(25.0, rel=1e-4)  # ns rounding
    assert dp_full_roofline.read(ctx) is None  # no launch recorded: nothing to read
    assert _dp_roofline.kernel_seconds(ctx["dev"], backward=True) == pytest.approx(5e-9)
