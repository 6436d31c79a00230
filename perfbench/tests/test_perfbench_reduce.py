"""The benchmark's arithmetic on hand-worked records."""

import pytest

from perfbench import reduce
from perfbench.trace import WINDOW, reduce_trace


def test_the_tail_is_over_every_call():
    calls = [0.1] * 95 + [1.0] * 5
    assert reduce.percentile(calls, 95) == 0.1
    assert reduce.percentile(calls + [2.0], 95) == 1.0
    assert reduce.percentile([3.0], 95) == 3.0
    assert reduce.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        reduce.percentile([], 95)


def test_idle_share_from_kernel_intervals():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 12.0)]
    assert reduce.union_seconds(iv, 0.0, 10.0) == pytest.approx(4.5)  # [1,4] + [6,7] + [9.5,10]
    assert reduce.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert reduce.idle_pct(4.0, 10.0) == pytest.approx(60.0)
    assert reduce.union_seconds([], 0.0, 1.0) == 0.0
    assert reduce.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_the_ccl_byte_bound():
    # 256 frames of 1000x1000 decimated by 2: 500x500 int8 in, int32 out.
    b = reduce.ccl_bytes(256, 1000, 1000, 2)
    assert b == 256 * 500 * 500 * 5
    # That many bytes at 3.35 TB/s take 0.0955 ms; a kernel at twice that is at 50 %.
    assert b / reduce.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0955, abs=5e-5)
    assert reduce.roofline_pct(b, 2 * b / reduce.HBM_BYTES_PER_S) == pytest.approx(50.0)


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_a_trace_reduces_to_stage_time_busy_time_and_idle_gaps():
    events = [
        ev("user_annotation", WINDOW, 0, 100),
        ev("user_annotation", "stage_ccl", 10, 10),
        ev("cpu_op", "aten::add", 30, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=2),
        ev("kernel", "ccl_local(signed char const*)", 20, 10, tid=7, corr=1),
        ev("kernel", "elementwise", 40, 20, tid=7, corr=2),
        ev("gpu_memcpy", "Memcpy DtoH", 55, 10, tid=7, corr=3),
    ]
    r = reduce_trace(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)  # [20,30] + [40,65]
    assert r["kernels"] == 2
    assert r["stage_s"] == {"stage_ccl": pytest.approx(10e-6)}
    assert r["ccl_s"] == pytest.approx(10e-6)
    assert r["outside_stage_s"] == pytest.approx(30e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # idle [0,20] starts in no host range; [30,40] starts inside aten::add; [65,100] in none.
    assert gaps["python"] == pytest.approx(55e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["detect.ccl"] == pytest.approx(10e-6) and ops["elementwise"] == pytest.approx(20e-6)
