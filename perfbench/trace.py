"""What the traced run reads: the profiler's device trace, the dispatched
tensor operations and the host synchronisations, around calls into the
program, taken after the measured window so that the window runs untraced.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import warnings
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench import reduce

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench_window"


class OpCount(TorchDispatchMode):
    """Counts the tensor operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn) -> int:
    with OpCount() as c:
        fn()
    return c.n


def count_syncs(fn) -> Counter:
    """Host synchronisations made while ``fn`` runs, by the program's source
    directory that made them (torch's sync debug mode warns at each)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return Counter(os.path.basename(os.path.dirname(w.filename)) for w in caught
                   if "synchroniz" in str(w.message))


def profile(fn) -> dict:
    """Run ``fn`` under the profiler, ending in a synchronize, and reduce
    the trace to device records (see :func:`reduce_trace`)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events)


def _label(name: str) -> str:
    return name[:64].replace(" ", "_")


def reduce_trace(events: list) -> dict:
    """Device time and launches by the detector's ``stage_*`` range they
    were launched under, busy time over the window, and the breakdown."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host_tid = win[0].get("tid")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    launch_ts = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    stages = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("stage_"))
    starts = [s[0] for s in stages]

    def stage_of(ts):
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and stages[i][0] <= ts <= stages[i][1]:
            return stages[i][2]
        return None

    stage_us = defaultdict(float)
    by_name = defaultdict(float)
    outside_us = 0.0
    kernels = 0
    ccl_us = 0.0
    intervals = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e["dur"])
        intervals.append((ts, ts + dur))
        if e["cat"] == "kernel":
            kernels += 1
        st = stage_of(launch_ts.get(e.get("args", {}).get("correlation"), -1.0))
        if st is not None:
            stage_us[st] += dur
            by_name["detect." + st[len("stage_"):]] += dur
            if st == "stage_ccl" and e["cat"] == "kernel" and "ccl_" in e["name"]:
                ccl_us += dur
        else:
            outside_us += dur
            by_name[_label(e["name"])] += dur
    busy_us = reduce.union_seconds(intervals, w0, w1)
    idle = reduce.gaps(intervals, w0, w1)
    host_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                      if e.get("cat") in ("cpu_op", "user_annotation") and e.get("tid") == host_tid
                      and e.get("name") != WINDOW and "dur" in e)
    gap_by = defaultdict(float)
    heap: list = []
    j = 0
    for g0, g1 in idle:  # the innermost host range open where each idle stretch starts
        while j < len(host_ops) and host_ops[j][0] <= g0:
            s, e_, name = host_ops[j]
            heapq.heappush(heap, (e_ - s, e_, name))
            j += 1
        while heap and heap[0][1] <= g0:
            heapq.heappop(heap)
        gap_by[_label(heap[0][2]) if heap else "python"] += g1 - g0
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": kernels,
        "stage_s": {k: v * 1e-6 for k, v in stage_us.items()},
        "outside_stage_s": outside_us * 1e-6,
        "ccl_s": ccl_us * 1e-6,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gap_by)},
    }
