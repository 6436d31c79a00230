"""The program's own spans, read by the benchmark.

The step names its stages (``slam.*``, the detector's ``stage_*``) with
``aprilslam_tpu_torch.utils.profiling.span``. This module reads them in
three ways:

* :func:`reduce_spans` reads them in the profiler's trace, where each span
  is a ``user_annotation`` range on the host thread on the clock of the
  kernels: device time by the innermost ``slam.*`` span open at each launch,
  and the window's idle time split at span boundaries;
* :func:`passes` runs two more sessions after the traced ones, one under the
  program's ``SpanRecorder`` (host time and calls per span) and one under
  its sync mode (host syncs per span);
* the ``metrics/`` readers listed in :data:`METRICS` turn both into
  per-layer numbers.

``harness.py`` and ``trace.py`` do not call this module yet: a traced run
would need ``trace.profile`` to merge :func:`reduce_spans`'s keys into its
result and ``harness.traced`` to merge :func:`passes`'s. Until then

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs ``perfbench/run.py --trace 1`` with exactly those two additions and
:data:`METRICS`' entries made in the process, and prints, on standard
error, the per-span table (``{"spans": ...}``) and the coverage,
consistency and cost readings (``{"span_checks": ...}``).
"""

from __future__ import annotations

import contextlib
import heapq
import json
import statistics
import sys
import time
from collections import defaultdict

import torch

from perfbench import reduce
from perfbench.trace import DEVICE_CATS, WINDOW

PREFIX = "slam."
EPS_US = 1e-3  # the trace's times are microseconds to the nanosecond
LAYER_SCAN = "scan: the per-frame loop (slam/pipeline.py per_frame, slam.scan)"
LAYER_LOOP = "loop closure: the pose-graph solves at the chunk boundary (slam/loop.py, taggraph.py, pgo.py)"
LAYER_BACK = "SLAM back end: slam/graph.py, ba.py, localize.py, loop.py, taggraph.py, pgo.py"
CELLS = ["loop_1k.closure"]
# The per-layer entries these readings feed, as BENCHMARK.json would list them.
METRICS = [
    {"name": "scan.host_ms_per_chunk", "unit": "ms/chunk", "better": "lower", "source": "program_span",
     "layer": LAYER_SCAN, "moves": "fps", "workloads": CELLS},
    {"name": "scan.host_syncs_per_chunk", "unit": "syncs/chunk", "better": "lower",
     "source": "program_counter", "layer": LAYER_SCAN, "moves": "fps", "workloads": CELLS},
    {"name": "ba.host_ms_per_chunk", "unit": "ms/chunk", "better": "lower", "source": "program_span",
     "layer": "chunk BA: slam/ba.py ba_optimize at the chunk boundary", "moves": "fps", "workloads": CELLS},
    {"name": "loop.host_ms_per_chunk", "unit": "ms/chunk", "better": "lower", "source": "program_span",
     "layer": LAYER_LOOP, "moves": "fps", "workloads": CELLS},
    {"name": "taggraph.solves_per_chunk", "unit": "solves/chunk", "better": "lower",
     "source": "program_counter", "layer": LAYER_LOOP, "moves": "fps", "workloads": CELLS},
    {"name": "backend.device_ms_per_chunk", "unit": "ms/chunk", "better": "lower", "source": "device_trace",
     "layer": LAYER_BACK, "moves": "fps", "workloads": CELLS},
    {"name": "scan.idle_pct", "unit": "%", "better": "lower", "source": "device_trace", "layer": LAYER_SCAN,
     "moves": "fps", "workloads": CELLS},
]


class _Innermost:
    """The innermost of nested ranges ``(start, end, name)`` open at each
    of a nondecreasing run of times (the shortest open one)."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.j = 0
        self.heap: list = []

    def at(self, t: float):
        while self.j < len(self.ranges) and self.ranges[self.j][0] <= t:
            s, e, name = self.ranges[self.j]
            heapq.heappush(self.heap, (e - s, e, name))
            self.j += 1
        while self.heap and self.heap[0][1] < t:
            heapq.heappop(self.heap)
        return self.heap[0][2] if self.heap else None


def reduce_spans(events: list) -> dict:
    """The profiler's trace by ``slam.*`` span: ``span_device_s`` (device
    time of each kernel, copy and memset by the innermost span open at its
    launch, ``None`` outside every span), ``span_idle_s`` (the window's idle
    stretches, split at span boundaries, each piece by the innermost span
    open over it) and ``span_parents`` (each span's enclosing span)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host_tid = win[0].get("tid")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("tid") == host_tid
                   and str(e.get("name", "")).startswith(PREFIX) and "dur" in e)
    parents: dict = {}
    stack: list = []
    for s, e, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] < e - EPS_US:
            stack.pop()
        parents.setdefault(name, stack[-1][2] if stack else None)
        stack.append((s, e, name))
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    launches = sorted((launch_ts.get(e.get("args", {}).get("correlation"), -1.0), float(e["dur"]))
                      for e in dev)
    device = defaultdict(float)
    inner = _Innermost(spans)
    for ts, dur in launches:
        device[inner.at(ts) if ts >= 0 else None] += dur * 1e-6
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    cuts = sorted({t for s, e, _ in spans for t in (s, e) if w0 < t < w1})
    idle = defaultdict(float)
    inner = _Innermost(spans)
    i = 0
    for g0, g1 in reduce.gaps(intervals, w0, w1):
        while i < len(cuts) and cuts[i] <= g0:
            i += 1
        a, j = g0, i
        while j < len(cuts) and cuts[j] < g1:
            idle[inner.at((a + cuts[j]) / 2)] += (cuts[j] - a) * 1e-6
            a, j = cuts[j], j + 1
        idle[inner.at((a + g1) / 2)] += (g1 - a) * 1e-6
    return {"span_device_s": dict(device), "span_idle_s": dict(idle), "span_parents": parents}


def subtree(parents: dict, root: str) -> set:
    """``root`` and every span under it, by the parent links."""
    out = {root}
    grew = True
    while grew:
        more = {n for n, p in parents.items() if p in out} - out
        out |= more
        grew = bool(more)
    return out


def _session_start(caller, k: int) -> int:
    return (k // caller.session + 1) * caller.session if caller.session else k


def passes(caller, trf: dict, k: int) -> dict:
    """Two sessions of ``count_calls`` calls each from a session boundary
    after call ``k``: under a ``SpanRecorder`` (``spans``: its summary,
    ``span_calls``: the calls) and under one in sync mode (``span_syncs``:
    host syncs per span, ``None`` outside every span). Nothing from a
    program without the recorder."""
    try:
        from aprilslam_tpu_torch.utils.profiling import SpanRecorder
    except ImportError:
        return {}
    c = trf["trace"]["count_calls"]
    k = _session_start(caller, k)
    with SpanRecorder() as rec:
        for j in range(c):
            caller.call(k + j)
    k = _session_start(caller, k + c)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with SpanRecorder(syncs=True) as srec:
        for j in range(c):
            caller.call(k + j)
    steps = [(r[4] - r[3]) * 1e-9 for r in rec.records if r[1] is None]
    return {"spans": rec.summary(), "span_calls": c, "span_steps_s": steps,
            "span_syncs": {n: v["syncs"] for n, v in srec.summary().items()}}


def table(rec: dict, per_call: int) -> dict:
    """Per span, per chunk: calls, host and self ms (host pass), syncs
    (sync pass), device and idle ms with it innermost (traced calls);
    ``per_call`` is the frames of a call."""
    sp, n, t = rec["spans"], rec["span_calls"], rec["trace"]
    traced = t["frames"] / per_call
    names = set(sp) | set(rec["span_syncs"]) | set(t["span_device_s"]) | set(t["span_idle_s"])
    out = {}
    for name in sorted(names, key=str):
        s = sp.get(name, {})
        out[str(name)] = {
            "calls": s.get("calls", 0) / n,
            "host_ms": s.get("host_s", 0.0) * 1e3 / n,
            "self_ms": s.get("self_s", 0.0) * 1e3 / n,
            "syncs": rec["span_syncs"].get(name, 0) / n,
            "device_ms": t["span_device_s"].get(name, 0.0) * 1e3 / traced,
            "idle_ms": t["span_idle_s"].get(name, 0.0) * 1e3 / traced,
        }
    return out


def span_cost_ns(n: int = 100_000) -> dict:
    """Host ns per ``with span(...)`` with neither switch on, under a
    recorder, and under a recorder in sync mode, over ``n`` empty spans."""
    from aprilslam_tpu_torch.utils.profiling import SpanRecorder, span

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("slam.cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    out = {"off": loop()}
    with SpanRecorder():
        out["recorder"] = loop()
    with SpanRecorder(syncs=True):
        out["sync_mode"] = loop()
    return out


def checks(rec: dict) -> dict:
    """Coverage and consistency of the span readings of one traced run, and
    the cost of a span in each mode as a share of the median chunk."""
    sp, t = rec["spans"], rec["trace"]
    host = lambda name: sp.get(name, {}).get("host_s", 0.0)  # noqa: E731
    back_children = [n for n, v in sp.items() if v["parent"] == "slam.back"]
    existing = sum(rec["syncs"].values())
    per_span = sum(rec["span_syncs"].values())
    idle = t["window_s"] - t["busy_s"]
    device = sum(t["stage_s"].values()) + t["outside_stage_s"]
    spans_per_chunk = sum(v["calls"] for k, v in sp.items() if k is not None) / rec["span_calls"]
    median_chunk_ns = statistics.median(rec["span_steps_s"]) * 1e9
    out = {
        "back_children_cover": sum(host(n) for n in back_children) / host("slam.back"),
        "front_back_cover": (host("slam.front") + host("slam.back")) / host("slam.step"),
        "syncs_per_span_total": per_span, "syncs_existing_total": existing,
        "span_idle_s_sum": sum(t["span_idle_s"].values()), "window_idle_s": idle,
        "span_device_s_sum": sum(t["span_device_s"].values()), "device_s_sum": device,
        "spans_per_chunk": spans_per_chunk, "median_chunk_ms": median_chunk_ns * 1e-6,
        "passes_s": rec["span_passes_s"],
    }
    for mode, ns in span_cost_ns().items():
        out[f"span_ns_{mode}"] = ns
        out[f"span_share_{mode}"] = ns * spans_per_chunk / median_chunk_ns
    return out


@contextlib.contextmanager
def hooked(log=print):
    """For as long as the context lasts: ``trace.profile``'s result with
    :func:`reduce_spans`'s keys, ``harness.traced``'s with :func:`passes`'s
    (and its seconds, ``span_passes_s``), :data:`METRICS` among a cell's
    per-layer metrics; each traced run logs the per-span table and
    :func:`checks`."""
    from perfbench import harness, trace

    reduce_trace, traced, cell_metrics = trace.reduce_trace, harness.traced, harness.cell_metrics

    def reduce_with_spans(events):
        return {**reduce_trace(events), **reduce_spans(events)}

    def traced_with_spans(caller, trf, next_k):
        out = traced(caller, trf, next_k)
        tr = trf["trace"]
        last = next_k + tr.get("profile_skip", 0) + tr["profile_calls"] + 2 * tr["count_calls"]
        t0 = time.perf_counter()
        out.update(passes(caller, trf, last + 3 * caller.session))
        out["span_passes_s"] = time.perf_counter() - t0
        if "spans" in out:
            log(json.dumps({"spans": table(out, caller.F)}))
            log(json.dumps({"span_checks": checks(out)}))
        return out

    def metrics_with_spans(cell, kind):
        mine = cell_metrics(cell, kind)
        return mine + [m for m in METRICS if kind == "per_layer" and cell in m["workloads"]]

    trace.reduce_trace, harness.traced, harness.cell_metrics = reduce_with_spans, traced_with_spans, \
        metrics_with_spans
    try:
        yield
    finally:
        trace.reduce_trace, harness.traced, harness.cell_metrics = reduce_trace, traced, cell_metrics


def main(argv=None) -> int:
    from perfbench import run

    argv = list(sys.argv[1:] if argv is None else argv)
    with hooked(log=lambda s: print(s, file=sys.stderr, flush=True)):
        return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
