"""Op-level attribution of the SLAM step from a torch.profiler trace (port of
``tools/profile_step.py``).

Warms the step up, traces ``CALLS`` step calls with torch.profiler (CPU and
CUDA activity), and groups the device time of every CUDA kernel (and copy)
by pipeline stage:

* the detector's stages by the ``stage_threshold``, ``stage_ccl``,
  ``stage_quads``, ``stage_decode`` and ``stage_refine`` ranges of
  ``detect/detector.py`` that enclose the launch (the JAX detector's named
  scopes);
* the rest by the innermost Python frame, around the launching op, of a
  function in one of the back end's files: ``slam/ba.py`` -> ``ba(chunk)``,
  ``pose/pnp.py`` -> ``pnp``, ``slam/graph.py`` -> ``scan(per-frame)``,
  ``slam/localize.py`` -> ``localize``; anything else -> ``other``. Some
  functions of those files take a bucket by name instead (``NAME_BUCKET``):
  ``ba_add_frame``, which the step calls in its per-frame loop, goes to
  ``scan(per-frame)`` with everything it calls, as in the JAX tool; the
  index helpers ``_take`` and ``_scatter_drop`` open no range, so their ops
  go to their caller's. While tracing, a ``sys.setprofile`` hook opens a
  ``backend:<bucket>`` profiler range for each call of such a function:
  torch.profiler's own ``with_stack`` recorded no Python frame with torch
  2.11 (CUDA 12.8) on an H100 host.

The same device time is also split into the JAX tool's buckets
(``jax_buckets``): its ``classify`` (``tools/profile_step.py``) has no
``localize`` and puts every op of the step's ``lax.scan``
(``jit(slam_step)/while/``) that is neither PnP nor ``ba_optimize`` into
``scan(per-frame)``, and the rest of the step's own ops, the batched
localizations before and after the scan and the observability pass
included, into ``other``. The hook marks the port's counterpart of the
scan's body, ``per_frame`` of ``slam/pipeline.py``, with a
``jax:scan(per-frame)`` range. Both splits sum to the same total.

Prints the JAX tool's two tables (microseconds per frame per stage with
each stage's share, then the top 8 ops of the 2 largest stages), the JAX
buckets beside the port's, and one ``{"profile": {...}}`` line: the stages,
the JAX buckets, the total per frame, the launches per call, the busy share
of the traced window and the card.

    python3 tools/profile_step_torch.py               # on the card; exits 1 without one
    B=2 RES=256 python3 tools/profile_step_torch.py --device cpu

``--device cpu`` traces CPU activity only and attributes each op's own CPU
time instead. The JAX tool's knobs: ``B`` (frames per call, 8), ``RES``
(1000), ``SCHED`` (the BA schedule, ``chunk``), ``TRACE_DIR`` (where to
write the chrome trace; unset: not written).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CALLS = 3
STAGES = ("threshold", "ccl", "quads", "decode", "refine")
BACKEND = {"slam.ba": "ba(chunk)", "pose.pnp": "pnp", "slam.graph": "scan(per-frame)",
           "slam.localize": "localize"}
# Functions of BACKEND's files whose bucket is not their file's: a call of one
# of these, and every back-end call beneath it, goes to the bucket named;
# None opens no range, so the function's ops go to its caller's.
NAME_BUCKET = {"ba_add_frame": "scan(per-frame)", "_take": None, "_scatter_drop": None}
# The port's counterpart of the body of the JAX step's lax.scan.
JAX_SCAN = ("slam.pipeline", "per_frame")
JAX_BUCKETS = (*STAGES, "pnp", "ba(chunk)", "scan(per-frame)", "other")


class BackendRanges:
    """While entered, each call of a function defined in one of BACKEND's
    modules runs inside a profiler range ``backend:<bucket>`` (its file's
    bucket, or NAME_BUCKET's), and each call of JAX_SCAN inside a range
    ``jax:scan(per-frame)`` (a ``sys.setprofile`` hook on this thread)."""

    def __init__(self):
        import importlib

        def path(m):
            return importlib.import_module(f"aprilslam_tpu_torch.{m}").__file__

        self.files = {path(m): f"backend:{b}" for m, b in BACKEND.items()}
        self.scan = (path(JAX_SCAN[0]), JAX_SCAN[1])
        self.open = []  # (frame, range, sealed) of the calls that opened a range

    def _hook(self, frame, event, _arg):
        if event == "call":
            if self.open and self.open[-1][2]:
                return  # beneath a NAME_BUCKET call: its bucket holds
            code = frame.f_code
            name, sealed = self.files.get(code.co_filename), False
            if name is not None and code.co_name in NAME_BUCKET:
                bucket = NAME_BUCKET[code.co_name]
                name, sealed = (None, False) if bucket is None else (f"backend:{bucket}", True)
            elif name is None and (code.co_filename, code.co_name) == self.scan:
                name = "jax:scan(per-frame)"
            if name is not None:
                rf = record_function(name)
                rf.__enter__()
                self.open.append((frame, rf, sealed))
        elif event == "return" and self.open and self.open[-1][0] is frame:
            self.open.pop()[1].__exit__(None, None, None)

    def __enter__(self):
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)
        while self.open:
            self.open.pop()[1].__exit__(None, None, None)


def jax_bucket(stage: str | None, bucket: str | None, in_scan: bool) -> str:
    """The JAX tool's bucket for work the port puts in detector ``stage`` or
    back-end ``bucket`` (None: neither), ``in_scan`` when it ran inside the
    step's per-frame loop: its ``classify`` checks the stages, then
    ``ba_optimize`` and PnP, then the scan; all else is ``other``."""
    if stage:
        return stage
    if bucket in ("pnp", "ba(chunk)"):
        return bucket
    return "scan(per-frame)" if in_scan or bucket == "scan(per-frame)" else "other"


def _innermost(ranges: list, times: list) -> list:
    """For each time, the label of the innermost of the nested ``(start,
    end, label)`` ranges that holds it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, open_, i = [None] * len(times), [], 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while i < len(ranges) and ranges[i][0] <= t:
            while open_ and open_[-1][1] < ranges[i][0]:
                open_.pop()
            open_.append(ranges[i])
            i += 1
        while open_ and open_[-1][1] < t:
            open_.pop()
        out[j] = open_[-1][2] if open_ else None
    return out


def attribute(events, on_cuda: bool):
    """(µs per bucket, µs per bucket and op name, events counted, µs per JAX
    bucket) from the profiler's raw events
    (``prof.profiler.kineto_results.events()``).

    On CUDA each device event (kernel, copy, set) counts its duration and
    goes where its launch was made: the CUDA runtime call with its
    correlation id (which also places a launch outside any op, such as the
    CCL kernel's), in the ``stage_*`` range open then, else in the innermost
    ``backend:`` range. On the CPU each op counts its own time (its span
    less its child ops'), placed by the ranges open at its start. The JAX
    buckets split the same time by ``jax_bucket``."""
    from torch.autograd import DeviceType

    stages, backend, scan, device, launches, ops = [], [], [], [], {}, []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.correlation_id(), e.name()))
            continue
        name = e.name()
        if e.is_user_annotation():
            if name.startswith("stage_"):
                stages.append((e.start_ns(), e.end_ns(), name.removeprefix("stage_")))
            elif name.startswith("backend:"):
                backend.append((e.start_ns(), e.end_ns(), name.removeprefix("backend:")))
            elif name.startswith("jax:"):
                scan.append((e.start_ns(), e.end_ns(), True))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()  # a CUDA runtime call
        elif not on_cuda:
            ops.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))

    totals, examples = defaultdict(float), defaultdict(lambda: defaultdict(float))
    jax_totals = defaultdict(float)

    def add(us, name, stage, bucket, in_scan):
        b = stage or bucket or "other"
        totals[b] += us
        examples[b][name] += us
        jax_totals[jax_bucket(stage, bucket, bool(in_scan))] += us

    if on_cuda:
        t = [launches.get(corr, -1) for _s, _e, corr, _n in device]
        for (start, end, _c, name), *where in zip(device, _innermost(stages, t), _innermost(backend, t),
                                                  _innermost(scan, t)):
            add((end - start) / 1e3, name[:90], *where)
        return dict(totals), {b: dict(v) for b, v in examples.items()}, len(device), dict(jax_totals)

    ops.sort(key=lambda o: (o[0], -o[1]))
    own = [end - start for start, end, _t, _n in ops]
    open_: dict = {}  # thread -> indices of the open ops
    for i, (start, end, tid, _n) in enumerate(ops):
        st = open_.setdefault(tid, [])
        while st and ops[st[-1]][1] <= start:
            st.pop()
        if st:
            own[st[-1]] -= end - start
        st.append(i)
    times = [o[0] for o in ops]
    for (_s, _e, _t, name), ns, *where in zip(ops, own, _innermost(stages, times), _innermost(backend, times),
                                             _innermost(scan, times)):
        add(ns / 1e3, name, *where)
    return dict(totals), {b: dict(v) for b, v in examples.items()}, len(ops), dict(jax_totals)


def profile_step(device: str = "cuda", batch: int = 8, res: int = 1000, sched: str = "chunk",
                 trace_dir: str | None = None) -> dict:
    """Trace ``CALLS`` calls of the step of ``tools/profile_step.py`` (the
    default scene at ``res``x``res``, numpy ``monte_carlo(batch, seed=3)``,
    ``DetectorParams(quad_decimate=2, min_cluster_pts=12)``,
    ``estimator="ba"``, ``ba_schedule=sched``) and attribute its time.
    Returns the ``profile`` dict; ``top_ops`` holds the 8 largest ops of
    every bucket."""
    from torch.profiler import ProfilerActivity, profile

    from aprilslam_tpu_torch.detect import DetectorParams
    from aprilslam_tpu_torch.device import card_line, resolve_device
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory
    from aprilslam_tpu_torch.slam import build_slam_step

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_cuda else (lambda: None)
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    traj = trajectory.monte_carlo(batch, seed=3)
    frames = render_frames(scene_tensors(cfg, device=dev), traj.positions, traj.rotations, cam.inv_matrix,
                           res, res, 2, device=dev)
    step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner,
                                 detector_params=DetectorParams(quad_decimate=2, min_cluster_pts=12),
                                 estimator="ba", ba_schedule=sched, device=dev)
    t0 = time.perf_counter()
    state, _ = step(init(), frames)  # warm-up
    sync()
    print(f"warm-up step {time.perf_counter() - t0:.1f} s; tracing", file=sys.stderr)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with BackendRanges():
            for _ in range(CALLS):
                state, _ = step(state, frames)
        sync()
        window_s = time.perf_counter() - t0
        t0 = time.perf_counter()
    print(f"traced window {window_s:.1f} s; trace collected in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "profile_step_torch.json"))
    t0 = time.perf_counter()
    totals, examples, n_events, jax_totals = attribute(prof.profiler.kineto_results.events(), on_cuda)
    print(f"attributed {n_events} events in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for s in STAGES:
        totals.setdefault(s, 0.0)
    for b in JAX_BUCKETS:
        jax_totals.setdefault(b, 0.0)
    total = sum(totals.values())
    per_frame = CALLS * batch
    return {
        "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "card": card_line() if on_cuda else None,
        "time": "cuda kernels and copies, device time" if on_cuda else "cpu ops, own time",
        "batch": batch, "resolution": res, "schedule": sched, "calls": CALLS,
        "stages_us_per_frame": {b: us / per_frame for b, us in totals.items()},
        "stage_share": {b: us / total if total else 0.0 for b, us in totals.items()},
        "jax_buckets": {b: us / per_frame for b, us in jax_totals.items()},
        "total_us_per_frame": total / per_frame,
        "launches_per_call": n_events / CALLS if on_cuda else None,
        "window_s": window_s,
        "busy_share": total / 1e6 / window_s if on_cuda else None,
        "top_ops": {b: [[op, us / per_frame] for op, us in sorted(ex.items(), key=lambda kv: -kv[1])[:8]]
                    for b, ex in examples.items()},
    }


def print_tables(prof: dict) -> None:
    """The JAX tool's two tables."""
    stages = sorted(prof["stages_us_per_frame"].items(), key=lambda kv: -kv[1])
    print(f"\n== {'device' if prof['card'] else 'cpu'} time per stage (us, {prof['calls']} calls x "
          f"{prof['batch']} frames) ==")
    for stage, us in stages:
        print(f"{stage:16s} {us:9.1f} us/frame  ({prof['stage_share'][stage] * 100:5.1f}%)")
    print(f"{'TOTAL':16s} {prof['total_us_per_frame']:9.1f} us/frame")
    print("\n== the same time in the JAX tool's buckets (us/frame) ==")
    for b in JAX_BUCKETS:
        print(f"{b:16s} {prof['jax_buckets'][b]:9.1f}")
    print("\n== top ops in the 2 biggest stages ==")
    for stage, _ in stages[:2]:
        print(f"[{stage}]")
        for op, us in prof["top_ops"].get(stage, []):
            print(f"   {us:9.1f} us/frame  {op}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    prof = profile_step(args.device, int(os.environ.get("B", "8")), int(os.environ.get("RES", "1000")),
                        os.environ.get("SCHED", "chunk"), os.environ.get("TRACE_DIR") or None)
    print_tables(prof)
    top2 = sorted(prof["stages_us_per_frame"], key=lambda b: -prof["stages_us_per_frame"][b])[:2]
    print(json.dumps({"profile": {**prof, "top_ops": {b: prof["top_ops"].get(b, []) for b in top2}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
