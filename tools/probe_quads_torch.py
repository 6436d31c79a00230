"""Sub-stage times of the quads stage, the detector's largest, on the port
(port of ``tools/probe_quads_tpu.py``).

Renders ``monte_carlo(B, seed=3)`` of the default scene at RES x RES, runs
the detector's threshold and the CCL kernel (``detect.segment``: the
plain version on the CPU) once for the maps, then times, each on those
maps: the dispatch floor (``x + 1`` on (8, 128)), ``_emit_boundaries``,
``_compact``, ``_cluster``, the key sort that ``_cluster`` does alone, and
the whole ``quad_candidates``. Per call: the JAX tool's median ms after a
synchronize, and beside it the kernel time of the same call from
``torch.profiler`` (on the card; the step is host-bound, so the two
differ). Prints the JAX tool's lines, its "net" line (each reading minus
the floor) and one ``{"quads_probe": {...}}`` line.

    python3 tools/probe_quads_torch.py                    # on the card; raises without one
    B=2 RES=384 python3 tools/probe_quads_torch.py --device cpu

``maps``, ``wall_ms`` and ``kernel_ms`` are shared with
``tools/probe_quads_batch_torch.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aprilslam_tpu_torch.detect import DetectorParams  # noqa: E402
from aprilslam_tpu_torch.detect import quads as Q  # noqa: E402

PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12)  # probe_quads_tpu.py:36
REPS = 10


def maps(B: int, res: int, dev, params: DetectorParams = PARAMS) -> dict:
    """The quads stage's inputs for ``monte_carlo(B, seed=3)`` rendered (float,
    as the JAX tool feeds them) at ``res`` on ``dev``: the decimated gray
    image ``dec``, ``trinary`` and ``level`` from the detector's threshold,
    and ``labels`` from the CCL (the kernel on the card)."""
    from aprilslam_tpu_torch.detect.segment import connected_components
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory

    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    traj = trajectory.monte_carlo(B, seed=3)
    frames = render_frames(scene_tensors(cfg, device=dev), traj.positions, traj.rotations, cam.inv_matrix, res, res,
                           2, device=dev)
    dec = decimate(to_grayscale(frames), params.quad_decimate)
    trinary, level = adaptive_threshold_with_levels(dec, tile=params.tile, min_contrast=params.min_contrast)
    trinary = trinary.contiguous()
    return {"frames": frames, "dec": dec, "trinary": trinary, "level": level,
            "labels": connected_components(trinary)}


def quads_kwargs(p: DetectorParams) -> dict:
    """``quad_candidates``' keywords from the detector's parameters."""
    return dict(max_clusters=p.max_clusters, max_quads=p.max_quads, pts_per_quad=p.pts_per_quad,
                min_cluster_pts=p.min_cluster_pts, min_side=p.min_side, refine_iters=p.refine_iters,
                max_fit_err=p.max_fit_err, max_boundary=p.max_boundary)


def sort_keys(ka, kb):
    """The key sort of ``quads._cluster`` alone: its slot scramble, the
    (black, white) key pair as one int64 and the stable sort."""
    scramble = torch.argsort(Q._mix32(torch.arange(ka.shape[1], device=ka.device)), stable=True)
    key = (ka.to(torch.int64) * (2**31) + kb.to(torch.int64))[:, scramble]
    return torch.sort(key, dim=1, stable=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, args, dev, reps: int = REPS) -> float:
    """The JAX tool's reading: one warm call, then the median ms of ``reps``
    calls, each followed by a synchronize."""
    fn(*args)
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def kernel_ms(fn, args, dev, reps: int = REPS):
    """Kernel and copy time on the card per call (``torch.profiler``, ``reps``
    calls after a warm one); None off the card, where there is none."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        _sync(dev)
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / 1e3 / reps


def substages(m: dict, p: DetectorParams = PARAMS) -> dict:
    """name: (function, arguments) of each timed piece, on the maps ``m``,
    in the JAX tool's order."""
    t, lab, g, lv = m["trinary"], m["labels"], m["dec"], m["level"]
    ka, kb, x, y, w = Q._emit_boundaries(t, lab, g, lv)
    comp = Q._compact(ka, kb, x, y, w, p.max_boundary)
    kw = quads_kwargs(p)
    return {
        "dispatch floor (noop)": (lambda a: a + 1.0, (torch.ones((8, 128), device=t.device),)),
        "emit_boundaries": (Q._emit_boundaries, (t, lab, g, lv)),
        "compact": (lambda *a: Q._compact(*a, p.max_boundary), (ka, kb, x, y, w)),
        "cluster (sort+segstats)": (lambda *a: Q._cluster(*a, p.max_clusters, p.min_cluster_pts)[1]["count"], comp),
        "  sort alone": (lambda a, b: sort_keys(a, b)[0], comp[:2]),
        "quad_candidates (full)": (lambda *a: Q.quad_candidates(*a[:3], p.quad_decimate, a[3], **kw),
                                   (t, lab, g, lv)),
    }


def run(dev, B: int, res: int, reps: int = REPS) -> dict:
    """Every piece's wall and kernel ms per call on ``B`` frames at ``res``."""
    dev = torch.device(dev)
    m = maps(B, res, dev)
    rows = {}
    for name, (fn, args) in substages(m).items():
        ms = wall_ms(fn, args, dev, reps)
        rows[name] = {"ms": ms, "ms_per_frame": ms / B, "kernel_ms": kernel_ms(fn, args, dev, reps)}
    return {"batch": B, "res": res, "reps": reps, "rows": rows}


def print_rows(r: dict) -> None:
    """The JAX tool's lines, the kernel ms beside each, then its net line."""
    B, rows = r["batch"], r["rows"]
    for name, row in rows.items():
        k = row["kernel_ms"]
        print(f"{name:28s} {row['ms']:8.2f} ms/call  {row['ms'] / B:6.2f} ms/frame  kernel "
              + ("not measured" if k is None else f"{k:.3f} ms/call"))
    net = {k: v["ms"] - rows["dispatch floor (noop)"]["ms"] for k, v in rows.items()}
    print(f"\nnet (minus dispatch {rows['dispatch floor (noop)']['ms']:.1f} ms): emit {net['emit_boundaries']:.1f}, "
          f"compact {net['compact']:.1f}, cluster {net['cluster (sort+segstats)']:.1f} "
          f"(sort {net['  sort alone']:.1f}), full {net['quad_candidates (full)']:.1f} ms/call", flush=True)


def main(argv=None) -> int:
    from aprilslam_tpu_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    on_cuda = dev.type == "cuda"
    print("device:", torch.cuda.get_device_name(dev) if on_cuda else "cpu", flush=True)
    r = run(dev, int(os.environ.get("B", "8")), int(os.environ.get("RES", "1000")))
    print_rows(r)
    print(json.dumps({"quads_probe": {**r, "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
                                      "card": card_line() if on_cuda else None}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
