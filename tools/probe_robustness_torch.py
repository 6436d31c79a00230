"""Detector robustness sweep of the port (port of ``tools/probe_robustness.py``).

Renders the default scene from three poses at 512x512 and the tilted
two-tag scenes, degrades the frames the way a real sensor would
(``sim/degrade.py``: noise, blur, exposure gradient, gamma with vignette,
the combined "cheap webcam" stack) and detects at ``quad_decimate=1``.
For each scenario it prints found/expected, the corner RMS against the
analytic ``project_border_corners`` oracle, the false ids and the missed
tags, whether the floors of ``tests/test_detect_robustness.py`` hold
(``floor_ok``; the CLEAN control has none), and last one
``{"robustness": {...}}`` line with every row. A floor set wrong can so be
told apart from a regression of the detector.

    python3 tools/probe_robustness_torch.py                # on the card; exits 1 without one
    python3 tools/probe_robustness_torch.py --device cpu

Everything runs on ``--device``: rendering, degradation (the noise draws
come from a ``torch.Generator`` on that device, seeded 7 for the noise
sweep and 11 for the combined stack, the JAX tool's ``PRNGKey`` values;
the draws differ from ``jax.random``'s and between devices) and detection.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RES = 512
# The three camera poses of the default scene (GL world, zero rotation).
POSES = [[0.0, 0.0, 10.0], [10.0, 2.0, 0.0], [25.0, 5.0, -10.0]]
TILTS = (30.0, 45.0, 60.0)
DETECTOR = dict(quad_decimate=1, min_cluster_pts=12)
# tests/test_detect_robustness.py's floors by scenario: the least detection
# rate, the largest corner RMS (px), the least expected and found tags. Every
# scenario also must report no false id.
FLOORS = {
    "noise0.02": dict(min_rate=1.0, max_rms=0.6, min_expected=5),
    "noise0.05": dict(min_rate=1.0, max_rms=0.8, min_expected=5),
    "noise0.10": dict(min_rate=1.0, max_rms=1.0, min_expected=5),
    "blur0.8": dict(min_rate=1.0, max_rms=0.6),
    "blur1.5": dict(min_rate=0.9, max_rms=1.2),
    "gradient0.3": dict(min_rate=0.9, max_rms=1.0),
    "gradient0.6": dict(min_rate=0.9, max_rms=1.0),
    "gamma0.6_vig0.3": dict(min_rate=0.9, max_rms=1.0),
    "gamma1.8_vig0.4": dict(min_rate=0.9, max_rms=1.0),
    "combined": dict(min_rate=0.9, max_rms=1.2),
    "tilt30": dict(min_rate=1.0, max_rms=0.8, min_expected=2),
    "tilt45": dict(min_rate=1.0, max_rms=0.8, min_expected=2),
    "tilt60": dict(min_found=1),
}


class Scenario(NamedTuple):
    """One degraded batch: ``frames`` (B, RES, RES) float32 on the device, the
    scene it shows, and the oracle's corners (B, T, 4, 2) and validity
    (B, T) as numpy."""

    name: str
    frames: torch.Tensor
    scene: object
    gt_uv: np.ndarray
    gt_valid: np.ndarray
    family: str


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def score(det_out, scene, gt_uv, gt_valid, margin: int = 10, res: int = RES):
    """(found, expected, corner_rms, false_ids, missing) over all frames: the
    scoring of ``tests/test_detect_robustness.py`` (``_score``) and of the
    JAX tool. ``det_out`` and ``scene`` may be the port's or the JAX
    package's; ``missing`` lists the (frame, tag id) of every expected tag
    not found."""
    ids, valid, corners = _np(det_out.ids), _np(det_out.valid), _np(det_out.corners)
    tag_ids = _np(scene.tag_ids)
    gt_uv, gt_valid = _np(gt_uv), _np(gt_valid)
    scene_id_set = set(tag_ids.tolist())
    found = expected = false_ids = 0
    errs, missing = [], []
    for b in range(ids.shape[0]):
        got = {int(ids[b, d]): d for d in range(ids.shape[1]) if valid[b, d]}
        false_ids += sum(1 for g in got if g not in scene_id_set)
        for t in range(gt_uv.shape[1]):
            uv = gt_uv[b, t]
            if not (gt_valid[b, t] and uv.min() > margin and uv.max() < res - margin):
                continue
            expected += 1
            tid = int(tag_ids[t])
            if tid in got:
                found += 1
                errs.append(np.sqrt(np.mean(np.sum((corners[b, got[tid]] - uv) ** 2, -1))))
            else:
                missing.append((b, tid))
    rms = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
    return found, expected, rms, false_ids, missing


def floor_ok(name: str, found: int, expected: int, rms: float, false_ids: int) -> bool | None:
    """Whether the scenario meets its floor in FLOORS (None: it has none)."""
    f = FLOORS.get(name)
    if f is None:
        return None
    return bool(false_ids == 0
                and expected >= f.get("min_expected", 1)
                and found >= f.get("min_found", 0)
                and found / expected >= f.get("min_rate", 0.0)
                and rms <= f.get("max_rms", float("inf")))


def id_sets(det_out) -> list:
    """The valid ids of each frame, as sets."""
    ids, valid = _np(det_out.ids), _np(det_out.valid)
    return [set(ids[b][valid[b]].tolist()) for b in range(ids.shape[0])]


def corners_by_id(det_out) -> list:
    """The corners (4, 2) of each frame's valid detections, by id."""
    ids, valid, corners = _np(det_out.ids), _np(det_out.valid), _np(det_out.corners)
    return [{int(ids[b, d]): corners[b, d] for d in np.flatnonzero(valid[b])} for b in range(ids.shape[0])]


def tilt_config(tilt: float):
    """tests/test_detect_robustness.py's oblique scene: tag 0 yawed and tag 1
    pitched by ``tilt`` degrees, 50 units in front of the camera."""
    from aprilslam_tpu_torch.sim import SceneConfig, TagConfig

    tags = (
        TagConfig(id=0, position=np.array([0.0, 0.0, -50.0]), rotation=np.array([0.0, tilt, 0.0])),
        TagConfig(id=1, position=np.array([20.0, 0.0, -50.0]), rotation=np.array([tilt, 0.0, 0.0])),
    )
    return SceneConfig(display_width=RES, display_height=RES, fov_y=45.0, near_clip=0.1, far_clip=300.0,
                       size_scale=2.0, tag_size_inner_raw=5.0, tag_size_outer_raw=9.0, actual_size_in_mm=55.6,
                       tags=tags, family="tagStandard41h12")


def scenarios(device: str = "cuda", seed: int = 7):
    """The 11 scenarios of the default scene (the CLEAN control, noise at
    sigma 0.02, 0.05 and 0.10, blur at 0.8 and 1.5, gradients of 0.3 and
    0.6, gamma with vignette at (0.6, 0.3) and (1.8, 0.4), the combined
    stack), then the 3 tilts, rendered and degraded on ``device``, one at
    a time. The noise draws are seeded ``seed`` (the sweep) and ``seed`` + 4
    (the combined stack)."""
    from aprilslam_tpu_torch.device import resolve_device
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.sim import (SceneConfig, degrade, project_border_corners, render_frames,
                                         scene_tensors, tags_unoccluded)

    dev = resolve_device(device)

    def noise(x, sigma, s):
        return degrade.gaussian_noise(x, sigma, torch.Generator(dev).manual_seed(s))

    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    scene = scene_tensors(cfg, device=dev)
    pos = torch.tensor(POSES, dtype=torch.float32, device=dev)
    rot = torch.zeros_like(pos)
    frames = render_frames(scene, pos, rot, cam.inv_matrix, RES, RES, 2, device=dev)
    gt_uv, gt_valid = project_border_corners(scene, pos, rot, cam.matrix)
    # The oracle has no occlusion model, the z-buffered renderer does: tags
    # hidden behind another are not expected.
    unocc = tags_unoccluded(scene.tag_pos, scene.tag_rot, pos, scene.inner_size, scene.outer_half)
    gt = (_np(gt_uv), _np(gt_valid & unocc))

    def make(name, x):
        return Scenario(name, x, scene, *gt, cfg.family)

    yield make("clean", frames)
    for sigma in (0.02, 0.05, 0.10):
        yield make(f"noise{sigma:.2f}", noise(frames, sigma, seed))
    for sigma in (0.8, 1.5):
        yield make(f"blur{sigma:.1f}", degrade.gaussian_blur(frames, sigma))
    for s in (0.3, 0.6):
        yield make(f"gradient{s:.1f}", degrade.brightness_gradient(frames, s))
    for gamma, vig in [(0.6, 0.3), (1.8, 0.4)]:
        yield make(f"gamma{gamma:.1f}_vig{vig:.1f}", degrade.vignette(degrade.gamma_correct(frames, gamma), vig))
    x = degrade.gaussian_blur(frames, 0.7)
    x = degrade.brightness_gradient(x, 0.25)
    x = degrade.vignette(x, 0.25)
    x = degrade.gamma_correct(x, 1.4)
    yield make("combined", noise(x, 0.03, seed + 4))

    for tilt in TILTS:
        ocfg = tilt_config(tilt)
        ocam = PinholeCamera.from_fov(RES, RES, ocfg.fov_y)
        oscene = scene_tensors(ocfg, device=dev)
        opos = torch.tensor([[5.0, 0.0, 10.0]], device=dev)
        orot = torch.zeros_like(opos)
        ofr = render_frames(oscene, opos, orot, ocam.inv_matrix, RES, RES, 2, device=dev)
        oguv, ogv = project_border_corners(oscene, opos, orot, ocam.matrix)
        yield Scenario(f"tilt{tilt:.0f}", ofr, oscene, _np(oguv), _np(ogv), ocfg.family)


def sweep(device: str = "cuda", seed: int = 7):
    """Detect every scenario on ``device``: yields (scenario, detections,
    row), the row being the tool's JSON record of it."""
    from aprilslam_tpu_torch.detect import DetectorParams, TagDetector

    detectors = {}
    for sc in scenarios(device, seed):
        if sc.family not in detectors:
            detectors[sc.family] = TagDetector(sc.family, DetectorParams(**DETECTOR), device=sc.frames.device)
        det = detectors[sc.family].detect(sc.frames)
        found, expected, rms, false_ids, missing = score(det, sc.scene, sc.gt_uv, sc.gt_valid)
        row = {"name": sc.name, "found": found, "expected": expected, "rms": rms, "false_ids": false_ids,
               "missing": missing, "floor_ok": floor_ok(sc.name, found, expected, rms, false_ids)}
        yield sc, det, row


def run(device: str = "cuda", seed: int = 7) -> list:
    """Every scenario's row (``sweep``)."""
    return [row for _sc, _det, row in sweep(device, seed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    from aprilslam_tpu_torch.device import card_line

    rows = []
    for _sc, _det, row in sweep(args.device):
        rows.append(row)
        print(f"{row['name']:16s} found={row['found']}/{row['expected']} rms={row['rms']:.3f} "
              f"false={row['false_ids']} missing={row['missing']} floor_ok={row['floor_ok']}", flush=True)
    on_cuda = args.device == "cuda"
    print(json.dumps({"robustness": {
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu", "card": card_line() if on_cuda else None,
        "res": RES, "rows": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
