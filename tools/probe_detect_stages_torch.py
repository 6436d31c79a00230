"""Stage-by-stage fate of each expected tag in the port's detector (port of
``tools/probe_detect_stages.py``).

Runs the detector's stages one by one on ``tools/probe_robustness_torch.py``'s
frames at ``quad_decimate=1`` (``detect/threshold.py``, the CCL through
``ops/ccl.connected_components``, which launches the kernel on the card,
``detect/quads.py`` and ``detect/decode.py``) and names, for every expected
tag, the last stage it reached:

* ``threshold``: the map inside the tag's oracle quad holds black and white;
* ``ccl``: a black component of at least ``min_cluster_pts`` pixels lies in it;
* ``cluster``: a quad candidate of at least ``min_cluster_pts`` boundary
  points has its centre within a quarter of the tag's side of the oracle's;
* ``quad``: such a candidate is valid and its corners lie within
  ``QUAD_TOL_PX`` of the oracle's (in any cyclic order);
* ``decode``: the frame's detections hold the tag's id.

A tag that fails a stage is reported at the one before (``none`` if it
fails the threshold). Then, as the JAX tool does, it dumps the quad
candidates, decoded ids and trinary statistics around the clean frame 1's
tag index 1 (behind tag 0 from that pose, so never expected) and the
tags the JAX tool's noise run at sigma 0.05 lost, and last prints one
``{"detect_stages": {...}}`` line with every tag's fate for the clean and
the sigma 0.05 frames.

    python3 tools/probe_detect_stages_torch.py                # on the card; exits 1 without one
    python3 tools/probe_detect_stages_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_robustness_torch import DETECTOR, RES, _np, scenarios  # noqa: E402

STAGES = ("none", "threshold", "ccl", "cluster", "quad", "decode")
QUAD_TOL_PX = 3.0


def stages(frames: torch.Tensor, family: str = "tagStandard41h12"):
    """(gray, trinary, labels, quads, detections) of ``frames``, stage by
    stage as the detector runs them (no edge refinement at decimation 1)."""
    from aprilslam_tpu_torch.detect import DetectorParams, FamilyTensors, decode_quads, quad_candidates
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, decimate, to_grayscale
    from aprilslam_tpu_torch.families import get_family
    from aprilslam_tpu_torch.ops import ccl

    p = DetectorParams(**DETECTOR)
    gray = to_grayscale(frames)
    dec = decimate(gray, p.quad_decimate)
    trinary, level = adaptive_threshold_with_levels(dec, tile=p.tile, min_contrast=p.min_contrast)
    labels = ccl.connected_components(trinary.contiguous())
    quads = quad_candidates(
        trinary, labels, dec, p.quad_decimate, level, max_clusters=p.max_clusters, max_quads=p.max_quads,
        pts_per_quad=p.pts_per_quad, min_cluster_pts=p.min_cluster_pts, min_side=p.min_side,
        refine_iters=p.refine_iters, max_fit_err=p.max_fit_err, max_boundary=p.max_boundary)
    det = decode_quads(gray, quads, FamilyTensors(get_family(family), device=frames.device),
                       max_hamming=p.max_hamming, min_level_contrast=p.min_level_contrast,
                       max_detections=p.max_detections)
    return gray, trinary, labels, quads, det


def _inside(uv: np.ndarray, H: int, W: int) -> np.ndarray:
    """(H, W) bool: pixel centres inside the convex quad ``uv`` (4, 2)."""
    y, x = np.mgrid[:H, :W].astype(np.float64)
    sign = []
    for k in range(4):
        (x0, y0), (x1, y1) = uv[k], uv[(k + 1) % 4]
        sign.append((x1 - x0) * (y - y0) - (y1 - y0) * (x - x0))
    sign = np.stack(sign)
    return np.all(sign >= 0, 0) | np.all(sign <= 0, 0)


def _corner_gap(q: np.ndarray, uv: np.ndarray) -> float:
    """Largest corner distance between two quads, in their best cyclic
    correspondence (either direction)."""
    return min(float(np.max(np.linalg.norm(np.roll(c, s, 0) - uv, axis=-1)))
               for c in (q, q[::-1]) for s in range(4))


def fate(out, b: int, uv: np.ndarray, tag_id: int) -> dict:
    """How far the tag with oracle corners ``uv`` (4, 2) and id ``tag_id``
    got in frame ``b`` of ``stages``' output ``out``."""
    _gray, trinary, labels, quads, det = out
    min_cluster_pts = DETECTOR["min_cluster_pts"]
    tr, lab = _np(trinary[b]), _np(labels[b])
    inside = _inside(uv, *tr.shape)
    side = float(np.mean(np.linalg.norm(uv - np.roll(uv, 1, 0), axis=-1)))
    black, white = inside & (tr == 0), inside & (tr == 1)
    comp = np.unique(lab[black], return_counts=True)[1] if black.any() else np.zeros(1, int)
    qc, qv, qs = _np(quads.corners[b]), _np(quads.valid[b]), _np(quads.cluster_size[b])
    d = np.linalg.norm(qc.mean(1) - uv.mean(0), axis=-1)
    near = (qs >= min_cluster_pts) & (d < side / 4)
    gaps = [_corner_gap(qc[q], uv) for q in np.flatnonzero(near & qv)]
    ids, dv = _np(det.ids[b]), _np(det.valid[b])
    passed = [
        bool(black.any() and white.any()),
        bool(comp.max() >= min_cluster_pts),
        bool(near.any()),
        bool(gaps and min(gaps) <= QUAD_TOL_PX),
        bool(tag_id in set(ids[dv].tolist())),
    ]
    reached = next((i for i, ok in enumerate(passed) if not ok), len(passed))
    return {"frame": b, "tag": tag_id, "last_stage": STAGES[reached],
            "white": float(white.sum() / max(inside.sum(), 1)), "black": float(black.sum() / max(inside.sum(), 1)),
            "largest_black_component": int(comp.max()), "quad_corner_gap": min(gaps) if gaps else None}


def fates(sc, out=None) -> list:
    """``fate`` of every expected tag of scenario ``sc`` (the scoring's
    expected set: unoccluded, in view, 10 px from the border)."""
    out = out or stages(sc.frames, sc.family)
    tag_ids = _np(sc.scene.tag_ids)
    res = []
    for b in range(sc.gt_uv.shape[0]):
        for t in range(sc.gt_uv.shape[1]):
            uv = sc.gt_uv[b, t]
            if sc.gt_valid[b, t] and uv.min() > 10 and uv.max() < RES - 10:
                res.append(fate(out, b, uv, int(tag_ids[t])))
    return res


def inspect(out, sc, b: int, t: int, tag_name: str) -> None:
    """The JAX tool's dump around tag index ``t`` of frame ``b``."""
    _gray, trinary, labels, quads, det = out
    uv = sc.gt_uv[b, t]
    cx, cy = uv[:, 0].mean(), uv[:, 1].mean()
    print(f"--- {tag_name}: frame {b}, GT centre ({cx:.1f},{cy:.1f}), corners\n{uv}")
    qc, qv, qe, qs = (_np(x[b]) for x in (quads.corners, quads.valid, quads.fit_err, quads.cluster_size))
    d = np.hypot(qc.mean(1)[:, 0] - cx, qc.mean(1)[:, 1] - cy)
    for q in np.argsort(d)[:6]:
        print(f"  quad {q}: d={d[q]:6.1f} valid={qv[q]} fit_err={qe[q]:.3f} csize={qs[q]:.0f} "
              f"corners={qc[q].round(1).tolist()}")
    ids, dv = _np(det.ids[b]), _np(det.valid[b])
    print(f"  decoded ids: {[int(i) for i, v in zip(ids, dv) if v]}")
    tr, r = _np(trinary[b]), 30
    y0, y1 = max(0, int(cy) - r), min(RES, int(cy) + r)
    x0, x1 = max(0, int(cx) - r), min(RES, int(cx) + r)
    patch, lab = tr[y0:y1, x0:x1], _np(labels[b])[y0:y1, x0:x1]
    print(f"  trinary patch: white={np.mean(patch == 1):.2f} black={np.mean(patch == 0):.2f} "
          f"unk={np.mean(patch == -1):.2f}")
    print(f"  distinct labels in patch: {len(np.unique(lab))}")
    print(f"  frame unknown frac={np.mean(tr == -1):.3f}, n_valid_quads={qv.sum()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    from aprilslam_tpu_torch.device import card_line

    runs = {sc.name: sc for sc in scenarios(args.device) if sc.name in ("clean", "noise0.05")}
    report = {}
    for name, sc in runs.items():
        out = stages(sc.frames, sc.family)
        print(f"======= {name.upper()} =======")
        if name == "clean":
            inspect(out, sc, 1, 1, "clean miss (frame1 tag idx1)")
        else:
            for b, t in [(0, 1), (0, 2), (1, 0)]:
                inspect(out, sc, b, t, f"noise miss f{b} t{t}")
        report[name] = fates(sc, out)
        for f in report[name]:
            print(f"  fate: frame {f['frame']} tag {f['tag']}: {f['last_stage']}")
    on_cuda = args.device == "cuda"
    print(json.dumps({"detect_stages": {
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu", "card": card_line() if on_cuda else None,
        "fates": report}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
