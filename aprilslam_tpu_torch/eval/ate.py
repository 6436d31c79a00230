"""Absolute trajectory error against the analytic ground truth.

The metric the JAX package's headline bench reports: each frame's pose is
compared with the ground truth in ITS OWN coordinate frame (the anchor is
the lowest tag id seen so far and can change mid-run).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sim.config import SceneConfig
from ..sim.ground_truth import camera_in_tag_frames


def ate_eval(cfg: SceneConfig, pos, rot, all_outs, obs_min: float = 0.25):
    """Returns (ate_rmse, valid_rate, n_invalid, confidence_split).

    ``all_outs`` is a list of SlamOutputs (one per chunk) covering the
    frames of ``pos``/``rot`` in order. ``confidence_split`` is None or a
    dict with the ATE over frames whose pose observability is at least
    ``obs_min``, their share of the valid frames, and the threshold."""
    ids = cfg.tag_ids()
    gt_all = camera_in_tag_frames(
        torch.as_tensor(cfg.tag_positions()), torch.as_tensor(cfg.tag_rotations()),
        torch.as_tensor(np.asarray(pos), dtype=torch.float32),
        torch.as_tensor(np.asarray(rot), dtype=torch.float32),
    ).numpy()  # (N, T, 4, 4)

    def cat(name):
        return np.concatenate([getattr(o, name).detach().cpu().numpy() for o in all_outs])

    est, valid, coord = cat("poses"), cat("valid"), cat("coord_id")
    id_to_idx = {int(t): i for i, t in enumerate(ids)}
    t_idx = np.array([id_to_idx.get(int(c), -1) for c in coord])
    valid = valid & (t_idx >= 0)
    gt = gt_all[np.arange(len(est)), np.clip(t_idx, 0, len(ids) - 1)]
    err_all = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    errs = err_all[valid]
    ate = float(np.sqrt(np.mean(errs**2))) if len(errs) else float("nan")
    obs = cat("pose_obs")
    m = valid & (obs >= obs_min)
    conf = None
    if m.sum():
        conf = {
            "ate_confident": round(float(np.sqrt(np.mean(err_all[m] ** 2))), 4),
            "confident_frac": round(float(m.sum() / max(valid.sum(), 1)), 4),
            "obs_min": obs_min,
        }
    return ate, float(valid.mean()), int((~valid).sum()), conf
