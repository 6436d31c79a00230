"""The benchmark's inputs from a seed: scenes, camera poses, intrinsics.

Frozen copies of the simulator's generators (the default scene, its
randomization, ``monte_carlo``, ``scripted_waypoints`` and the two-lap loop's
waypoints), so that a change to the program's ``sim/`` cannot move the
yardstick. Numpy only; the same seed gives the same scene and poses.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FAMILY_FILE = HERE / "tagStandard41h12.json"

# The reference's Monte Carlo bounds ([-3, 10, -1, 1, -0.25, 3] * 5).
MONTE_CARLO_BOUNDS = np.array([[-15.0, 50.0], [-5.0, 5.0], [-1.25 * 5, 15.0]], dtype=np.float32)
# BASELINE config 2's two-lap loop (bench.py:400-405).
LOOP_WAYPOINTS = np.array([
    [0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [60.0, 2.0, 12.0],
    [0.0, 0.0, 10.0], [2.0, 1.0, 11.0], [60.0, 0.0, 10.0],
    [60.0, 2.0, 12.0], [0.0, 0.0, 10.0],
])


@dataclass(frozen=True)
class Scene:
    """A tag scene as the simulator's JSON states it."""

    raw: dict

    @property
    def family(self) -> str:
        return str(self.raw.get("family", "tagStandard41h12"))

    @property
    def tag_size_inner(self) -> float:
        """The detected border square's side (the PnP tag size)."""
        return float(self.raw["tag_size_inner"]) * float(self.raw["size_scale"])

    @property
    def tag_size_outer(self) -> float:
        """The rendered quad's side."""
        return float(self.raw["tag_size_outer"]) * float(self.raw["size_scale"])

    @property
    def near_clip(self) -> float:
        return float(self.raw["near_clip"])

    @property
    def far_clip(self) -> float:
        return float(self.raw["far_clip"])

    @property
    def background(self) -> float:
        return 52.9 / 255.0  # the gray of the reference's purple clear colour

    def tag_ids(self) -> np.ndarray:
        return np.array([t["id"] for t in self.raw["tags"]], dtype=np.int64)

    def tag_positions(self) -> np.ndarray:
        return np.array([t["position"] for t in self.raw["tags"]], dtype=np.float32)

    def tag_rotations(self) -> np.ndarray:
        return np.array([t["rotation"] for t in self.raw["tags"]], dtype=np.float32)


def randomize_scene(raw: dict, percentage: float, seed: int) -> dict:
    """Perturb every tag position and rotation entry by up to +-percentage
    (relative; absolute for zero entries), in the simulator's draw order."""
    rng = np.random.default_rng(seed)
    out = json.loads(json.dumps(raw))

    def rand_val(v: float) -> float:
        if v == 0:
            return float(rng.uniform(-percentage, percentage))
        return float(v * (1.0 + rng.uniform(-percentage, percentage)))

    for tag in out["tags"]:
        tag["position"] = [rand_val(v) for v in tag["position"]]
        tag["rotation"] = [rand_val(v) for v in tag["rotation"]]
    return out


def intrinsics(width: int, height: int, fov_y_deg: float) -> np.ndarray:
    """The renderer's pinhole K: f from the vertical FOV, centre at the middle."""
    f = 0.5 * height / float(np.tan(np.radians(0.5 * fov_y_deg)))
    return np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]])


def monte_carlo(n_frames: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions (N, 3), rotations (N, 3) zero): uniform in the reference's bounds."""
    b = MONTE_CARLO_BOUNDS
    u = np.random.default_rng(seed).random((n_frames, 3), dtype=np.float32)
    pos = b[:, 0] + u * (b[:, 1] - b[:, 0])
    return pos.astype(np.float32), np.zeros((n_frames, 3), dtype=np.float32)


def scripted_waypoints(n_frames: int, waypoints: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Piecewise-linear interpolation through (K, 3) waypoints, zero rotation."""
    waypoints = np.asarray(waypoints, dtype=np.float32)
    s = np.linspace(0.0, len(waypoints) - 1.0, n_frames)
    i0 = np.clip(np.floor(s).astype(int), 0, len(waypoints) - 2)
    f = (s - i0)[:, None].astype(np.float32)
    pos = waypoints[i0] * (1 - f) + waypoints[i0 + 1] * f
    return pos, np.zeros((n_frames, 3), dtype=np.float32)


def family_grids(ids: np.ndarray) -> np.ndarray:
    """(T, C, C) cell grids (1 white, 0 black) of the family's codes ``ids``."""
    fam = json.loads(FAMILY_FILE.read_text())
    return np.asarray(fam["grids"], dtype=np.float32)[ids]
