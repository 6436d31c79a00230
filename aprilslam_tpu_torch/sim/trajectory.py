"""Trajectory generators: scripted, Monte Carlo, orbit and smoothed random
walk (port of ``aprilslam_tpu/sim/trajectory.py``).

Trajectories are (N, 3) GL-world positions + (N, 3) rotations [pitch, yaw,
roll] in degrees, generated up front as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Reference Monte Carlo bounds (simulation_engine.py:92: [-3,10,-1,1,-0.25,3]*5)
REFERENCE_BOUNDS = np.array([[-15.0, 50.0], [-5.0, 5.0], [-1.25 * 5, 15.0]], dtype=np.float32)


@dataclass(frozen=True)
class Trajectory:
    positions: np.ndarray  # (N, 3) GL world
    rotations: np.ndarray  # (N, 3) [pitch, yaw, roll] degrees

    def __len__(self) -> int:
        return int(self.positions.shape[0])

    def slices(self, batch: int):
        n = (len(self) // batch) * batch
        for s in range(0, n, batch):
            yield self.positions[s : s + batch], self.rotations[s : s + batch]


def monte_carlo(n_frames: int, bounds: np.ndarray = REFERENCE_BOUNDS, seed: int = 0) -> Trajectory:
    """Uniform random positions in bounds, zero rotation.

    The draws come from ``np.random.default_rng(seed)``, so the positions
    differ from the JAX package's ``monte_carlo`` (which draws from
    ``jax.random``) for the same seed; the distribution is the same.
    """
    b = np.asarray(bounds, dtype=np.float32)
    u = np.random.default_rng(seed).random((n_frames, 3), dtype=np.float32)
    pos = b[:, 0] + u * (b[:, 1] - b[:, 0])
    return Trajectory(pos.astype(np.float32), np.zeros((n_frames, 3), dtype=np.float32))


REFERENCE_POOL = Path(__file__).resolve().parent / "data" / "monte_carlo_512_seed3.npy"


def reference_pool() -> Trajectory:
    """The JAX package's ``monte_carlo(512, seed=3)``: the 512 poses its
    headline bench renders, drawn there with ``jax.random`` and kept here as
    data (``sim/data/monte_carlo_512_seed3.npy``, held to the JAX function by
    the tests), so that the port's ATE can be taken on the same poses."""
    pos = np.load(REFERENCE_POOL)
    return Trajectory(pos, np.zeros_like(pos))


def scripted_line(
    n_frames: int,
    start: np.ndarray = np.array([0.0, 0.0, 10.0]),
    end: np.ndarray = np.array([30.0, 0.0, -20.0]),
) -> Trajectory:
    """Linear dolly between two waypoints, zero rotation."""
    t = np.linspace(0.0, 1.0, n_frames, dtype=np.float32)[:, None]
    pos = np.asarray(start, dtype=np.float32) * (1 - t) + np.asarray(end, dtype=np.float32) * t
    return Trajectory(pos, np.zeros((n_frames, 3), dtype=np.float32))


def scripted_waypoints(n_frames: int, waypoints: np.ndarray) -> Trajectory:
    """Piecewise-linear interpolation through waypoints (K, 3)."""
    waypoints = np.asarray(waypoints, dtype=np.float32)
    s = np.linspace(0.0, len(waypoints) - 1.0, n_frames)
    i0 = np.clip(np.floor(s).astype(int), 0, len(waypoints) - 2)
    f = (s - i0)[:, None].astype(np.float32)
    pos = waypoints[i0] * (1 - f) + waypoints[i0 + 1] * f
    return Trajectory(pos, np.zeros((n_frames, 3), dtype=np.float32))


def orbit(
    n_frames: int,
    center: np.ndarray = np.array([0.0, 0.0, -50.0]),
    radius: float = 40.0,
    yaw_tracking: bool = True,
    sweep_deg: float = 60.0,
) -> Trajectory:
    """Arc around a scene centre, optionally yawing to face it: exercises
    rotation handling and revisits."""
    ang = np.radians(np.linspace(-sweep_deg / 2, sweep_deg / 2, n_frames, dtype=np.float32))
    center = np.asarray(center, dtype=np.float32)
    pos = np.stack(
        [center[0] + radius * np.sin(ang), np.full_like(ang, center[1]), center[2] + radius * np.cos(ang)],
        axis=-1,
    )
    rot = np.zeros((n_frames, 3), dtype=np.float32)
    if yaw_tracking:
        rot[:, 1] = np.degrees(ang)  # yaw toward the centre
    return Trajectory(pos, rot)


def smooth_random_walk(
    n_frames: int,
    bounds: np.ndarray = REFERENCE_BOUNDS,
    smoothness: int = 30,
    seed: int = 0,
) -> Trajectory:
    """Low-pass-filtered random walk inside bounds: a handheld-like sweep
    with revisits. Numpy draws, so the same seed gives the JAX package's
    positions bit for bit."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(bounds[:, 0], bounds[:, 1], size=(n_frames + 2 * smoothness, 3)).astype(np.float32)
    kernel = np.hanning(2 * smoothness + 1)
    kernel /= kernel.sum()
    sm = np.stack([np.convolve(raw[:, i], kernel, mode="same") for i in range(3)], axis=-1)
    sm = sm[smoothness : smoothness + n_frames]
    return Trajectory(sm.astype(np.float32), np.zeros((n_frames, 3), dtype=np.float32))
