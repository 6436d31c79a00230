"""Chunks for the chaining graph's scan, and the comparison of two scans.

Shared by the CPU tests (``test_torch_slam.py``), the card tests
(``test_torch_chain_graph_card.py``) and ``chip_smoke.py``. Imports neither
jax nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aprilslam_tpu_torch.slam.graph import GraphScan, GraphState

# (B, D, M): the closure cell's chunk (detector max_detections 16, graph
# capacity 16) and the step's defaults (32 detections, 64 slots).
SHAPES = [(8, 16, 16), (8, 32, 64)]


def _rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _pose(rng, scale: float) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rotation(rng)
    T[:3, 3] = rng.normal(scale=scale, size=3)
    return T


def chain_chunk(seed: int, B: int, D: int, M: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A chunk of B frames of D detection slots over an M-slot graph, as the
    front end gives it: (ids (B, D) int32 ascending, T (B, D, 4, 4) float32
    camera->tag, ok (B, D) bool).

    The tags lie in one scene (each T is a camera's view of a fixed tag pose,
    with a little noise), so the pose averages are near rotations. Each
    frame sees a window of ids that slides down over the chunk, so the
    anchor moves to lower ids mid-chunk, chained through a tag the graph
    knows or (where the frame holds none) through nothing. About one frame
    in seven is empty; slots are not ok at random, with garbage (NaN among
    it) in their T; ids below 0 and at or above M occur with ok set."""
    rng = np.random.default_rng(seed)
    tags = [_pose(rng, 20.0) for _ in range(M + 4)]
    ids = np.full((B, D), -1, np.int32)
    ok = np.zeros((B, D), bool)
    T = rng.normal(scale=50.0, size=(B, D, 4, 4)).astype(np.float32)
    T[rng.random((B, D)) < 0.2] = np.nan
    for b in range(B):
        if rng.random() < 0.15:
            continue
        hi = M - (M * b) // (B + 1)
        lo = max(0, hi - max(3, M // 2))
        pool = np.arange(lo - 2, hi + 3)
        k = int(rng.integers(1, min(D, len(pool)) + 1))
        chosen = np.sort(rng.choice(pool, size=k, replace=False))
        cam = _pose(rng, 10.0)
        cam[:3, 3] += (0.0, 0.0, -80.0)
        cam_inv = np.linalg.inv(cam)
        for d, tag in enumerate(chosen):
            ids[b, d] = tag
            ok[b, d] = rng.random() > 0.15
            if ok[b, d]:
                noise = _pose(rng, 0.05)
                noise[:3, :3] = np.eye(3) + 0.01 * (noise[:3, :3] - np.eye(3))
                T[b, d] = (cam_inv @ tags[tag % len(tags)] @ noise).astype(np.float32)
    return ids, T, ok


def to_device(chunk, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(x, device=device) for x in chunk)


def state_to(state: GraphState, device) -> GraphState:
    return GraphState(**{f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)})


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap over the tensor's largest magnitude (at least 1); inf
    where the two differ in which entries are not finite."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin].nan_to_num(), want[~fin].nan_to_num()):
        return float("inf")
    if not fin.any():
        return 0.0
    return float((got[fin] - want[fin]).abs().max() / max(1.0, float(want[fin].abs().max())))


def compare_scans(got: tuple[GraphState, GraphScan], want: tuple[GraphState, GraphScan]) -> float:
    """Two scans' final states and per-frame results: every integer and bool
    field equal, and the largest relative gap (:func:`rel_gap`) of the float
    fields returned. Raises AssertionError on a shape, dtype or integer
    mismatch."""
    worst = 0.0
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert a.shape == b.shape and a.dtype == b.dtype, (f.name, a.shape, a.dtype, b.shape, b.dtype)
            if b.dtype.is_floating_point:
                worst = max(worst, rel_gap(a, b))
            else:
                assert torch.equal(a.cpu(), b.cpu()), f.name
    return worst
