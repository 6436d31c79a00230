"""Pose-graph optimization: relative SE(3) factors over poses
(port of ``aprilslam_tpu/slam/pgo.py``).

Residual per edge (i, j): r = log(T_meas^-1 T_wi^-1 T_wj) in the se(3)
tangent, rotation rows weighted. Levenberg-Marquardt with the first active
pose (or an explicit one) gauge-fixed by a stiff prior, dense over the
(small) pose set, a fixed iteration count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import jacfwd

from ..device import resolve_device
from ..geometry import se3_exp, se3_inverse, se3_log


@dataclass(frozen=True)
class PoseGraphEdges:
    i: torch.Tensor  # (E,) int32 source pose index
    j: torch.Tensor  # (E,) int32 target pose index
    T_meas: torch.Tensor  # (E, 4, 4) measured relative transform T_i^-1 T_j
    weight: torch.Tensor  # (E,)
    ok: torch.Tensor  # (E,) bool

    @property
    def capacity(self) -> int:
        return int(self.i.shape[0])


def edges_init(capacity: int, dtype=torch.float32, device=None) -> PoseGraphEdges:
    """``capacity`` empty edge slots on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    return PoseGraphEdges(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        T_meas=torch.eye(4, dtype=dtype, device=device).expand(capacity, 4, 4).clone(),
        weight=torch.ones((capacity,), dtype=dtype, device=device),
        ok=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _set(dst: torch.Tensor, slot, val) -> torch.Tensor:
    out = dst.clone()
    out[slot] = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    return out


def add_edge(edges: PoseGraphEdges, slot, i, j, T_meas, weight=1.0) -> PoseGraphEdges:
    """Write one edge at ``slot`` (host-side helper for building graphs)."""
    return PoseGraphEdges(
        i=_set(edges.i, slot, i),
        j=_set(edges.j, slot, j),
        T_meas=_set(edges.T_meas, slot, T_meas),
        weight=_set(edges.weight, slot, weight),
        ok=_set(edges.ok, slot, True),
    )


def edges_from_trajectory(poses: torch.Tensor) -> PoseGraphEdges:
    """Odometry edges between consecutive poses (N-1 edges)."""
    N = poses.shape[0]
    dev = poses.device
    return PoseGraphEdges(
        i=torch.arange(N - 1, dtype=torch.int32, device=dev),
        j=torch.arange(1, N, dtype=torch.int32, device=dev),
        T_meas=se3_inverse(poses[:-1]) @ poses[1:],
        weight=torch.ones((N - 1,), dtype=poses.dtype, device=dev),
        ok=torch.ones((N - 1,), dtype=torch.bool, device=dev),
    )


def pgo_residuals(poses: torch.Tensor, edges: PoseGraphEdges, rot_weight: float = 25.0) -> torch.Tensor:
    """(E, 6) weighted tangent residuals.

    ``rot_weight`` scales the rotational components: the raw tangent mixes
    radians with scene units, and unweighted the optimizer would twist nodes
    to satisfy translation constraints, swinging every landmark anchored to
    them by lever arm x angle."""
    rel = se3_inverse(poses[edges.i.long()]) @ poses[edges.j.long()]
    r = se3_log(se3_inverse(edges.T_meas) @ rel)
    scale = torch.cat([torch.full((3,), rot_weight, dtype=poses.dtype, device=poses.device),
                       torch.ones((3,), dtype=poses.dtype, device=poses.device)])
    return r * scale * (edges.weight * edges.ok.to(poses.dtype))[:, None]


def pgo_cost(poses: torch.Tensor, edges: PoseGraphEdges, rot_weight: float = 25.0) -> torch.Tensor:
    r = pgo_residuals(poses, edges, rot_weight)
    return torch.sum(r * r)


def pgo_optimize(
    poses: torch.Tensor,  # (N, 4, 4)
    edges: PoseGraphEdges,
    active: torch.Tensor | None = None,  # (N,) bool; the first active pose is the gauge
    iters: int = 10,
    damping: float = 1e-4,
    gauge_weight: float = 1e6,
    rot_weight: float = 25.0,
    gauge_index: torch.Tensor | None = None,  # explicit gauge pose (else the first active)
) -> torch.Tensor:
    """LM over all poses with left tangent perturbations; returns refined poses.

    The Jacobian is the dense (6E, 6N) forward-mode Jacobian of the flat
    residual, as the JAX package builds it."""
    N = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    if active is None:
        active = torch.ones((N,), dtype=torch.bool, device=dev)
    first_active = torch.argmax(active.to(torch.int32)) if gauge_index is None else gauge_index

    def residual_flat(xi_all, base):
        return pgo_residuals(se3_exp(xi_all.reshape(N, 6)) @ base, edges, rot_weight).reshape(-1)

    jac = jacfwd(residual_flat)
    eye = torch.eye(N * 6, dtype=dtype, device=dev)
    gauge_mask = (torch.arange(N, device=dev) == first_active).to(dtype)
    prior_diag = torch.repeat_interleave(gauge_weight * gauge_mask + 1e4 * (1.0 - active.to(dtype)), 6)
    z = torch.zeros((N * 6,), dtype=dtype, device=dev)
    lam = torch.full((), damping, dtype=dtype, device=dev)
    for _ in range(iters):
        r = residual_flat(z, poses)
        J = jac(z, poses)  # (E*6, N*6)
        A = J.T @ J + (lam + 1e-9) * eye + torch.diag(prior_diag)
        dx = -torch.linalg.solve_ex(A, (J.T @ r)[:, None]).result[:, 0]
        new_poses = se3_exp(dx.reshape(N, 6)) @ poses
        new_poses = torch.where(active[:, None, None], new_poses, poses)
        better = pgo_cost(new_poses, edges, rot_weight) < torch.sum(r * r)
        poses = torch.where(better, new_poses, poses)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-9, 1e4)
    return poses
