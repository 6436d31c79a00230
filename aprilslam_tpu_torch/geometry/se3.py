"""Batched SO(3)/SE(3) primitives (port of ``aprilslam_tpu/geometry/se3.py``).

Pure functions on tensors with leading batch axes, written without in-place
updates so that ``torch.func.jacfwd``/``vmap`` can differentiate them.

Conventions
-----------
* Rotations are 3x3 matrices or axis-angle 3-vectors (Rodrigues form).
* Euler angles follow the reference: ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``.
* SE(3) is a 4x4 homogeneous matrix; a (..., 6) tangent vector is
  ``[omega, v]`` (rotation first).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_sqrt(x: torch.Tensor, tiny: float = 1e-20) -> torch.Tensor:
    """sqrt with a NaN-free derivative at 0."""
    return torch.sqrt(torch.where(x < tiny, tiny, x))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = _safe_sqrt(theta2)
    use_taylor = theta2 < 1e-8
    safe_theta = torch.where(use_taylor, 1.0, theta)
    safe_theta2 = torch.where(use_taylor, 1.0, theta2)
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta2)
    W = hat(w)
    return _eye(3, w, W.shape) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Keeps the reference's derivative-safe formulation: every primitive with
    an unbounded derivative (arccos, norm) is evaluated on a bounded input,
    and the small-angle branch is written in terms of cos(theta) only, so no
    0 * inf forms inside the selected branch of a ``where``.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - 1e-8
    safe_cos = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sin(theta)
    near_pi = cos_theta < -1.0 + 5e-7
    t2 = 2.0 * (1.0 - cos_theta)
    scale = torch.where(
        small,
        0.5 + t2 / 12.0,
        theta / (2.0 * torch.where(torch.abs(sin_theta) < _EPS, 1.0, sin_theta)),
    )
    skew = vee(R - R.transpose(-1, -2))
    w_generic = skew * scale[..., None]
    s = torch.clamp(0.5 * _safe_sqrt(torch.sum(skew * skew, dim=-1)), 0.0, 1.0 - 1e-7)
    theta_pi = math.pi - torch.arcsin(s)
    S = R + R.transpose(-1, -2) + (1.0 - trace)[..., None, None] * _eye(3, R, R.shape)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    cols = torch.gather(S, -1, k[..., None, None].expand(S.shape[:-1] + (1,)))[..., 0]
    axis = cols / (_safe_sqrt(torch.sum(cols * cols, dim=-1))[..., None] + _EPS)
    proj = torch.sum(axis * skew, dim=-1)
    sgn = torch.where(proj < 0.0, -1.0, 1.0)
    w_pi = axis * (theta_pi * sgn)[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _rot_from_entries(r00, r01, r02, r10, r11, r12, r20, r21, r22) -> torch.Tensor:
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def euler_zyx_to_matrix(euler_deg: torch.Tensor) -> torch.Tensor:
    """Euler [roll(x), pitch(y), yaw(z)] degrees -> R = Rz @ Ry @ Rx."""
    r = torch.deg2rad(euler_deg)
    roll, pitch, yaw = r[..., 0], r[..., 1], r[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return _rot_from_entries(
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    )


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """R -> Euler [roll, pitch, yaw] radians (ZYX factorization)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(
        singular,
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
    )
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([roll, pitch, yaw], dim=-1)


def camera_euler_to_matrix(rot_deg: torch.Tensor) -> torch.Tensor:
    """Camera [pitch, yaw, roll] degrees -> R = Ry(yaw) @ Rx(pitch) @ Rz(roll)."""
    r = torch.deg2rad(rot_deg)
    pitch, yaw, roll = r[..., 0], r[..., 1], r[..., 2]
    cx, sx = torch.cos(pitch), torch.sin(pitch)
    cyw, syw = torch.cos(yaw), torch.sin(yaw)
    cz, sz = torch.cos(roll), torch.sin(roll)
    return _rot_from_entries(
        cyw * cz + syw * sx * sz, -cyw * sz + syw * sx * cz, syw * cx,
        cx * sz, cx * cz, -sx,
        -syw * cz + cyw * sx * sz, syw * sz + cyw * sx * cz, cyw * cx,
    )


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    # The [0, 0, 0, 1] row is built on the device from t: a host tensor
    # copied over would cost a host sync on every call.
    zero = torch.zeros_like(t[..., None, :])
    bottom = torch.cat([zero, torch.ones_like(zero[..., :1])], dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = rotation(T).transpose(-1, -2)
    return make_se3(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: (..., 6) [omega, v] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    theta = _safe_sqrt(theta2)
    use_taylor = theta2 < 1e-8
    safe_theta = torch.where(use_taylor, 1.0, theta)
    safe_theta2 = torch.where(use_taylor, 1.0, theta2)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta2)
    c = torch.where(
        use_taylor,
        1.0 / 6.0 - theta2 / 120.0,
        (safe_theta - torch.sin(safe_theta)) / (safe_theta2 * safe_theta),
    )
    W = hat(w)
    V = _eye(3, xi, W.shape) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return make_se3(R, torch.einsum("...ij,...j->...i", V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (..., 4, 4) -> (..., 6) [omega, v]."""
    w = so3_log(rotation(T))
    theta2 = torch.sum(w * w, dim=-1)
    theta = _safe_sqrt(theta2)
    W = hat(w)
    use_taylor = theta2 < 1e-8
    safe_theta2 = torch.where(use_taylor, 1.0, theta2)
    half_theta = 0.5 * theta
    sin_half = torch.sin(half_theta)
    cot_term = torch.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.where(torch.abs(sin_half) < _EPS, 1.0, sin_half)) / safe_theta2,
    )
    V_inv = _eye(3, T, W.shape) - 0.5 * W + cot_term[..., None, None] * (W @ W)
    return torch.cat([w, torch.einsum("...ij,...j->...i", V_inv, translation(T))], dim=-1)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with broadcasting over batch axes."""
    return A @ B


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction used by the optimizers: exp(xi) @ T."""
    return se3_exp(xi) @ T


def rotation_geodesic_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    Rrel = Ra.transpose(-1, -2) @ Rb
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def pose_error(T_est: torch.Tensor, T_gt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation L2 error, rotation Frobenius error)."""
    t_err = torch.linalg.norm(translation(T_est) - translation(T_gt), dim=-1)
    r_err = torch.linalg.norm(
        (rotation(T_est) - rotation(T_gt)).reshape(T_est.shape[:-2] + (9,)), dim=-1
    )
    return t_err, r_err


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix via SVD.

    Non-finite inputs are swapped for the identity before the SVD (which can
    fail to converge on them) and give NaN out, as the reference's SVD does.
    """
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    Ms = torch.where(finite[..., None, None], M, _eye(3, M, M.shape))
    U, _, Vh = torch.linalg.svd(Ms)
    det = torch.linalg.det(U @ Vh)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * d[..., None, :]) @ Vh
    return torch.where(finite[..., None, None], R, torch.full_like(R, float("nan")))
