"""Plain rigid-body and pinhole geometry in torch, in any float dtype.

The simulator's conventions: the world and the camera are OpenGL frames (x
right, y up, the camera looking down -z); detection and PnP work in the CV
camera frame (x right, y down, looking down +z), ``diag(1, -1, -1)`` from
the GL one. A tag's rotation is Euler [rx, ry, rz] degrees applied as
Rz @ Ry @ Rx; a camera's is [pitch, yaw, roll] applied as Ry @ Rx @ Rz. A
tag's corners are listed left-bottom, right-bottom, right-top, left-top in
its own plane (z = 0), which is the order the detector reports them in.
"""

from __future__ import annotations

import torch

FLIP = (1.0, -1.0, -1.0)


def _rx(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1), torch.stack([z, s, c], -1)], -2)


def _ry(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)], -2)


def _rz(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)], -2)


def tag_rotation(rot_deg: torch.Tensor) -> torch.Tensor:
    """(..., 3) tag Euler degrees -> (..., 3, 3) GL-world rotation Rz @ Ry @ Rx."""
    r = torch.deg2rad(rot_deg)
    return _rz(r[..., 2]) @ _ry(r[..., 1]) @ _rx(r[..., 0])


def camera_rotation(rot_deg: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera [pitch, yaw, roll] degrees -> GL-world rotation Ry @ Rx @ Rz."""
    r = torch.deg2rad(rot_deg)
    return _ry(r[..., 1]) @ _rx(r[..., 0]) @ _rz(r[..., 2])


def camera_to_tag(tag_pos, tag_rot_deg, cam_pos, cam_rot_deg) -> torch.Tensor:
    """T_cam_tag (B, T, 4, 4): each tag's pose in each camera's CV frame."""
    dt = tag_pos.dtype
    flip = torch.diag(torch.tensor(FLIP, dtype=dt, device=tag_pos.device))
    R_tag = tag_rotation(tag_rot_deg)  # (T, 3, 3)
    R_cam = camera_rotation(cam_rot_deg)  # (B, 3, 3)
    Rc_t = flip @ R_cam.transpose(-1, -2)  # (B, 3, 3) GL world -> CV camera
    R = Rc_t[:, None] @ R_tag[None]  # (B, T, 3, 3)
    t = torch.einsum("bij,btj->bti", Rc_t, tag_pos[None] - cam_pos[:, None])
    return make_se3(R, t)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def tag_corners(size: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """(4, 3) corners of a tag of side ``size`` in its plane, lb-rb-rt-lt."""
    h = size / 2.0
    return torch.tensor([[-h, -h, 0.0], [h, -h, 0.0], [h, h, 0.0], [-h, h, 0.0]], dtype=dtype, device=device)


def project(T_cam_obj: torch.Tensor, pts: torch.Tensor, K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Points (..., P, 3) of an object at pose T (..., 4, 4) -> (pixels (..., P, 2), depth (..., P))."""
    X = torch.einsum("...ij,...pj->...pi", T_cam_obj[..., :3, :3], pts) + T_cam_obj[..., None, :3, 3]
    z = X[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * X[..., 0] / zs + K[0, 2]
    v = K[1, 1] * X[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], -1), z


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3)."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th < 1e-4
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def left_update(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """exp of a 6-vector (rotation, translation) applied on the left of T:
    the rotation turns T about the frame's origin, the translation shifts it."""
    R = so3_exp(xi[..., :3])
    return make_se3(R @ T[..., :3, :3], (R @ T[..., :3, 3:4])[..., 0] + xi[..., 3:])


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., n, n) symmetric positive definite systems by Gaussian
    elimination written out in elementwise operations, so that it runs in
    any dtype, bfloat16 included."""
    n = A.shape[-1]
    A = A.clone()
    b = b.clone()
    for k in range(n):
        piv = A[..., k, k]
        piv = torch.where(piv.abs() < 1e-30, torch.full_like(piv, 1e-30), piv)
        for i in range(k + 1, n):
            f = A[..., i, k] / piv
            A[..., i, :] = A[..., i, :] - f[..., None] * A[..., k, :]
            b[..., i] = b[..., i] - f * b[..., k]
    x = torch.zeros_like(b)
    for k in range(n - 1, -1, -1):
        s = b[..., k] - (A[..., k, k + 1:] * x[..., k + 1:]).sum(-1)
        piv = A[..., k, k]
        x[..., k] = s / torch.where(piv.abs() < 1e-30, torch.full_like(piv, 1e-30), piv)
    return x
