"""Port parity: geometry (se3, camera) against the JAX package on random inputs.

The JAX side runs with x64 disabled so it computes in float32 as in
production. Tolerances are float32 round-off of the transcendental
functions and 3x3/4x4 products evaluated in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from aprilslam_tpu import geometry as G
from aprilslam_tpu_torch import geometry as TG

ATOL = 2e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _axis_angles(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:8] *= 1e-5  # Taylor branch
    w[8:16] *= 3.1 / np.linalg.norm(w[8:16], axis=-1, keepdims=True)  # near pi
    return w


def _both(fn_j, fn_t, *arrays):
    with jax.enable_x64(False):
        a = np.asarray(fn_j(*[jnp.asarray(x) for x in arrays]))
    b = fn_t(*[torch.as_tensor(np.array(x)) for x in arrays]).numpy()
    return a, b


@pytest.mark.parametrize("name", ["hat", "so3_exp", "se3_exp_rot", "euler_zyx_to_matrix",
                                  "camera_euler_to_matrix"])
def test_maps_from_vectors(name):
    rng = _rng(1)
    if name == "se3_exp_rot":
        x = np.concatenate([_axis_angles(rng), rng.normal(size=(64, 3)).astype(np.float32)], -1)
        a, b = _both(G.se3_exp, TG.se3_exp, x)
    elif name in ("euler_zyx_to_matrix", "camera_euler_to_matrix"):
        x = rng.uniform(-180, 180, size=(64, 3)).astype(np.float32)
        a, b = _both(getattr(G, name), getattr(TG, name), x)
    else:
        a, b = _both(getattr(G, name), getattr(TG, name), _axis_angles(rng))
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_so3_log_and_se3_log():
    rng = _rng(2)
    w = _axis_angles(rng)
    with jax.enable_x64(False):
        R = np.asarray(G.so3_exp(jnp.asarray(w)))
    a, b = _both(G.so3_log, TG.so3_log, R)
    # Near pi the angle is recovered from arcsin of a float32 skew norm.
    np.testing.assert_allclose(b, a, atol=2e-4)
    xi = np.concatenate([w[16:], rng.normal(size=(48, 3)).astype(np.float32)], -1)
    with jax.enable_x64(False):
        T = np.asarray(G.se3_exp(jnp.asarray(xi)))
    a, b = _both(G.se3_log, TG.se3_log, T)
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_se3_inverse_make_vee_project_to_so3():
    rng = _rng(3)
    xi = rng.normal(size=(32, 6)).astype(np.float32)
    with jax.enable_x64(False):
        T = np.asarray(G.se3_exp(jnp.asarray(xi)))
    a, b = _both(G.se3_inverse, TG.se3_inverse, T)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(G.make_se3, TG.make_se3, T[:, :3, :3], T[:, :3, 3])
    np.testing.assert_array_equal(b, a)
    W = rng.normal(size=(32, 3, 3)).astype(np.float32)
    a, b = _both(G.vee, TG.vee, W)
    np.testing.assert_array_equal(b, a)
    M = T[:, :3, :3] + 0.05 * W
    a, b = _both(G.project_to_so3, TG.project_to_so3, M)
    np.testing.assert_allclose(b, a, atol=1e-5)
    a, b = _both(G.matrix_to_euler_zyx, TG.matrix_to_euler_zyx, T[:, :3, :3])
    np.testing.assert_allclose(b, a, atol=1e-4)
    for k in (0, 1):
        a, b = _both(lambda x, y: G.pose_error(x, y)[k], lambda x, y: TG.pose_error(x, y)[k],
                     T, T[::-1].copy())
        np.testing.assert_allclose(b, a, rtol=1e-5)


def test_project_to_so3_non_finite_gives_nan():
    M = torch.full((2, 3, 3), float("nan"))
    M[0] = torch.eye(3)
    R = TG.project_to_so3(M)
    assert torch.allclose(R[0], torch.eye(3))
    assert torch.isnan(R[1]).all()


def test_se3_exp_jacobian_matches_jax():
    """The optimizers differentiate se3_exp at xi = 0 (Taylor branch) and at
    random tangents; reverse mode here vs forward mode there."""
    rng = _rng(4)
    T0 = rng.normal(size=(6,)).astype(np.float32)
    for xi in (np.zeros(6, np.float32), rng.normal(size=(6,)).astype(np.float32) * 0.5):
        with jax.enable_x64(False):
            Tj = G.se3_exp(jnp.asarray(T0))
            ja = np.asarray(jax.jacfwd(lambda x: (G.se3_exp(x) @ Tj).reshape(-1))(jnp.asarray(xi)))
        Tt = TG.se3_exp(torch.as_tensor(T0))
        jt = jacrev(lambda x: (TG.se3_exp(x) @ Tt).reshape(-1))(torch.as_tensor(xi)).numpy()
        np.testing.assert_allclose(jt, ja, atol=1e-4)


def test_camera():
    cam_j = G.PinholeCamera.from_fov(640, 480, 45.0)
    cam_t = TG.PinholeCamera.from_fov(640, 480, 45.0)
    assert cam_j.__dict__ == cam_t.__dict__
    np.testing.assert_array_equal(cam_t.matrix, cam_j.matrix)
    np.testing.assert_array_equal(cam_t.inv_matrix, cam_j.inv_matrix)
    rng = _rng(5)
    pts = rng.normal(size=(50, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    K = cam_j.matrix
    a, b = _both(lambda p, k: G.project(p, k), lambda p, k: TG.project(p, k), pts, K)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-4)
    px = rng.uniform(0, 640, size=(50, 2)).astype(np.float32)
    a, b = _both(G.unproject, TG.unproject, px, cam_j.inv_matrix)
    np.testing.assert_allclose(b, a, atol=1e-6)
    a, b = _both(G.gl_point_to_cv, TG.gl_point_to_cv, pts)
    np.testing.assert_array_equal(b, a)
    R = rng.normal(size=(4, 3, 3)).astype(np.float32)
    a, b = _both(G.gl_rotation_to_cv, TG.gl_rotation_to_cv, R)
    np.testing.assert_allclose(b, a, atol=1e-6)
    with jax.enable_x64(False):
        oa = np.asarray(G.tag_object_corners(10.0))
    np.testing.assert_array_equal(TG.tag_object_corners(10.0).numpy(), oa)
