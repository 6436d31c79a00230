"""Port parity: the sparse Schur coupling of the bundle adjustment
(``lm_obs_grid``, ``schur_sparse``, ``backsub_sparse``, ``ba_optimize(...,
coupling="sparse")``) against the dense one and against the JAX package, on
a BA state with K*M > 4096 (where ``coupling="auto"`` picks sparse)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import PinholeCamera, se3_exp
from aprilslam_tpu.slam import ba as JB
from aprilslam_tpu_torch import slam as TS
from aprilslam_tpu_torch.convert import _from_numpy
from aprilslam_tpu_torch.slam import ba as TBA

K_SLOTS, M, O, TAG = 32, 160, 256, 10.0


def random_poses(rng, n, rot=0.3, trans=5.0):
    xi = np.concatenate([rng.normal(scale=rot, size=(n, 3)),
                         rng.normal(scale=trans, size=(n, 3))], -1).astype(np.float32)
    with jax.enable_x64(False):
        return np.array(se3_exp(jnp.asarray(xi)))


@pytest.fixture(scope="module")
def problem():
    """A BA state built by the JAX package from noisy synthetic observations
    of 12 tags, in a window of 32 keyframe slots over 160 landmark slots."""
    rng = np.random.default_rng(4)
    K = PinholeCamera.from_fov(640, 480, 45.0).matrix
    lm_true = random_poses(rng, M, rot=0.2, trans=3.0)
    obj = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32)
    with jax.enable_x64(False):
        st = JB.ba_init(K_SLOTS, M, O)
        for f in range(20):
            T_wc = random_poses(rng, 1, rot=0.05, trans=1.0)[0]
            T_wc[:3, 3] += np.array([0.0, 0.0, -80.0], np.float32)
            ids = np.sort(rng.choice(12, 4, replace=False)).astype(np.int32)
            T_ct = np.linalg.inv(T_wc) @ lm_true[ids]
            p = np.einsum("dij,cj->dci", T_ct[:, :3, :3], obj) + T_ct[:, None, :3, 3]
            uv = ((p[..., :2] / p[..., 2:3]) * K[0, 0] + K[:2, 2] + rng.normal(scale=0.5, size=(4, 4, 2)))
            noisy_wc = (random_poses(rng, 1, rot=0.01, trans=0.1)[0] @ T_wc).astype(np.float32)
            noisy_ct = np.einsum("dij,djk->dik", random_poses(rng, 4, rot=0.01, trans=0.1), T_ct)
            st = JB.ba_add_frame(st, jnp.asarray(ids), jnp.asarray(uv.astype(np.float32)), jnp.ones(4, bool),
                                 jnp.asarray(noisy_wc), jnp.asarray(noisy_ct.astype(np.float32)))
    arrays = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}
    assert K_SLOTS * M > 4096 and arrays["obs_ok"].sum() == 80
    return st, arrays, K


def test_lm_obs_grid_matches_jax(problem):
    _, a, _ = problem
    for P in (K_SLOTS, 4):
        with jax.enable_x64(False):
            jg, jo = JB.lm_obs_grid(jnp.asarray(a["obs_lm"]), jnp.asarray(a["obs_ok"]), M, P)
        tg, to = TS.ba.lm_obs_grid(torch.as_tensor(a["obs_lm"]), torch.as_tensor(a["obs_ok"]), M, P)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert int(to) == int(jo)
    assert int(to) > 0  # P = 4 overflows: a tag is seen by more than 4 keyframes


def test_schur_sparse_equals_dense(problem):
    """The reduced camera system assembled both ways from the same blocks."""
    _, a, _ = problem
    rng = np.random.default_rng(1)
    Hll_inv = torch.as_tensor(rng.normal(size=(M, 6, 6)).astype(np.float32))
    Hll_inv = Hll_inv @ Hll_inv.transpose(-1, -2)
    ok = torch.as_tensor(a["obs_ok"])
    A = torch.as_tensor(rng.normal(size=(O, 6, 6)).astype(np.float32)) * ok[:, None, None]
    Hcc_d = torch.as_tensor(rng.normal(size=(K_SLOTS, 6, 6)).astype(np.float32))
    bc = torch.as_tensor(rng.normal(size=(K_SLOTS, 6)).astype(np.float32))
    bl = torch.as_tensor(rng.normal(size=(M, 6)).astype(np.float32))
    obs_kf, obs_lm = torch.as_tensor(a["obs_kf"]), torch.as_tensor(a["obs_lm"])
    grid, _ = TBA.lm_obs_grid(obs_lm, ok, M, K_SLOTS)
    S, rhs = TBA.schur_sparse(grid, A, obs_kf, obs_lm, Hll_inv, Hcc_d, bc, bl, K_SLOTS)
    Wkm = torch.zeros((K_SLOTS, M, 6, 6)).index_put_((obs_kf.long(), obs_lm.long()), A, accumulate=True)
    WH = torch.einsum("kmab,mbc->kmac", Wkm, Hll_inv)
    S_dense = -torch.einsum("kmac,lmdc->klad", WH, Wkm)
    S_dense[torch.arange(K_SLOTS), torch.arange(K_SLOTS)] += Hcc_d
    rhs_dense = bc - torch.einsum("kmab,mb->ka", WH, bl)
    scale = S_dense.abs().max()
    np.testing.assert_allclose(S.numpy() / scale, S_dense.numpy() / scale, atol=1e-5)
    np.testing.assert_allclose(rhs.numpy(), rhs_dense.numpy(), rtol=1e-4, atol=1e-3)
    with jax.enable_x64(False):
        jS, jrhs = JB.schur_sparse(jnp.asarray(grid.numpy()), jnp.asarray(A.numpy()), jnp.asarray(a["obs_kf"]),
                                   jnp.asarray(a["obs_lm"]), jnp.asarray(Hll_inv.numpy()),
                                   jnp.asarray(Hcc_d.numpy()), jnp.asarray(bc.numpy()), jnp.asarray(bl.numpy()),
                                   K_SLOTS)
    np.testing.assert_allclose(S.numpy() / scale, np.asarray(jS) / scale, atol=1e-5)
    np.testing.assert_allclose(rhs.numpy(), np.asarray(jrhs), rtol=1e-4, atol=1e-3)
    dc = torch.as_tensor(rng.normal(size=(K_SLOTS, 6)).astype(np.float32))
    with jax.enable_x64(False):
        jdl = np.asarray(JB.backsub_sparse(jnp.asarray(A.numpy()), jnp.asarray(a["obs_kf"]), jnp.asarray(a["obs_lm"]),
                                           jnp.asarray(Hll_inv.numpy()), jnp.asarray(bl.numpy()),
                                           jnp.asarray(dc.numpy()), M))
    np.testing.assert_allclose(TBA.backsub_sparse(A, obs_kf, obs_lm, Hll_inv, bl, dc, M).numpy(), jdl,
                               rtol=1e-4, atol=1e-3)


def test_ba_optimize_sparse_dense_and_jax(problem):
    jst, a, K = problem
    tst = _from_numpy(TS.BAState, a, torch.device("cpu"))
    tK = torch.as_tensor(K)
    dense = TS.ba_optimize(tst, tK, TAG, iters=3, coupling="dense")
    sparse = TS.ba_optimize(tst, tK, TAG, iters=3, coupling="sparse")
    auto = TS.ba_optimize(tst, tK, TAG, iters=3)
    with jax.enable_x64(False):
        jopt = jax.device_get(JB.ba_optimize(jst, jnp.asarray(K), TAG, iters=3, coupling="sparse"))
        jdense = jax.device_get(JB.ba_optimize(jst, jnp.asarray(K), TAG, iters=3, coupling="dense"))
    assert float(sparse.lam) == float(dense.lam) == pytest.approx(float(jopt.lam), rel=1e-6)
    assert torch.equal(auto.lm_pose, sparse.lm_pose)  # K*M > 4096 picks sparse
    # The world gauge is held only by damping (JAX's own sparse and dense
    # solves part by 5e-4 in it): compare every landmark and keyframe
    # relative to the anchor landmark.
    kact, lact, anc = a["kf_active"], a["lm_active"], int(a["anchor"])

    def rel(s, field, act):
        poses = np.asarray(getattr(s, field))
        return (np.linalg.inv(np.asarray(s.lm_pose)[anc]) @ poses)[act]

    for got, want in ((sparse, dense), (sparse, jopt), (dense, jdense)):
        np.testing.assert_allclose(rel(got, "lm_pose", lact), rel(want, "lm_pose", lact), atol=1e-4)
        np.testing.assert_allclose(rel(got, "kf_pose", kact), rel(want, "kf_pose", kact), atol=1e-4)
