"""Keyframe-axis sharded bundle adjustment for one long trajectory
(port of ``aprilslam_tpu/parallel/keyframe_ba.py``).

One trajectory of up to tens of thousands of keyframes is split into
contiguous windows over the mesh's ``kf`` axis. In tag SLAM keyframes far
outnumber landmarks, so here the keyframes are the system solved for and the
landmarks the eliminated side:

* Every reprojection factor touches one keyframe and one landmark, every
  odometry factor two consecutive keyframes, so H_cc is block-tridiagonal
  (6x6 blocks) with one off-diagonal band E_k from the odometry chain.
* The reduced system S = H_cc - W H_ll^-1 W^T is applied matrix-free: a
  local banded product (the two seam terms fetched from the ring
  neighbours), plus the landmark coupling — a local segment sum into an
  (M, 6) vector, one ``psum`` (landmarks are replicated: M is small), a
  batched 6x6 apply of H_ll^-1, and a local scatter back.
* PCG with the exact block-Jacobi preconditioner (each keyframe observes a
  landmark at most once, so diag(W H_ll^-1 W^T) is a per-observation sum)
  runs a fixed number of steps; its dot products are ``psum``'d scalars.
* The landmark back-substitution is one more ``psum``; every shard computes
  the same landmark update.

Every reprojection observation lives with its keyframe's owner. The
odometry factor (k, k+1) is owned by k's shard; across a seam the receiving
shard re-linearizes it for its first diagonal block, so every diagonal block
assembles locally. Levenberg-Marquardt with Huber-IRLS reprojection weights,
rotation-weighted odometry residuals, Marquardt damping, accept or reject on
the robust cost (a ``torch.where``, no host read inside the loop), and the
gauge fixed by a strong prior on keyframe 0 whose update is then zeroed.

The per-shard body is written once against tensors with a leading shard
dimension (``collectives``): S shards on one card, or one per rank.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..device import resolve_device
from ..geometry import PinholeCamera, se3_exp, se3_inverse, se3_log, tag_object_corners
from ..slam.ba import _damp_blocks, _huber_sqrt_weights, _jacobians, _residuals
from .collectives import gather, segment_sum
from .mesh import Mesh, replicated, shard_leading

# Fields split over the kf axis; the landmark fields are replicated.
KF_SHARDED = ("kf_pose", "kf_active", "obs_kf", "obs_lm", "obs_uv", "obs_ok",
              "odom_T", "odom_ok", "odom_weight")


@dataclass(frozen=True)
class KeyframeBAProblem:
    """One long-trajectory BA problem.

    Observations must be grouped by keyframe owner into equal contiguous
    blocks (``partition_obs_by_keyframe``) before the sharded solve.
    """

    kf_pose: torch.Tensor  # (K, 4, 4) camera->world
    kf_active: torch.Tensor  # (K,) bool
    lm_pose: torch.Tensor  # (M, 4, 4) tag->world (replicated over the mesh)
    lm_active: torch.Tensor  # (M,) bool
    obs_kf: torch.Tensor  # (O,) int32 global keyframe index
    obs_lm: torch.Tensor  # (O,) int32 landmark slot
    obs_uv: torch.Tensor  # (O, 4, 2) pixel corners
    obs_ok: torch.Tensor  # (O,) bool
    odom_T: torch.Tensor  # (K, 4, 4) measured T_k^-1 T_{k+1}; row K-1 unused
    odom_ok: torch.Tensor  # (K,) bool (forced False at K-1)
    odom_weight: torch.Tensor  # (K,) sqrt-information scale of each odom factor

    @property
    def n_keyframes(self) -> int:
        return int(self.kf_pose.shape[0])

    @property
    def n_landmarks(self) -> int:
        return int(self.lm_pose.shape[0])


def partition_obs_by_keyframe(
    obs_kf: np.ndarray,
    obs_lm: np.ndarray,
    obs_uv: np.ndarray,
    obs_ok: np.ndarray,
    n_keyframes: int,
    n_shards: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket observations by keyframe owner into equal contiguous blocks.

    Shard d owns keyframes [d*K/n, (d+1)*K/n). The output arrays have
    length per*n where per = max bucket size rounded up to a multiple of 8 —
    nothing is ever dropped (cf. shard_observations_by_owner fit=True).

    ``n_keyframes`` must divide evenly into ``n_shards`` blocks: with a
    ragged split the trailing keyframes' owner index would land past the
    last shard and their observations would be dropped silently.
    """
    if n_keyframes % n_shards != 0:
        raise ValueError(
            f"n_keyframes={n_keyframes} must be divisible by "
            f"n_shards={n_shards} (a ragged split would drop the trailing "
            f"keyframes' observations)"
        )
    kl = n_keyframes // n_shards
    ok = np.asarray(obs_ok, bool)
    owner = np.asarray(obs_kf) // max(kl, 1)
    counts = np.bincount(owner[ok], minlength=n_shards)
    per = max(8, int(-8 * (-(counts.max() if counts.size else 1) // 8)))
    O = per * n_shards
    new_kf = np.zeros(O, np.int32)
    new_lm = np.zeros(O, np.int32)
    new_uv = np.zeros((O, 4, 2), np.asarray(obs_uv).dtype)
    new_ok = np.zeros(O, bool)
    for s in range(n_shards):
        idx = np.nonzero(ok & (owner == s))[0]
        dst = slice(s * per, s * per + len(idx))
        new_kf[dst] = np.asarray(obs_kf)[idx]
        new_lm[dst] = np.asarray(obs_lm)[idx]
        new_uv[dst] = np.asarray(obs_uv)[idx]
        new_ok[dst] = True
        # padding rows keep obs_kf inside the owner's range so the local
        # index stays in [0, kl) even for dead slots
        new_kf[s * per + len(idx) : (s + 1) * per] = s * kl
    return new_kf, new_lm, new_uv, new_ok


def _exp_np(xi: np.ndarray) -> np.ndarray:
    """The float32 SE(3) exponential of a host 6-vector."""
    return se3_exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()


def synthesize_trajectory_problem(
    n_keyframes: int,
    n_landmarks: int,
    n_shards: int,
    obs_per_kf: int = 4,
    corner_px_noise: float = 0.3,
    odom_rot_noise: float = 0.002,
    odom_trans_noise: float = 0.05,
    lm_init_noise: float = 0.5,
    tag_size: float = 10.0,
    image_wh: int = 1000,
    fov_y: float = 45.0,
    seed: int = 0,
    device=None,
):
    """Long-trajectory fixture: a camera sweep over a tag grid with noisy
    odometry integrated into the initial keyframe guesses (so the initial
    trajectory drifts like a dead-reckoned front end) and noisy landmark
    seeds. Returns (problem on ``device``, gt_kf_pose numpy, Kmat).

    The camera flies a serpentine sweep at constant height looking straight
    down, observing its ``obs_per_kf`` nearest tags per keyframe. The draws
    are the JAX function's, from ``np.random.default_rng(seed)`` in its
    order; the noise is composed with the port's float32 ``se3_exp``, so the
    poses can differ from JAX's in the last bits.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K, M = n_keyframes, n_landmarks
    cam = PinholeCamera.from_fov(image_wh, image_wh, fov_y)
    Kmat = cam.matrix
    obj = tag_object_corners(tag_size).numpy()

    side = int(np.ceil(np.sqrt(M)))
    extent = side * 30.0
    lm_gt = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    for m in range(M):
        lm_gt[m][:3, 3] = [(m % side) * 30.0, (m // side) * 30.0, 0.0]

    # Serpentine ground-truth sweep at constant height, looking down.
    kf_gt = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    n_rows = max(2, side)
    for k in range(K):
        f = k / max(K - 1, 1)
        row = f * (n_rows - 1)
        r_i = int(row)
        along = row - r_i
        x = (along if r_i % 2 == 0 else 1.0 - along) * extent
        y = f * extent
        kf_gt[k][:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        kf_gt[k][:3, 3] = [x, y, 130.0]

    # Observations: nearest tags, projected with pixel noise.
    obs_kf = np.zeros(K * obs_per_kf, np.int32)
    obs_lm = np.zeros(K * obs_per_kf, np.int32)
    obs_uv = np.zeros((K * obs_per_kf, 4, 2), np.float32)
    i = 0
    for k in range(K):
        d = np.linalg.norm(lm_gt[:, :3, 3] - kf_gt[k][:3, 3], axis=-1)
        for m in np.argsort(d)[:obs_per_kf]:
            T_ct = np.linalg.inv(kf_gt[k]) @ lm_gt[m]
            p = obj @ T_ct[:3, :3].T + T_ct[:3, 3]
            uv = p[:, :2] / p[:, 2:3]
            obs_uv[i] = np.stack(
                [Kmat[0, 0] * uv[:, 0] + Kmat[0, 2], Kmat[1, 1] * uv[:, 1] + Kmat[1, 2]],
                -1,
            ) + rng.normal(scale=corner_px_noise, size=(4, 2))
            obs_kf[i] = k
            obs_lm[i] = m
            i += 1
    obs_ok = np.ones(K * obs_per_kf, bool)

    # Noisy odometry; the initial guess integrates it (dead-reckoning drift).
    odom_T = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    kf_init = kf_gt.copy()
    for k in range(K - 1):
        rel = np.linalg.inv(kf_gt[k]) @ kf_gt[k + 1]
        xi = np.concatenate([
            rng.normal(scale=odom_rot_noise, size=3),
            rng.normal(scale=odom_trans_noise, size=3),
        ])
        odom_T[k] = (_exp_np(xi) @ rel).astype(np.float32)
        kf_init[k + 1] = kf_init[k] @ odom_T[k]

    lm_init = np.stack([
        _exp_np(np.concatenate([
            rng.normal(scale=0.01, size=3),
            rng.normal(scale=lm_init_noise, size=3),
        ])) @ lm_gt[m]
        for m in range(M)
    ]).astype(np.float32)

    p_kf, p_lm, p_uv, p_ok = partition_obs_by_keyframe(
        obs_kf, obs_lm, obs_uv, obs_ok, K, n_shards
    )
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    prob = KeyframeBAProblem(
        kf_pose=t(kf_init),
        kf_active=t(np.ones((K,), bool)),
        lm_pose=t(lm_init),
        lm_active=t(np.ones((M,), bool)),
        obs_kf=t(p_kf),
        obs_lm=t(p_lm),
        obs_uv=t(p_uv),
        obs_ok=t(p_ok),
        odom_T=t(odom_T),
        odom_ok=t(np.arange(K) < K - 1),
        # Statistically consistent relative weighting: reprojection enters
        # the cost at weight 1 per pixel (sigma = corner_px_noise), so the
        # odometry sqrt-information in those units is sigma_px / sigma_odom.
        odom_weight=t(np.full(
            (K,), max(corner_px_noise, 0.1) / max(odom_trans_noise, 1e-6), np.float32)),
    )
    return prob, kf_gt, t(Kmat)


def _odom_residual(xi_i, xi_j, T_wi, T_wj, T_meas, scale):
    """Weighted 6-vector odometry residual with tangent perturbations."""
    Ti = se3_exp(xi_i) @ T_wi
    Tj = se3_exp(xi_j) @ T_wj
    return se3_log(se3_inverse(T_meas) @ (se3_inverse(Ti) @ Tj)) * scale


_ODOM_IN_DIMS = (0, 0, 0, 0, 0, None)
_odom_residuals = vmap(_odom_residual, in_dims=_ODOM_IN_DIMS)
_odom_jacobians = vmap(jacrev(_odom_residual, argnums=(0, 1)), in_dims=_ODOM_IN_DIMS)


def _huber_rho(r: torch.Tensor, huber_px: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= huber_px, r * r, huber_px * (2.0 * a - huber_px))


def _damp_rows(H: torch.Tensor, lam: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``_damp_blocks`` on (R, n, 6, 6) blocks with one lambda per row."""
    R, n = H.shape[:2]
    lam_b = lam[:, None].expand(R, n).reshape(-1, 1, 1)
    return _damp_blocks(H.reshape(-1, 6, 6), lam_b, prior.reshape(-1)).reshape(H.shape)


def _mv(Mx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("rkab,rkb->rka", Mx, v)


def build_keyframe_ba(
    mesh: Mesh,
    n_keyframes: int,
    n_landmarks: int,
    n_obs: int,
    tag_size: float,
    axis: str = "kf",
    iters: int = 8,
    cg_iters: int = 32,
    damping: float = 1e-2,
    huber_px: float = 4.0,
    odom_rot_weight: float = 25.0,
    gauge_weight: float = 1e6,
):
    """Returns ``run(problem, Kmat) -> (problem', cost)`` solving LM-BA with
    keyframes, observations and odometry sharded over ``axis``; ``cost`` is
    the final robust cost as a float, the run's one host read.

    ``n_obs`` is the total (already partitioned) observation count; both K
    and n_obs must divide by the mesh's ``axis`` size. On a process-group
    mesh the problem's keyframe-sharded fields hold this rank's rows
    (``multihost.make_global``) and the landmarks are whole.
    """
    n_dev = mesh.shape[axis]
    K, M = n_keyframes, n_landmarks
    if K % n_dev or n_obs % n_dev:
        raise ValueError(f"K={K} and n_obs={n_obs} must divide by {n_dev}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    Kl = K // n_dev
    ax = mesh.axis(axis)

    def local_solve(kf_pose, kf_active, lm_pose, lm_active, obs_kf, obs_lm, obs_uv, obs_ok,
                    odom_T, odom_ok, odom_w, Kmat):
        # Sharded inputs are (R, Kl, ...) or (R, Ol, ...); the replicated
        # landmarks (R, M, ...), one identical copy per local shard.
        R, Ol = obs_kf.shape
        dtype, dev = kf_pose.dtype, kf_pose.device
        me = ax.axis_index(dev)
        obs_k = torch.clamp(obs_kf.long() - me[:, None] * Kl, 0, Kl - 1)
        obs_m = obs_lm.long()
        local_idx = torch.arange(Kl, device=dev)
        # The global last keyframe has no outgoing factor.
        odom_ok = odom_ok & (me[:, None] * Kl + local_idx < K - 1)
        obj = tag_object_corners(tag_size, dtype=dtype, device=dev)
        w_obs = obs_ok.to(dtype).reshape(-1)
        uv = obs_uv.reshape(-1, 4, 2)
        oscale = torch.tensor([odom_rot_weight] * 3 + [1.0] * 3, dtype=dtype, device=dev)
        z6o = torch.zeros((R * Ol, 6), dtype=dtype, device=dev)
        z6k = torch.zeros((R * Kl, 6), dtype=dtype, device=dev)
        z6s = torch.zeros((R, 6), dtype=dtype, device=dev)
        gauge_mask = (me[:, None] == 0) & (local_idx == 0)  # global keyframe 0
        keep = 1.0 - gauge_mask.to(dtype)
        kf_prior = (1.0 - kf_active.to(dtype)) * 1e4 + gauge_mask.to(dtype) * gauge_weight
        lm_prior = (1.0 - lm_active.to(dtype)) * 1e4
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        sh = lambda x: x.reshape((R, -1) + x.shape[1:])  # noqa: E731
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731

        # The seam factor owned by the left neighbour, re-linearized here
        # for this block's first diagonal block: its measurement, flag and
        # weight cross once (constants of the problem).
        T_in = ax.from_left(odom_T[:, -1])
        ok_in = ax.from_left(odom_ok[:, -1].to(dtype)) > 0.5
        w_in = ax.from_left(odom_w[:, -1])
        ok_k = flat(odom_ok)

        def next_poses(kf_p):
            """Each keyframe's successor: the right neighbour's first pose
            closes the block (the wrap at the global end is masked)."""
            return torch.cat([kf_p[:, 1:], ax.from_right(kf_p[:, 0])[:, None]], dim=1)

        def robust_cost(kf_p, lm_p):
            r = _residuals(z6o, z6o, flat(gather(kf_p, obs_k)), flat(gather(lm_p, obs_m)), uv, obj, Kmat)
            c_obs = sh(_huber_rho(r, huber_px).sum(-1) * w_obs).sum(1)
            r_od = _odom_residuals(z6k, z6k, flat(kf_p), flat(next_poses(kf_p)), flat(odom_T), oscale)
            r_od = torch.where(ok_k[:, None], r_od * flat(odom_w)[:, None], 0.0)
            return ax.psum(c_obs + sh((r_od * r_od).sum(-1)).sum(1))

        def linearize(kf_p, lm_p):
            # ---- reprojection factors ----
            Twc, Twt = flat(gather(kf_p, obs_k)), flat(gather(lm_p, obs_m))
            r = _residuals(z6o, z6o, Twc, Twt, uv, obj, Kmat)
            Jc, Jl = _jacobians(z6o, z6o, Twc, Twt, uv, obj, Kmat)
            wh = _huber_sqrt_weights(r, huber_px) * w_obs[:, None]
            r, Jc, Jl = r * wh, Jc * wh[..., None], Jl * wh[..., None]
            Hcc = segment_sum(sh(torch.einsum("ori,orj->oij", Jc, Jc)), obs_k, Kl)
            bc = segment_sum(sh(torch.einsum("ori,or->oi", Jc, r)), obs_k, Kl)
            Hll = segment_sum(sh(torch.einsum("ori,orj->oij", Jl, Jl)), obs_m, M)
            bl = segment_sum(sh(torch.einsum("ori,or->oi", Jl, r)), obs_m, M)
            A = sh(torch.einsum("ori,orj->oij", Jc, Jl))  # (R, Ol, 6, 6) coupling

            # ---- odometry factors k -> k+1 (owned at k) ----
            T_i, T_j = flat(kf_p), flat(next_poses(kf_p))
            r_od = _odom_residuals(z6k, z6k, T_i, T_j, flat(odom_T), oscale)
            Ji, Jj = _odom_jacobians(z6k, z6k, T_i, T_j, flat(odom_T), oscale)
            w = flat(odom_w)
            r_od = sh(torch.where(ok_k[:, None], r_od * w[:, None], 0.0))
            Ji = sh(torch.where(ok_k[:, None, None], Ji * w[:, None, None], 0.0))
            Jj = sh(torch.where(ok_k[:, None, None], Jj * w[:, None, None], 0.0))
            # Source-side contributions land on the owner's diagonal.
            Hcc = Hcc + torch.einsum("rkxi,rkxj->rkij", Ji, Ji)
            bc = bc + torch.einsum("rkxi,rkx->rki", Ji, r_od)
            E = torch.einsum("rkxi,rkxj->rkij", Ji, Jj)  # couples k -> k+1
            # Target-side contributions of local factors (k+1 local too).
            HJJ = torch.einsum("rkxi,rkxj->rkij", Jj, Jj)
            bJ = torch.einsum("rkxi,rkx->rki", Jj, r_od)
            Hcc = Hcc + torch.cat([torch.zeros_like(HJJ[:, :1]), HJJ[:, :-1]], dim=1)
            bc = bc + torch.cat([torch.zeros_like(bJ[:, :1]), bJ[:, :-1]], dim=1)
            # Target side of the incoming seam factor ((left's last) -> my 0).
            p_left = ax.from_left(kf_p[:, -1])
            r_s = _odom_residuals(z6s, z6s, p_left, kf_p[:, 0], T_in, oscale)
            Ji_s, Jj_s = _odom_jacobians(z6s, z6s, p_left, kf_p[:, 0], T_in, oscale)
            r_s = torch.where(ok_in[:, None], r_s * w_in[:, None], 0.0)
            Ji_s = torch.where(ok_in[:, None, None], Ji_s * w_in[:, None, None], 0.0)
            Jj_s = torch.where(ok_in[:, None, None], Jj_s * w_in[:, None, None], 0.0)
            first = local_idx == 0
            Hcc = torch.where(first[:, None, None], Hcc + (Jj_s.transpose(-1, -2) @ Jj_s)[:, None], Hcc)
            bc = torch.where(first[:, None], bc + torch.einsum("rxi,rx->ri", Jj_s, r_s)[:, None], bc)
            E_in = Ji_s.transpose(-1, -2) @ Jj_s  # couples (left's last) -> my 0
            return Hcc, bc, Hll, bl, A, E, E_in

        kf_p, lm_p = kf_pose, lm_pose
        lam = torch.full((R,), damping, dtype=dtype, device=dev)
        for _ in range(iters):
            cost0 = robust_cost(kf_p, lm_p)
            Hcc, bc, Hll_part, bl_part, A, E, E_in = linearize(kf_p, lm_p)
            Hll = ax.psum(Hll_part)
            bl = ax.psum(bl_part)
            Hll_inv = torch.linalg.inv_ex(_damp_rows(Hll, lam, lm_prior)).inverse  # (R, M, 6, 6)
            Hcc_d = _damp_rows(Hcc, lam, kf_prior)

            # rhs of the reduced camera system: bc - W Hll_inv bl (local).
            Hb = _mv(Hll_inv, bl)
            rhs = bc - segment_sum(torch.einsum("roab,rob->roa", A, gather(Hb, obs_m)), obs_k, Kl)
            E_prev = torch.cat([E_in[:, None], E[:, :-1]], dim=1)

            def S_apply(x):  # x (R, Kl, 6): this shard's block of the global vector
                x_next = torch.cat([x[:, 1:], ax.from_right(x[:, 0])[:, None]], dim=1)
                x_prev = torch.cat([ax.from_left(x[:, -1])[:, None], x[:, :-1]], dim=1)
                # banded odometry coupling: E_k x_{k+1} and E_{k-1}^T x_{k-1}
                y = _mv(Hcc_d, x) + _mv(E, x_next) + torch.einsum("rkba,rkb->rka", E_prev, x_prev)
                # landmark coupling: W Hll_inv W^T x, one psum of (M, 6)
                u = ax.psum(segment_sum(torch.einsum("roab,roa->rob", A, gather(x, obs_k)), obs_m, M))
                v = _mv(Hll_inv, u)
                return y - segment_sum(torch.einsum("roab,rob->roa", A, gather(v, obs_m)), obs_k, Kl)

            # Exact block-Jacobi preconditioner: each keyframe sees a
            # landmark at most once, so diag(W Hll_inv W^T) is a plain
            # per-observation sum — no pair terms.
            Bd = torch.einsum("roab,robc,rodc->road", A, gather(Hll_inv, obs_m), A)
            Pinv = torch.linalg.inv_ex(Hcc_d - segment_sum(Bd, obs_k, Kl) + 1e-6 * eye6).inverse

            def pdot(a, b):
                return ax.psum((a * b).sum((1, 2)))

            x = torch.zeros_like(rhs)
            res = rhs
            z = _mv(Pinv, res)
            p = z
            rz = pdot(res, z)
            for _ in range(cg_iters):
                Sp = S_apply(p)
                alpha = (rz / (pdot(p, Sp) + 1e-30))[:, None, None]
                x = x + alpha * p
                res = res - alpha * Sp
                z = _mv(Pinv, res)
                rz_new = pdot(res, z)
                p = z + (rz_new / (rz + 1e-30))[:, None, None] * p
                rz = rz_new
            # The prior keeps S nonsingular; zeroing the gauge keyframe's
            # update makes the pin exact.
            dc = -x * keep[..., None]

            # Landmark back-substitution (replicated result).
            Wtdc = ax.psum(segment_sum(torch.einsum("roab,roa->rob", A, gather(dc, obs_k)), obs_m, M))
            dl = -_mv(Hll_inv, bl + Wtdc)

            kf_new = torch.where(kf_active[..., None, None], se3_exp(dc) @ kf_p, kf_p)
            lm_new = torch.where(lm_active[..., None, None], se3_exp(dl) @ lm_p, lm_p)
            cost1 = robust_cost(kf_new, lm_new)
            accept = (cost1 < cost0) & torch.isfinite(cost1)
            kf_p = torch.where(accept[:, None, None, None], kf_new, kf_p)
            lm_p = torch.where(accept[:, None, None, None], lm_new, lm_p)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-7, 1e6)
            last = torch.where(accept, cost1, cost0)
        return kf_p, lm_p, last

    def run(prob: KeyframeBAProblem, Kmat):
        S = mesh.local_size(axis)
        sharded = {f: shard_leading(mesh, getattr(prob, f), axis) for f in KF_SHARDED}
        rep = {f: replicated(mesh, getattr(prob, f)).expand((S,) + tuple(getattr(prob, f).shape))
               for f in ("lm_pose", "lm_active")}
        Km = replicated(mesh, Kmat).to(sharded["kf_pose"].dtype)
        kf, lm, cost = local_solve(
            sharded["kf_pose"], sharded["kf_active"], rep["lm_pose"], rep["lm_active"],
            sharded["obs_kf"], sharded["obs_lm"], sharded["obs_uv"], sharded["obs_ok"],
            sharded["odom_T"], sharded["odom_ok"], sharded["odom_weight"], Km,
        )
        out = replace(prob, kf_pose=kf.reshape(prob.kf_pose.shape), lm_pose=lm[0])
        return out, float(cost[0])

    return run


def keyframe_ba_cost(prob: KeyframeBAProblem, Kmat, tag_size: float,
                     huber_px: float = 4.0, odom_rot_weight: float = 25.0) -> torch.Tensor:
    """Unsharded robust cost of a problem (0-dim tensor): the parity check
    between single-shard and sharded solves."""
    dtype, dev = prob.kf_pose.dtype, prob.kf_pose.device
    obj = tag_object_corners(tag_size, dtype=dtype, device=dev)
    Km = torch.as_tensor(Kmat, device=dev).to(dtype)
    O = prob.obs_kf.shape[0]
    z6 = torch.zeros((O, 6), dtype=dtype, device=dev)
    r = _residuals(z6, z6, prob.kf_pose[prob.obs_kf.long()], prob.lm_pose[prob.obs_lm.long()],
                   prob.obs_uv, obj, Km)
    c_obs = (_huber_rho(r, huber_px).sum(-1) * prob.obs_ok.to(dtype)).sum()
    K = prob.n_keyframes
    k = torch.arange(K, device=dev)
    odom_ok = prob.odom_ok & (k < K - 1)
    oscale = torch.tensor([odom_rot_weight] * 3 + [1.0] * 3, dtype=dtype, device=dev)
    z6k = torch.zeros((K, 6), dtype=dtype, device=dev)
    r_od = _odom_residuals(z6k, z6k, prob.kf_pose, prob.kf_pose[torch.clamp(k + 1, max=K - 1)],
                           prob.odom_T, oscale)
    r_od = torch.where(odom_ok[:, None], r_od * prob.odom_weight[:, None], 0.0)
    return c_obs + (r_od * r_od).sum()
