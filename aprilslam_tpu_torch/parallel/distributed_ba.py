"""Distributed bundle adjustment: landmark blocks sharded over the mesh
(port of ``aprilslam_tpu/parallel/distributed_ba.py``).

* Landmark slots are partitioned over the ``lm`` axis; each observation is
  owned by the shard holding its landmark, so every per-observation term
  (residuals, Jacobians, H_ll blocks, coupling blocks) is computed once.
* The camera-side quantities (H_cc, b_c) and the Schur-reduced camera
  system S = H_cc - W H_ll^-1 W^T are partial sums over observations: one
  ``psum`` each of H_cc, S and rhs per LM iteration, and two of the cost.
  The (6K x 6K) reduced solve is replicated (``_solve_jacobi``), so the
  camera update is the same on every shard, and each shard back-substitutes
  its own landmarks.
* The Schur assembly is sparse: per-observation coupling blocks grouped by
  landmark (``slam/ba.py``'s ``lm_obs_grid``/``schur_sparse``), with no
  (K, M, 6, 6) tensor.

With ``data_axis`` set, every state field carries a leading sequence
dimension: each sequence runs its own BA, landmark-sharded over ``axis``,
and the collectives stay on ``axis``.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import fields, replace

import numpy as np
import torch

from ..geometry import se3_exp, tag_object_corners
from ..slam.ba import (
    BAState,
    _huber_sqrt_weights,
    _jacobians,
    _residuals,
    _solve_jacobi,
    backsub_sparse,
    lm_obs_grid,
    schur_sparse,
)
from .collectives import flat_index, segment_sum
from .keyframe_ba import _damp_rows, _huber_rho
from .mesh import Mesh, replicated

logger = logging.getLogger(__name__)

# Fields split over the lm axis; the keyframe fields are replicated.
LM_SHARDED = ("lm_pose", "lm_active", "obs_kf", "obs_lm", "obs_uv", "obs_ok")


def shard_observations_by_owner(state: BAState, n_shards: int,
                                fit: bool = False) -> BAState:
    """Reorder the observation ring so each contiguous block holds the
    observations owned by one landmark shard (host-side prep; by default the
    arrays stay the same size, invalid slots padded per shard).

    Each shard owns landmark slots [s * M/n, (s+1) * M/n). Observations are
    bucketed by owner into equal-size blocks of O/n. Overflowing a block
    DROPS observations from the problem — that silently weakens BA, so it
    is surfaced as a real warning with the count; size the ring so it never
    fires (or rebalance the landmark partition).

    ``fit=True`` instead GROWS the ring so every observation fits: the block
    size becomes the largest shard's count (padded to a multiple of 8), and
    nothing is ever dropped. Use it for host-side batch solves; the fixed-
    capacity default is for in-pipeline rings whose shapes must not change.
    """
    M = state.n_landmarks
    O = state.n_obs_capacity
    kf = state.obs_kf.cpu().numpy()
    lm = state.obs_lm.cpu().numpy()
    uv = state.obs_uv.cpu().numpy()
    ok = state.obs_ok.cpu().numpy()
    if fit:
        owners = lm[ok] // max(M // n_shards, 1)
        per = int(np.bincount(owners, minlength=n_shards).max()) if owners.size else 1
        per = max(8, -8 * (-per // 8))  # round up to a multiple of 8
        O = per * n_shards
    else:
        per = O // n_shards
    lm_owner = lm // max(M // n_shards, 1)

    new_kf = np.zeros(O, np.int32)
    new_lm = np.zeros(O, np.int32)
    new_uv = np.zeros((O, 4, 2), uv.dtype)
    new_ok = np.zeros(O, bool)
    dropped = 0
    for s in range(n_shards):
        idx_all = np.nonzero(ok & (lm_owner == s))[0]
        dropped += max(0, len(idx_all) - per)
        idx = idx_all[:per]
        dst = slice(s * per, s * per + len(idx))
        new_kf[dst] = kf[idx]
        new_lm[dst] = lm[idx]
        new_uv[dst] = uv[idx]
        new_ok[dst] = True
    if dropped:
        msg = (
            f"shard_observations_by_owner: {dropped} observation(s) exceed the "
            f"per-shard block of {per} and were DROPPED from BA — grow n_obs "
            f"(capacity {O}) or rebalance the landmark partition."
        )
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        logger.warning(msg)
    dev = state.obs_kf.device
    return replace(
        state,
        obs_kf=torch.as_tensor(new_kf, device=dev),
        obs_lm=torch.as_tensor(new_lm, device=dev),
        obs_uv=torch.as_tensor(new_uv, device=dev),
        obs_ok=torch.as_tensor(new_ok, device=dev),
    )


def build_distributed_ba(
    mesh: Mesh,
    n_keyframes: int,
    n_landmarks: int,
    n_obs: int,
    tag_size: float,
    axis: str = "lm",
    iters: int = 8,
    damping: float = 1e-2,
    huber_px: float = 4.0,
    max_obs_per_lm: int = 0,
    data_axis: str | None = None,
):
    """Returns ``run(state, Kmat) -> (state', cost)`` running LM-BA with
    landmarks and observations sharded over ``axis``; ``cost`` is the last
    candidate's robust cost, read once (a float, or with ``data_axis`` a
    numpy array of one cost per local sequence).

    ``state`` must have its observation blocks grouped by owner
    (``shard_observations_by_owner``) and landmark arrays that split by
    slot; with ``data_axis`` every field has a leading sequence dimension
    (``stack_ba_states``). On a process-group mesh the landmark-sharded
    fields hold this rank's rows (``multihost.make_global``).
    """
    n_dev = mesh.shape[axis]
    K, M = n_keyframes, n_landmarks
    if M % n_dev or n_obs % n_dev:
        raise ValueError(f"M={M} and n_obs={n_obs} must divide by {n_dev}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    Ml = M // n_dev  # landmarks per shard
    Pcap = max_obs_per_lm or K
    D = mesh.local_size(data_axis) if data_axis is not None else 1
    S = mesh.local_size(axis)
    ax = mesh.axis(axis, batch=D)

    def solve(kf_pose, kf_active, lm_pose, lm_active, obs_kf, obs_lm, obs_uv, obs_ok, Kmat):
        # Rows R = D * S: (R, K, ...) replicated keyframes, (R, Ml, ...)
        # landmark shards, (R, Ol, ...) their observations.
        R, Ol = obs_kf.shape
        dtype, dev = kf_pose.dtype, kf_pose.device
        me = ax.axis_index(dev)
        lml = torch.clamp(obs_lm.long() - me[:, None] * Ml, 0, Ml - 1)
        kf_i = flat_index(obs_kf, K)  # rows of the flattened (R * K) keyframes
        lm_i = flat_index(lml, Ml)  # rows of the flattened (R * Ml) landmarks
        ok = obs_ok.reshape(-1)
        # The observation pattern is fixed across iterations. A landmark's
        # observations all lie in its shard's row, so one grid over the
        # flattened rows groups every shard's at once.
        grid, _ = lm_obs_grid(lm_i, ok, R * Ml, Pcap)
        obj = tag_object_corners(tag_size, dtype=dtype, device=dev)
        w = ok.to(dtype)
        uv = obs_uv.reshape(-1, 4, 2)
        z6 = torch.zeros((R * Ol, 6), dtype=dtype, device=dev)
        sh = lambda x: x.reshape((R, Ol) + x.shape[1:])  # noqa: E731
        # Gauge left to Marquardt damping; anchor-relative consumers
        # conjugate by the refined anchor pose (see slam/ba.py).
        lm_prior = (1.0 - lm_active.to(dtype)) * 1e4
        kf_prior = (1.0 - kf_active.to(dtype)) * 1e4
        diag_k = torch.eye(K, dtype=torch.bool, device=dev)[None, :, :, None, None]

        def poses(kf_p, lm_p):
            return kf_p.reshape(-1, 4, 4)[kf_i], lm_p.reshape(-1, 4, 4)[lm_i]

        def robust_cost_of(kf_p, lm_p):
            rr = _residuals(z6, z6, *poses(kf_p, lm_p), uv, obj, Kmat)
            return ax.psum(sh(_huber_rho(rr, huber_px).sum(-1) * w).sum(1))

        kf_p, lm_p = kf_pose, lm_pose
        lam = torch.full((R,), damping, dtype=dtype, device=dev)
        for _ in range(iters):
            Twc, Twt = poses(kf_p, lm_p)
            r = _residuals(z6, z6, Twc, Twt, uv, obj, Kmat)
            Jc, Jl = _jacobians(z6, z6, Twc, Twt, uv, obj, Kmat)
            wh = _huber_sqrt_weights(r, huber_px) * w[:, None]
            r, Jc, Jl = r * wh, Jc * wh[..., None], Jl * wh[..., None]
            Hcc = segment_sum(sh(torch.einsum("ori,orj->oij", Jc, Jc)), obs_kf, K)
            bc = segment_sum(sh(torch.einsum("ori,or->oi", Jc, r)), obs_kf, K)
            Hll = segment_sum(sh(torch.einsum("ori,orj->oij", Jl, Jl)), lml, Ml)
            bl = segment_sum(sh(torch.einsum("ori,or->oi", Jl, r)), lml, Ml)
            A = torch.einsum("ori,orj->oij", Jc, Jl)  # per-observation coupling blocks

            Hll_inv = torch.linalg.inv_ex(_damp_rows(Hll, lam, lm_prior)).inverse
            # Damping applies to the full (psum'd) H_cc.
            Hcc_d = _damp_rows(ax.psum(Hcc), lam, kf_prior)

            # Sparse Schur assembly of every row's partial reduced system at
            # once: row r's keyframes are the flattened rows r*K + k, so the
            # partials are the diagonal (K, K) blocks of the (R*K)^2 result.
            S_all, rhs_all = schur_sparse(grid, A, kf_i, lm_i, Hll_inv.reshape(-1, 6, 6),
                                          Hcc_d.new_zeros((R * K, 6, 6)), bc.reshape(-1, 6),
                                          bl.reshape(-1, 6), R * K)
            S_part = torch.diagonal(S_all.reshape(R, K, R, K, 6, 6), dim1=0, dim2=2).permute(4, 0, 1, 2, 3)
            cost0 = robust_cost_of(kf_p, lm_p)

            S_red = ax.psum(S_part)
            S_red = torch.where(diag_k, S_red + Hcc_d[:, :, None], S_red)
            rhs = ax.psum(rhs_all.reshape(R, K, 6))
            Sd = S_red.permute(0, 1, 3, 2, 4).reshape(R, K * 6, K * 6)
            dc = -_solve_jacobi(Sd, rhs.reshape(R, K * 6)).reshape(R, K, 6)
            dl = backsub_sparse(A, kf_i, lm_i, Hll_inv.reshape(-1, 6, 6), bl.reshape(-1, 6),
                                dc.reshape(-1, 6), R * Ml).reshape(R, Ml, 6)

            kf_new = torch.where(kf_active[..., None, None], se3_exp(dc) @ kf_p, kf_p)
            lm_new = torch.where(lm_active[..., None, None], se3_exp(dl) @ lm_p, lm_p)
            cost1 = robust_cost_of(kf_new, lm_new)
            accept = (cost1 < cost0) & torch.isfinite(cost1)
            kf_p = torch.where(accept[:, None, None, None], kf_new, kf_p)
            lm_p = torch.where(accept[:, None, None, None], lm_new, lm_p)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-7, 1e6)
        return kf_p, lm_p, cost1

    def rows(x, sharded: bool) -> torch.Tensor:
        """A field as (D * S, ...) rows: split over the lm shards, or one
        copy per shard."""
        x = replicated(mesh, x)
        if data_axis is None:
            x = x[None]
        if sharded:
            return x.reshape((D * S, x.shape[1] // S) + tuple(x.shape[2:]))
        return x[:, None].expand((D, S) + tuple(x.shape[1:])).reshape((D * S,) + tuple(x.shape[1:]))

    def run(state: BAState, Kmat):
        args = {f: rows(getattr(state, f), f in LM_SHARDED)
                for f in ("kf_pose", "kf_active") + LM_SHARDED}
        Km = replicated(mesh, Kmat).to(args["kf_pose"].dtype)
        kf, lm, cost = solve(args["kf_pose"], args["kf_active"], args["lm_pose"], args["lm_active"],
                             args["obs_kf"], args["obs_lm"], args["obs_uv"], args["obs_ok"], Km)
        kf = kf.reshape((D, S) + tuple(kf.shape[1:]))[:, 0]
        lm = lm.reshape((D, S * Ml, 4, 4))
        cost = cost.reshape(D, S)[:, 0].cpu().numpy()  # the run's one host read
        if data_axis is None:
            return replace(state, kf_pose=kf[0], lm_pose=lm[0]), float(cost[0])
        return replace(state, kf_pose=kf, lm_pose=lm), cost

    return run


def stack_ba_states(states: list[BAState]) -> BAState:
    """Stack per-sequence BAStates along a leading data axis."""
    return BAState(**{f.name: torch.stack([getattr(s, f.name) for s in states]) for f in fields(BAState)})
