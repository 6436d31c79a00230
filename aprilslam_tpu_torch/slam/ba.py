"""Sliding-window bundle adjustment with Schur-complement elimination
(port of ``aprilslam_tpu/slam/ba.py``).

* **State**: fixed-capacity keyframe ring, tag-landmark poses, and an
  observation ring.
* **Factors**: tag-corner reprojection (8 residuals per observation);
  keyframe and landmark poses are both optimized.
* **Solver**: Levenberg-Marquardt with Huber-IRLS weighting. The normal
  equations are segment sums (one-hot matmuls: deterministic, no atomics),
  the 6x6 landmark blocks are eliminated by the Schur complement, and the
  reduced camera system is solved with Jacobi preconditioning. Damping is
  Marquardt-style and lambda persists in the state.
* **Coupling**: the reduced camera system is assembled either densely, from
  a (K, M, 6, 6) W, or sparsely, from per-observation blocks grouped by
  landmark (``lm_obs_grid``/``schur_sparse``); ``coupling="auto"`` picks the
  sparse form once K*M > 4096.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.func import jacrev, vmap

from ..device import resolve_device
from ..geometry import se3_exp, se3_inverse, tag_object_corners


@dataclass(frozen=True)
class BAState:
    kf_pose: torch.Tensor  # (K, 4, 4) camera->world (T_wc)
    kf_active: torch.Tensor  # (K,) bool
    kf_ptr: torch.Tensor  # () int32 next write slot
    lm_pose: torch.Tensor  # (M, 4, 4) tag->world (slot = tag id)
    lm_active: torch.Tensor  # (M,) bool
    obs_kf: torch.Tensor  # (O,) int32
    obs_lm: torch.Tensor  # (O,) int32
    obs_uv: torch.Tensor  # (O, 4, 2)
    obs_ok: torch.Tensor  # (O,) bool
    obs_ptr: torch.Tensor  # () int32
    anchor: torch.Tensor  # () int32 gauge landmark slot (-1 = none yet)
    lam: torch.Tensor  # () LM damping, persisted across calls
    frame_count: torch.Tensor  # () int32 total frames processed

    @property
    def n_keyframes(self) -> int:
        return int(self.kf_pose.shape[0])

    @property
    def n_landmarks(self) -> int:
        return int(self.lm_pose.shape[0])

    @property
    def n_obs_capacity(self) -> int:
        return int(self.obs_kf.shape[0])


def ba_init(n_keyframes: int = 16, n_landmarks: int = 64, n_obs: int = 512,
            dtype=torch.float32, device=None) -> BAState:
    """An empty BA state on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return BAState(
        kf_pose=torch.eye(4, dtype=dtype, device=device).expand(n_keyframes, 4, 4).clone(),
        kf_active=torch.zeros((n_keyframes,), dtype=torch.bool, device=device),
        kf_ptr=torch.tensor(0, **i32),
        lm_pose=torch.eye(4, dtype=dtype, device=device).expand(n_landmarks, 4, 4).clone(),
        lm_active=torch.zeros((n_landmarks,), dtype=torch.bool, device=device),
        obs_kf=torch.zeros((n_obs,), **i32),
        obs_lm=torch.zeros((n_obs,), **i32),
        obs_uv=torch.zeros((n_obs, 4, 2), dtype=dtype, device=device),
        obs_ok=torch.zeros((n_obs,), dtype=torch.bool, device=device),
        obs_ptr=torch.tensor(0, **i32),
        anchor=torch.tensor(-1, **i32),
        lam=torch.tensor(1e-2, dtype=dtype, device=device),
        frame_count=torch.tensor(0, **i32),
    )


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """dst with dst[idx] = vals, where idx == len(dst) entries are dropped.

    ``idx`` may have any shape (a 0-dim one writes one row) and ``vals``
    broadcasts to it; a Python scalar is filled on the device, not copied
    from the host."""
    pad = torch.cat([dst, dst[:1]])
    if isinstance(vals, torch.Tensor):
        vals = vals.to(dst.dtype)
    else:
        vals = torch.full((), vals, dtype=dst.dtype, device=dst.device)
    flat = idx.reshape(-1).long()
    pad[flat] = vals.expand(idx.shape + dst.shape[1:]).reshape(flat.shape + dst.shape[1:])
    return pad[:-1]


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor already in range. Indexing with the
    0-dim tensor itself would read it back to the host."""
    return x.index_select(0, i.reshape(1).long())[0]


def ba_add_frame(
    state: BAState,
    ids: torch.Tensor,  # (D,) int32 detection tag ids
    corners: torch.Tensor,  # (D, 4, 2)
    ok: torch.Tensor,  # (D,) bool
    T_wc: torch.Tensor,  # (4, 4) initial camera pose in world frame
    T_cam_tag: torch.Tensor,  # (D, 4, 4) per-detection PnP poses (for new lms)
    seed_ok: torch.Tensor | None = None,  # (D,) bool: pose reliable for lm init
) -> BAState:
    """Insert a keyframe + its observations; initialize unseen landmarks.

    The keyframe ring overwrites its oldest slot and drops that slot's
    observations. ``seed_ok`` gates landmark initialization (and the
    observations of a still-uninitialized landmark)."""
    K = state.n_keyframes
    M = state.n_landmarks
    O = state.n_obs_capacity
    D = ids.shape[0]
    dev = ids.device
    T_wc = T_wc.to(state.kf_pose.dtype)
    T_cam_tag = T_cam_tag.to(state.kf_pose.dtype)

    slot = state.kf_ptr % K
    kf_pose = state.kf_pose.clone()
    kf_pose[slot] = T_wc
    kf_active = state.kf_active.clone()
    kf_active[slot] = True
    obs_ok = state.obs_ok & (state.obs_kf != slot)

    if seed_ok is None:
        seed_ok = ok
    in_range = ok & (ids >= 0) & (ids < M)
    ids_c = ids.clamp(0, M - 1).long()
    in_range = in_range & (state.lm_active[ids_c] | seed_ok)
    lm_slot = torch.where(in_range, ids_c, M)

    big = torch.tensor(2**30, dtype=torch.int32, device=dev)
    min_id = torch.where(in_range, ids.to(torch.int32), big).min()
    anchor = torch.where(
        state.anchor < 0, torch.where(min_id < 2**30, min_id, -1), state.anchor
    ).to(torch.int32)

    lm_init = torch.einsum("ij,djk->dik", T_wc, T_cam_tag)
    active_d = state.lm_active[ids_c]
    is_new = in_range & ~active_d
    lm_pose = _scatter_drop(
        state.lm_pose, lm_slot, torch.where(is_new[:, None, None], lm_init, state.lm_pose[ids_c]))
    lm_active = _scatter_drop(state.lm_active, lm_slot, active_d | in_range)

    idx = ((state.obs_ptr + torch.arange(D, device=dev)) % O).long()
    obs_kf = state.obs_kf.clone()
    obs_kf[idx] = torch.where(in_range, slot, state.obs_kf[idx]).to(torch.int32)
    obs_lm = state.obs_lm.clone()
    obs_lm[idx] = torch.where(in_range, lm_slot, state.obs_lm[idx].long()).to(torch.int32)
    obs_uv = state.obs_uv.clone()
    obs_uv[idx] = torch.where(in_range[:, None, None], corners.to(obs_uv.dtype), state.obs_uv[idx])
    obs_ok = obs_ok.clone()
    obs_ok[idx] = in_range | obs_ok[idx]
    return replace(
        state,
        kf_pose=kf_pose,
        kf_active=kf_active,
        kf_ptr=state.kf_ptr + 1,
        lm_pose=lm_pose,
        lm_active=lm_active,
        obs_kf=obs_kf,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        obs_ok=obs_ok,
        obs_ptr=(state.obs_ptr + D) % O,
        anchor=anchor,
    )


def _obs_residual(xi_c, xi_l, T_wc, T_wt, uv, obj, Kmat):
    """8-vector reprojection residual of one observation with tangent
    perturbations xi_c (camera) and xi_l (landmark)."""
    T_ct = se3_inverse(se3_exp(xi_c) @ T_wc) @ (se3_exp(xi_l) @ T_wt)
    p = obj @ T_ct[:3, :3].T + T_ct[:3, 3]
    z = torch.where(torch.abs(p[:, 2:3]) < 1e-6, 1e-6, p[:, 2:3])
    xy = p[:, :2] / z
    proj = torch.stack([Kmat[0, 0] * xy[:, 0] + Kmat[0, 2], Kmat[1, 1] * xy[:, 1] + Kmat[1, 2]], dim=-1)
    return (proj - uv).reshape(-1)


_IN_DIMS = (0, 0, 0, 0, 0, None, None)
_residuals = vmap(_obs_residual, in_dims=_IN_DIMS)
_jacobians = vmap(jacrev(_obs_residual, argnums=(0, 1)), in_dims=_IN_DIMS)


def ba_cost(state: BAState, Kmat: torch.Tensor, tag_size: float) -> torch.Tensor:
    dtype = state.kf_pose.dtype
    obj = tag_object_corners(tag_size, dtype=dtype, device=state.kf_pose.device)
    z6 = torch.zeros((state.n_obs_capacity, 6), dtype=dtype, device=obj.device)
    r = _residuals(z6, z6, state.kf_pose[state.obs_kf.long()], state.lm_pose[state.obs_lm.long()],
                   state.obs_uv, obj, Kmat)
    return ((r * r).sum(-1) * state.obs_ok.to(dtype)).sum()


def _huber_sqrt_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-residual sqrt(IRLS weight) for a Huber loss with threshold delta."""
    return torch.sqrt(torch.clamp(delta / torch.clamp(torch.abs(r), min=1e-12), max=1.0))


def _damp_blocks(H: torch.Tensor, lam: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Marquardt damping on (N, 6, 6) blocks: H + lam*diag(H) + prior*I."""
    dg = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-4)
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    return H + lam * dg[..., None] * eye6 + (prior[:, None, None] + 1e-6) * eye6


def _solve_jacobi(Sd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve Sd x = rhs with Jacobi (diagonal) preconditioning."""
    d = torch.clamp(torch.abs(torch.diagonal(Sd)), min=1e-8)
    m = 1.0 / torch.sqrt(d)
    Ss = Sd * m[:, None] * m[None, :]
    y = torch.linalg.solve_ex(Ss, (rhs * m)[:, None]).result[:, 0]
    return y * m


def lm_obs_grid(obs_lm: torch.Tensor, obs_ok: torch.Tensor, M: int, P: int):
    """Group observation indices by landmark into a static (M, P) grid.

    Returns ``(grid, overflow)``: ``grid[m, p]`` is the index of the p-th
    observation of landmark m (sentinel O = empty, which gathers a zero
    padding row) and ``overflow`` counts valid observations beyond P that
    did not fit. Keyframes i and j interact only through landmarks both
    observe, so the pair work is O(M P^2) instead of the dense O(K^2 M)."""
    O = obs_lm.shape[0]
    dev = obs_lm.device
    key = torch.where(obs_ok, obs_lm, M).to(torch.int32)
    order = torch.argsort(key, stable=True)
    slm = key[order]
    idx = torch.arange(O, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), slm[1:] != slm[:-1]])
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = idx - run_start
    valid = slm < M
    m_idx = torch.where(valid & (rank < P), slm.long(), M)
    p_idx = torch.clamp(rank, max=P - 1)
    grid = torch.full((M + 1, P), O, dtype=torch.int32, device=dev)
    grid[m_idx, p_idx] = order.to(torch.int32)
    return grid[:M], (valid & (rank >= P)).sum()


def schur_sparse(grid, A, obs_kf, obs_lm, Hll_inv, Hcc_d, bc, bl, K):
    """Assemble the reduced camera system from per-observation coupling
    blocks A_o = Jc_o^T Jl_o without materializing the (K, M, 6, 6) W:

    S = blockdiag(Hcc_d) - sum_m sum_{p,q in obs(m)} A_p Hll_inv_m A_q^T
    rhs = bc - sum_o A_o (Hll_inv_{m_o} bl_{m_o})

    Invalid observations carry A_o = 0 (their Jacobians are weighted by the
    ok mask). The pair blocks are scatter-added (``index_add_``), so on the
    card their summation order, and the last bits of S, may vary."""
    O = A.shape[0]
    Mi, P = grid.shape
    g = grid.long()
    Ap = torch.cat([A, A.new_zeros((1, 6, 6))])  # zero padding row
    kfp = torch.cat([obs_kf.long(), obs_kf.new_zeros((1,)).long()])
    G = Ap[g]  # (M, P, 6, 6)
    kf_g = torch.where(g < O, kfp[g], K)  # empty slots -> the dropped pad block
    GH = torch.einsum("mpab,mbc->mpac", G, Hll_inv)
    pair = torch.einsum("mpac,mqdc->mpqad", GH, G)  # (M, P, P, 6, 6)
    ki = kf_g[:, :, None].expand(Mi, P, P)
    kj = kf_g[:, None, :].expand(Mi, P, P)
    flat = torch.where((ki < K) & (kj < K), ki * K + kj, K * K).reshape(-1)
    S = A.new_zeros((K * K + 1, 6, 6)).index_add_(0, flat, -pair.reshape(-1, 6, 6))[:-1]
    S = S.reshape(K, K, 6, 6)
    diag_k = torch.arange(K, device=A.device)
    S[diag_k, diag_k] += Hcc_d
    Hb = torch.einsum("mab,mb->ma", Hll_inv, bl)  # (M, 6)
    onehot_kf = F.one_hot(obs_kf.long(), K).to(A.dtype)
    rhs = bc - onehot_kf.T @ torch.einsum("oab,ob->oa", A, Hb[obs_lm.long()])
    return S, rhs


def backsub_sparse(A, obs_kf, obs_lm, Hll_inv, bl, dc, M: int):
    """Landmark back-substitution dl = -Hll_inv (bl + W^T dc) from
    per-observation blocks: W_m^T dc = sum_{o in m} A_o^T dc_{k_o}."""
    onehot_lm = F.one_hot(obs_lm.long(), M).to(A.dtype)
    Wtdc = onehot_lm.T @ torch.einsum("oab,oa->ob", A, dc[obs_kf.long()])
    return -torch.einsum("mab,mb->ma", Hll_inv, bl + Wtdc)


def ba_optimize(
    state: BAState,
    Kmat: torch.Tensor,
    tag_size: float,
    iters: int = 8,
    huber_px: float = 4.0,
    coupling: str = "auto",
    max_obs_per_lm: int = 0,
) -> BAState:
    """Levenberg-Marquardt over keyframe + landmark poses (Schur-eliminated).
    Lambda is read from and written back to the state.

    ``coupling``: "dense" materializes the (K, M, 6, 6) W, "sparse" sums
    per-observation Schur contributions grouped by landmark, "auto" picks
    sparse once K*M > 4096. ``max_obs_per_lm`` caps the sparse grid's P
    (0 = K, always enough for the keyframe ring: a landmark has at most one
    observation per keyframe slot)."""
    K = state.n_keyframes
    M = state.n_landmarks
    if coupling == "auto":
        coupling = "sparse" if K * M > 4096 else "dense"
    if coupling not in ("dense", "sparse"):
        raise ValueError(f"coupling must be 'dense', 'sparse' or 'auto', not {coupling!r}")
    use_sparse = coupling == "sparse"
    if use_sparse:
        # The observation pattern is fixed across LM iterations.
        grid, _overflow = lm_obs_grid(state.obs_lm, state.obs_ok, M, max_obs_per_lm or K)
    dtype = state.kf_pose.dtype
    dev = state.kf_pose.device
    O = state.n_obs_capacity
    obj = tag_object_corners(tag_size, dtype=dtype, device=dev)
    Kmat = Kmat.to(dtype)
    z6 = torch.zeros((O, 6), dtype=dtype, device=dev)
    okf = state.obs_ok.to(dtype)
    kf_idx = state.obs_kf.long()
    lm_idx = state.obs_lm.long()
    # Segment sums as one-hot products: deterministic on the card.
    onehot_kf = F.one_hot(kf_idx, K).to(dtype)  # (O, K)
    onehot_lm = F.one_hot(lm_idx, M).to(dtype)  # (O, M)
    uv = state.obs_uv

    def robust_cost(kf_p, lm_p):
        rr = _residuals(z6, z6, kf_p[kf_idx], lm_p[lm_idx], uv, obj, Kmat)
        a = torch.abs(rr)
        rho = torch.where(a <= huber_px, rr * rr, huber_px * (2.0 * a - huber_px))
        return (rho.sum(-1) * okf).sum()

    def linearize(kf_pose, lm_pose):
        Twc = kf_pose[kf_idx]
        Twt = lm_pose[lm_idx]
        r = _residuals(z6, z6, Twc, Twt, uv, obj, Kmat)
        Jc, Jl = _jacobians(z6, z6, Twc, Twt, uv, obj, Kmat)  # (O, 8, 6) each
        wh = _huber_sqrt_weights(r, huber_px) * okf[:, None]
        r = r * wh
        Jc = Jc * wh[..., None]
        Jl = Jl * wh[..., None]
        Hcc = torch.einsum("ok,oij->kij", onehot_kf, torch.einsum("ori,orj->oij", Jc, Jc))
        Hll = torch.einsum("om,oij->mij", onehot_lm, torch.einsum("ori,orj->oij", Jl, Jl))
        bc = onehot_kf.T @ torch.einsum("ori,or->oi", Jc, r)
        bl = onehot_lm.T @ torch.einsum("ori,or->oi", Jl, r)
        A = torch.einsum("ori,orj->oij", Jc, Jl)  # per-observation coupling blocks
        return Hcc, Hll, bc, bl, A

    kf_pose, lm_pose, lam = state.kf_pose, state.lm_pose, state.lam
    lm_prior = (1.0 - state.lm_active.to(dtype)) * 1e4
    kf_prior = (1.0 - state.kf_active.to(dtype)) * 1e4
    diag_k = torch.arange(K, device=dev)
    for _ in range(iters):
        Hcc, Hll, bc, bl, A = linearize(kf_pose, lm_pose)
        cost0 = robust_cost(kf_pose, lm_pose)
        Hll_inv = torch.linalg.inv_ex(_damp_blocks(Hll, lam, lm_prior)).inverse  # (M, 6, 6)
        Hcc_d = _damp_blocks(Hcc, lam, kf_prior)
        if use_sparse:
            S, rhs = schur_sparse(grid, A, state.obs_kf, state.obs_lm, Hll_inv, Hcc_d, bc, bl, K)
        else:
            # Dense W: per-observation blocks summed into (K, M, 6, 6).
            Wkm = torch.einsum("ok,om,oab->kmab", onehot_kf, onehot_lm, A)
            WH = torch.einsum("kmab,mbc->kmac", Wkm, Hll_inv)
            S = -torch.einsum("kmac,lmdc->klad", WH, Wkm)
            S[diag_k, diag_k] += Hcc_d
            rhs = bc - torch.einsum("kmab,mb->ka", WH, bl)
        Sd = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        dc = -_solve_jacobi(Sd, rhs.reshape(K * 6)).reshape(K, 6)
        dl = backsub_sparse(A, state.obs_kf, state.obs_lm, Hll_inv, bl, dc, M)

        kf_new = torch.where(state.kf_active[:, None, None], se3_exp(dc) @ kf_pose, kf_pose)
        lm_new = torch.where(state.lm_active[:, None, None], se3_exp(dl) @ lm_pose, lm_pose)
        cost1 = robust_cost(kf_new, lm_new)
        accept = (cost1 < cost0) & torch.isfinite(cost1)
        kf_pose = torch.where(accept, kf_new, kf_pose)
        lm_pose = torch.where(accept, lm_new, lm_pose)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-7, 1e6)
    return replace(state, kf_pose=kf_pose, lm_pose=lm_pose, lam=lam)


def latest_pose(state: BAState) -> torch.Tensor:
    """Camera pose of the most recently added keyframe."""
    return state.kf_pose[(state.kf_ptr - 1) % state.n_keyframes]
