"""Online loop closure: mint pose-graph edges from the live pipeline and
redistribute drift with ``pgo.pgo_optimize`` (port of
``aprilslam_tpu/slam/loop.py``).

A bounded camera pose graph runs beside the BA window:

* a **node** per adopted keyframe (a ring: the oldest node is evicted),
  storing the camera world pose at adoption;
* an **odometry edge** between consecutive nodes;
* **loop-closure edges** when a landmark unseen for > ``loop_gap`` frames
  is re-observed on node frames: two PnP observations of the same tag give
  the relative node transform T_a_obs @ inv(T_b_obs), independent of the
  drifted map. Re-entry opens a **loop window** in which every node frame
  mints another edge against the same frozen partner; edges between nodes
  fewer than ``min_node_sep`` adoptions apart are suppressed.

Per-frame work never reads a value back to the host: state is indexed with
1-element index tensors or one-hot selects, and scatters write out-of-range
slots into a dropped pad row. The solve is gated on the host (see
:func:`pgo_solve`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..geometry import se3_inverse
from .ba import _scatter_drop, _take
from .pgo import PoseGraphEdges, edges_init, pgo_optimize


@dataclass(frozen=True)
class PgoState:
    node_pose: torch.Tensor  # (P, 4, 4) camera world pose per pose-graph node
    node_active: torch.Tensor  # (P,) bool
    node_seq: torch.Tensor  # (P,) int32 adoption sequence number of the tenant
    node_ptr: torch.Tensor  # () int32 total adoptions (slot = ptr % P, ring)
    edges: PoseGraphEdges  # capacity E (ring)
    edge_ptr: torch.Tensor  # () int32 total edges written (slot = ptr % E)
    kf_node: torch.Tensor  # (K,) int32 pose-graph node slot per BA keyframe slot
    lm_node: torch.Tensor  # (M,) int32 node slot of the landmark's last node-frame obs
    # Reference node: the first node-frame observation, frozen. Map
    # corrections conjugate by it, the epoch the landmark was seeded in.
    lm_ref: torch.Tensor  # (M,) int32
    lm_obs_T: torch.Tensor  # (M, 4, 4) PnP T (tag pose in camera frame) at that node
    lm_frame: torch.Tensor  # (M,) int32 frame index of the last sighting (any frame)
    # Loop window: partner node and its observation frozen at re-entry.
    lm_loop_node: torch.Tensor  # (M,) int32 frozen partner slot (-1 = closed)
    lm_loop_T: torch.Tensor  # (M, 4, 4) frozen partner observation
    lm_loop_until: torch.Tensor  # (M,) int32 window end frame (exclusive)
    frame: torch.Tensor  # () int32 frames processed
    n_loops: torch.Tensor  # () int32 loop edges minted
    n_solved: torch.Tensor  # () int32 loop edges folded into the last solve
    last_opt: torch.Tensor  # () int32 frame of the last pose-graph solve

    @property
    def n_nodes_capacity(self) -> int:
        return int(self.node_pose.shape[0])


def pgo_init(n_nodes: int = 64, n_edges: int = 192, n_landmarks: int = 64, n_keyframes: int = 16,
             dtype=torch.float32, device=None) -> PgoState:
    """An empty camera pose graph on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = torch.eye(4, dtype=dtype, device=device)
    return PgoState(
        node_pose=eye.expand(n_nodes, 4, 4).clone(),
        node_active=torch.zeros((n_nodes,), dtype=torch.bool, device=device),
        node_seq=torch.full((n_nodes,), -1, **i32),
        node_ptr=torch.zeros((), **i32),
        edges=edges_init(n_edges, dtype, device=device),
        edge_ptr=torch.zeros((), **i32),
        kf_node=torch.full((n_keyframes,), -1, **i32),
        lm_node=torch.full((n_landmarks,), -1, **i32),
        lm_ref=torch.full((n_landmarks,), -1, **i32),
        lm_obs_T=eye.expand(n_landmarks, 4, 4).clone(),
        lm_frame=torch.zeros((n_landmarks,), **i32),
        lm_loop_node=torch.full((n_landmarks,), -1, **i32),
        lm_loop_T=eye.expand(n_landmarks, 4, 4).clone(),
        lm_loop_until=torch.zeros((n_landmarks,), **i32),
        frame=torch.zeros((), **i32),
        n_loops=torch.zeros((), **i32),
        n_solved=torch.zeros((), **i32),
        last_opt=torch.full((), -(1 << 20), **i32),
    )


def _edge_scatter(edges: PoseGraphEdges, slot, i, j, T, w, do) -> PoseGraphEdges:
    """Write edges at ``slot`` where ``do`` (others are dropped)."""
    E = edges.capacity
    s = torch.where(do, slot, E)
    return PoseGraphEdges(
        i=_scatter_drop(edges.i, s, i),
        j=_scatter_drop(edges.j, s, j),
        T_meas=_scatter_drop(edges.T_meas, s, T),
        weight=_scatter_drop(edges.weight, s, w),
        ok=_scatter_drop(edges.ok, s, True),
    )


def loop_window_open(pgo: PgoState) -> torch.Tensor:
    """(M,) bool: landmarks whose loop window is currently open."""
    return (pgo.lm_loop_node >= 0) & (pgo.frame < pgo.lm_loop_until)


def pgo_track_frame(
    pgo: PgoState,
    T_wc: torch.Tensor,  # (4, 4) current camera pose estimate (world frame)
    pose_valid: torch.Tensor,  # () bool
    ids: torch.Tensor,  # (D,) detection tag ids
    T_obs: torch.Tensor,  # (D, 4, 4) PnP tag-in-camera transforms
    ok: torch.Tensor,  # (D,) bool
    is_node: torch.Tensor,  # () bool: adopt this frame as a pose-graph node
    kf_slot: torch.Tensor,  # () int32 BA keyframe ring slot this node maps to
    loop_gap: int = 24,
    loop_weight: float = 4.0,
    loop_window: int = 8,
    min_node_sep: int = 3,
    opt_iters: int = 10,
    cooldown: int = 8,
    max_loop_residual: float = 15.0,
    solve: bool = True,
) -> tuple[PgoState, torch.Tensor, torch.Tensor]:
    """Returns (new_state, delta (P, 4, 4), closed ()).

    ``delta[n] = pose_new[n] @ inv(pose_old[n])`` left-corrects any world
    transform last referenced at node slot n; identity where nothing
    changed. With ``solve=False`` no optimization runs (delta is the exact
    identity, ``closed`` is False): call :func:`pgo_solve` later instead."""
    P = pgo.n_nodes_capacity
    M = pgo.lm_node.shape[0]
    dtype, dev = pgo.node_pose.dtype, pgo.node_pose.device
    T_wc = T_wc.to(dtype)
    eye = torch.eye(4, dtype=dtype, device=dev)

    # This frame's observations by landmark slot.
    valid_id = ok & (ids >= 0) & (ids < M)
    slot = torch.where(valid_id, ids.clamp(0, M - 1), M)
    T_by = _scatter_drop(torch.zeros((M, 4, 4), dtype=dtype, device=dev), slot, T_obs.to(dtype))
    seen = _scatter_drop(torch.zeros((M,), dtype=torch.bool, device=dev), slot, True)

    can_add = is_node & pose_valid
    nid = pgo.node_ptr % P
    nslot = torch.where(can_add, nid, P)

    # Ring eviction: adopting into an occupied slot clears every reference
    # to the previous tenant (its edges, landmark and keyframe bindings).
    evict = can_add & _take(pgo.node_active, nid)
    edges = pgo.edges
    edge_hit = (edges.i == nid) | (edges.j == nid)
    edges = replace(edges, ok=edges.ok & ~(edge_hit & evict))

    def _clear(a):
        return torch.where(evict & (a == nid), -1, a).to(torch.int32)

    lm_node0 = _clear(pgo.lm_node)
    lm_ref0 = _clear(pgo.lm_ref)
    lm_loop_node0 = _clear(pgo.lm_loop_node)
    kf_node0 = _clear(pgo.kf_node)

    node_pose = _scatter_drop(pgo.node_pose, nslot, T_wc)
    node_active = _scatter_drop(pgo.node_active, nslot, True)
    node_seq = _scatter_drop(pgo.node_seq, nslot, pgo.node_ptr)

    # Odometry edge from the previous node: the relative transform the front
    # end currently believes.
    prev = (pgo.node_ptr - 1) % P
    odo_do = can_add & (pgo.node_ptr >= 1)
    T_odo = se3_inverse(_take(pgo.node_pose, prev)) @ T_wc
    edges = _edge_scatter(edges, pgo.edge_ptr % edges.capacity, prev, nid, T_odo, 1.0, odo_do)
    eptr = pgo.edge_ptr + odo_do.to(torch.int32)

    # ---- Loop closure: a long-unseen landmark re-observed on a node frame
    # opens a loop window; every node-frame sighting inside it mints an edge
    # against the frozen partner. ``cooldown`` gates only the opening.
    gap = pgo.frame - pgo.lm_frame
    partner_seq = pgo.node_seq[lm_node0.clamp(0, P - 1).long()]
    sep_ok = (pgo.node_ptr - partner_seq) >= min_node_sep
    open_m = (
        seen & (lm_node0 >= 0) & (gap > loop_gap) & can_add & sep_ok
        & ~loop_window_open(pgo)
        & ((pgo.frame - pgo.last_opt) > cooldown)
    )
    lm_loop_node = torch.where(open_m, lm_node0, lm_loop_node0)
    lm_loop_T = torch.where(open_m[:, None, None], pgo.lm_obs_T, pgo.lm_loop_T)
    lm_loop_until = torch.where(open_m, pgo.frame + loop_window, pgo.lm_loop_until).to(torch.int32)

    in_window = (lm_loop_node >= 0) & (pgo.frame < lm_loop_until)
    a = lm_loop_node.clamp(0, P - 1)
    mint = in_window & seen & can_add & (lm_loop_node != nid)
    # T_wl = T_wc_a @ T_a_obs = T_wc_b @ T_b_obs  =>
    # inv(T_wc_a) @ T_wc_b = T_a_obs @ inv(T_b_obs): map-independent.
    T_loop = lm_loop_T @ se3_inverse(T_by)
    # Sanity gate: translation and rotation of each edge's implied
    # correction are gated separately (a wrong planar branch on a distant
    # re-entry sighting would otherwise twist the whole graph).
    E_m = se3_inverse(T_loop) @ se3_inverse(pgo.node_pose[a.long()]) @ T_wc
    t_err = torch.linalg.norm(E_m[:, :3, 3], dim=-1)
    tr = E_m[:, 0, 0] + E_m[:, 1, 1] + E_m[:, 2, 2]
    cos_rot = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    do_m = mint & (t_err < max_loop_residual) & (cos_rot > 0.8776)  # < ~0.5 rad

    # Consecutive ring slots for this frame's mints.
    E_cap = edges.capacity
    k = torch.cumsum(do_m.to(torch.int32), 0) - 1
    slot_e = torch.where(do_m, (eptr + k) % E_cap, E_cap)
    edges = PoseGraphEdges(
        i=_scatter_drop(edges.i, slot_e, a),
        j=_scatter_drop(edges.j, slot_e, nid.expand(M)),
        T_meas=_scatter_drop(edges.T_meas, slot_e, T_loop),
        weight=_scatter_drop(edges.weight, slot_e, loop_weight),
        ok=_scatter_drop(edges.ok, slot_e, True),
    )
    n_mint = do_m.sum(dtype=torch.int32)
    eptr = eptr + n_mint

    # Bookkeeping: lm_frame refreshes on every sighting; lm_node/lm_obs_T
    # only on node frames; lm_ref once, at the first node-frame sighting.
    upd_node = seen & can_add
    lm_node = torch.where(upd_node, nid, lm_node0).to(torch.int32)
    lm_ref = torch.where(upd_node & (lm_ref0 < 0), nid, lm_ref0).to(torch.int32)
    lm_obs_T = torch.where(upd_node[:, None, None], T_by, pgo.lm_obs_T)
    lm_frame = torch.where(seen, pgo.frame, pgo.lm_frame).to(torch.int32)
    # kf_slot is the BA ring slot the keyframe landed in (out of range when
    # none was adopted). A keyframe that did not become a node clears its
    # slot's mapping, so it is never conjugated by a stale node's delta.
    kf_slot = torch.as_tensor(kf_slot, device=dev).clamp(max=kf_node0.shape[0])
    kf_node = _scatter_drop(kf_node0, kf_slot, torch.where(can_add, nid, -1))

    new_state = replace(
        pgo,
        node_pose=node_pose,
        node_active=node_active,
        node_seq=node_seq,
        node_ptr=pgo.node_ptr + can_add.to(torch.int32),
        edges=edges,
        edge_ptr=eptr.to(torch.int32),
        kf_node=kf_node,
        lm_node=lm_node,
        lm_ref=lm_ref,
        lm_obs_T=lm_obs_T,
        lm_frame=lm_frame,
        lm_loop_node=lm_loop_node.to(torch.int32),
        lm_loop_T=lm_loop_T,
        lm_loop_until=lm_loop_until,
        frame=pgo.frame + 1,
        n_loops=pgo.n_loops + n_mint,
    )
    if not solve:
        return new_state, eye.expand(P, 4, 4), torch.zeros((), dtype=torch.bool, device=dev)
    return pgo_solve(new_state, opt_iters=opt_iters)


def pgo_solve(pgo: PgoState, opt_iters: int = 10):
    """Optimize the pose graph iff loop edges were minted since the last
    solve. Returns (new_state, delta (P, 4, 4), closed ()).

    Without pending loops no optimization runs and the correction is the
    EXACT identity, never T @ inv(T), whose float32 residue, applied to the
    map every frame, feeds back through BA with gain > 1 and diverges.

    The gate is decided on the host: one read of ``n_loops > n_solved`` per
    call (once per chunk under the chunk schedule, once per frame under the
    frame schedule). Selecting between a computed solve and the identity
    on the device would be as exact but pay for ``pgo_optimize`` on every
    call, and a skipped branch here returns the state itself."""
    dtype, dev = pgo.node_pose.dtype, pgo.node_pose.device
    P = pgo.n_nodes_capacity
    eye = torch.eye(4, dtype=dtype, device=dev).expand(P, 4, 4)
    pending = pgo.n_loops > pgo.n_solved
    if not bool(pending):
        return pgo, eye, pending
    new_pose = pgo_optimize(pgo.node_pose, pgo.edges, active=pgo.node_active, iters=opt_iters)
    delta = torch.where(pgo.node_active[:, None, None], new_pose @ se3_inverse(pgo.node_pose), eye)
    new_state = replace(pgo, node_pose=new_pose, n_solved=pgo.n_loops, last_opt=pgo.frame)
    return new_state, delta, pending


def apply_node_deltas(delta: torch.Tensor, node_of: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-apply each item's node correction: T'[k] = delta[node_of[k]] @ T[k].

    Items with node_of < 0 (never referenced to a node) are unchanged."""
    P = delta.shape[0]
    d = delta[node_of.clamp(0, P - 1).long()]
    d = torch.where((node_of >= 0)[:, None, None], d, torch.eye(4, dtype=T.dtype, device=T.device))
    return d @ T
