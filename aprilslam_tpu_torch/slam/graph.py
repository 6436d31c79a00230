"""Tag-landmark graph with fixed capacity (port of ``aprilslam_tpu/slam/graph.py``).

Slot i holds tag id i. The reference's chaining rules (anchor at the lowest
id ever seen, direct chaining through the minimum-id visible tag, multi-hop
through its reference with weight += 1, re-observation keeps world) run as
a loop over the frame's (id-sorted) detections, and re-anchoring conjugates
every stored world into the new anchor's frame.

``T`` = camera->tag (PnP output), ``local`` = inv(T), ``world`` maps a tag
frame to the anchor ("world") frame; ``world @ local`` is the camera pose.

``scan_chain_graph`` runs a whole chunk of frames: on the card one launch of
the kernel in ``csrc/chain_graph.cu``, on the CPU the per-frame loop of
``update_graph`` and ``estimate_pose_average``, its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..geometry import project_to_so3, se3_inverse
from ..ops import chain_graph

NO_ANCHOR = 2**30


@dataclass(frozen=True)
class GraphState:
    local: torch.Tensor  # (M, 4, 4) camera->tag at last observation, inverted
    world: torch.Tensor  # (M, 4, 4) tag->world
    weight: torch.Tensor  # (M,) chain depth weight (1 = direct)
    present: torch.Tensor  # (M,) bool: tag has a node
    visible: torch.Tensor  # (M,) bool: tag seen in the latest frame
    updated: torch.Tensor  # (M,) bool: world refreshed in the latest update
    reference: torch.Tensor  # (M,) int32: chaining reference id
    coordinate_id: torch.Tensor  # () int32: anchor tag id (NO_ANCHOR if none)
    estimated_pose: torch.Tensor  # (4, 4) last camera pose estimate
    has_estimate: torch.Tensor  # () bool

    @property
    def capacity(self) -> int:
        return int(self.local.shape[0])


def init_graph(capacity: int = 64, dtype=torch.float32, device=None) -> GraphState:
    """An empty graph on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    eye = torch.eye(4, dtype=dtype, device=device).expand(capacity, 4, 4).clone()
    return GraphState(
        local=eye,
        world=eye.clone(),
        weight=torch.ones((capacity,), dtype=dtype, device=device),
        present=torch.zeros((capacity,), dtype=torch.bool, device=device),
        visible=torch.zeros((capacity,), dtype=torch.bool, device=device),
        updated=torch.zeros((capacity,), dtype=torch.bool, device=device),
        reference=torch.full((capacity,), NO_ANCHOR, dtype=torch.int32, device=device),
        coordinate_id=torch.tensor(NO_ANCHOR, dtype=torch.int32, device=device),
        estimated_pose=torch.eye(4, dtype=dtype, device=device),
        has_estimate=torch.tensor(False, device=device),
    )


def update_graph(
    state: GraphState,
    ids: torch.Tensor,  # (D,) int32, sorted ascending, -1/garbage where not ok
    T_cam_tag: torch.Tensor,  # (D, 4, 4)
    ok: torch.Tensor,  # (D,) bool
) -> GraphState:
    """Process one frame's detections (reference slam_graph.py:29-59)."""
    M = state.capacity
    dev = state.local.device
    T_cam_tag = T_cam_tag.to(state.local.dtype)
    ids = torch.where(ok, ids.to(torch.int32), NO_ANCHOR)
    in_range = ok & (ids >= 0) & (ids < M)
    arangeM = torch.arange(M, device=dev)

    vis = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
    vis[torch.where(in_range, ids.clamp(0, M - 1), M).long()] = True
    vis = vis[:M]
    min_visible = torch.where(in_range, ids, NO_ANCHOR).min()

    # --- anchor update with re-anchoring: when a strictly lower id is seen,
    # chain the new anchor through the min-id previously known visible tag r
    # (using r's detection from THIS frame) and conjugate every stored world
    # into the new frame.
    old_anchor = state.coordinate_id
    a = torch.minimum(old_anchor, min_visible)
    T_a = T_cam_tag[torch.argmax((ids == a).to(torch.int32))]
    known_vis = vis & state.present
    r = torch.where(known_vis, arangeM, NO_ANCHOR).min()
    has_ref = r < NO_ANCHOR
    r_slot = r.clamp(0, M - 1)
    T_r = T_cam_tag[torch.argmax((ids == r).to(torch.int32))]
    eye4 = torch.eye(4, dtype=T_a.dtype, device=dev)
    world_a_old = torch.where(has_ref, state.world[r_slot] @ (se3_inverse(T_r) @ T_a), eye4)
    shifted = torch.einsum("ij,mjk->mik", se3_inverse(world_a_old), state.world)
    shifted = torch.where(state.present[:, None, None], shifted, state.world)
    need_reanchor = (old_anchor < NO_ANCHOR) & (min_visible < old_anchor)
    world = torch.where(need_reanchor, shifted, state.world)
    anchor = torch.where(old_anchor == NO_ANCHOR, min_visible, torch.minimum(old_anchor, min_visible))
    anchor_id = torch.where(min_visible < NO_ANCHOR, anchor, old_anchor).to(torch.int32)

    # --- per-detection insert/update in ascending id order -----------------
    local = state.local.clone()
    world = world.clone()
    weight = state.weight.clone()
    present = state.present.clone()
    updated = state.updated.clone()
    referenc = state.reference.clone()
    ref = min_visible
    ref_slot = ref.clamp(0, M - 1)
    ref_is_anchor = ref == anchor_id
    for d in range(ids.shape[0]):
        tag_id = ids[d]
        T = T_cam_tag[d]
        slot = tag_id.clamp(0, M - 1)
        is_anchor = tag_id == anchor_id
        already = present[slot]
        ref_known = present[ref_slot] & (ref != tag_id)

        w_direct = local[ref_slot] @ T
        w_hop = world[ref_slot] @ w_direct
        keep_w = world[slot]

        case_direct = (~is_anchor) & ref_is_anchor & ref_known
        case_keep = (~is_anchor) & (~case_direct) & already & (referenc[slot] == anchor_id)
        case_hop = (~is_anchor) & (~case_direct) & (~case_keep) & ref_known
        handled = is_anchor | case_direct | case_keep | case_hop

        new_world = torch.where(
            is_anchor, eye4,
            torch.where(case_direct, w_direct, torch.where(case_keep, keep_w, w_hop)))
        new_weight = torch.where(
            is_anchor | case_direct, 1.0,
            torch.where(case_keep, weight[slot], weight[ref_slot] + 1.0))
        new_ref = torch.where(
            is_anchor, tag_id,
            torch.where(case_direct | case_keep, anchor_id, referenc[ref_slot]))

        do = in_range[d] & handled
        local[slot] = torch.where(do, se3_inverse(T), local[slot])
        world[slot] = torch.where(do, new_world, world[slot])
        weight[slot] = torch.where(do, new_weight, weight[slot])
        present[slot] = present[slot] | do
        updated[slot] = torch.where(do, ~case_keep, updated[slot])
        referenc[slot] = torch.where(do, new_ref, referenc[slot])
    return replace(
        state,
        local=local,
        world=world,
        weight=weight,
        present=present,
        updated=updated,
        reference=referenc,
        coordinate_id=anchor_id,
        visible=vis & present,
    )


def estimate_pose_average(state: GraphState, project_rotation: bool = True):
    """The reference ``my_pose`` weighted average (slam.py:36-63).

    Returns (T_avg (4,4), valid, state with estimated_pose cached)."""
    w = torch.where(state.visible, 1.0 / state.weight, 0.0)
    T_cam_world = state.world @ state.local
    T_sum = torch.einsum("m,mij->ij", w, T_cam_world)
    count = w.sum()
    valid = count > 0
    T_avg = T_sum / torch.where(valid, count, 1.0)
    if project_rotation:
        T_avg = torch.cat(
            [torch.cat([project_to_so3(T_avg[:3, :3]), T_avg[:3, 3:]], dim=1), T_avg[3:]], dim=0)
    T_avg = torch.where(valid, T_avg, torch.eye(4, dtype=T_avg.dtype, device=T_avg.device))
    state = replace(state, estimated_pose=T_avg, has_estimate=valid | state.has_estimate)
    return T_avg, valid, state


def average_distance_to_nodes(state: GraphState) -> torch.Tensor:
    """Mean ||translation(local)|| over present nodes (slam.py:65-80)."""
    d = torch.linalg.norm(state.local[:, :3, 3], dim=-1)
    n = state.present.sum()
    return torch.where(state.present, d, 0.0).sum() / torch.clamp(n, min=1)


@dataclass(frozen=True)
class GraphScan:
    """Each frame's results of :func:`scan_chain_graph` over a chunk of B
    frames: the pose average and the graph after the frame."""

    avg_T: torch.Tensor  # (B, 4, 4) estimate_pose_average's T_avg
    valid: torch.Tensor  # (B,) bool
    visible: torch.Tensor  # (B, M) bool
    present: torch.Tensor  # (B, M) bool
    weight: torch.Tensor  # (B, M)
    local: torch.Tensor  # (B, M, 4, 4)
    world: torch.Tensor  # (B, M, 4, 4)
    coordinate_id: torch.Tensor  # (B,) int32
    n_visible: torch.Tensor  # (B,) int64
    n_nodes: torch.Tensor  # (B,) int64
    avg_node_distance: torch.Tensor  # (B,)


def scan_chain_graph(
    state: GraphState,
    ids: torch.Tensor,  # (B, D) int32, each row as update_graph takes it
    T_cam_tag: torch.Tensor,  # (B, D, 4, 4)
    ok: torch.Tensor,  # (B, D) bool
    project_rotation: bool = True,
) -> tuple[GraphState, GraphScan]:
    """``update_graph`` then ``estimate_pose_average`` for each frame of a
    chunk, in order. Returns the state after the last frame (its
    ``estimated_pose`` that frame's average) and every frame's results.

    A CUDA state takes the kernel (one launch, no read back to the host; it
    raises on what the kernel does not take), a CPU state
    :func:`scan_chain_graph_plain`."""
    if ids.dim() != 2 or ids.shape[0] < 1 or tuple(ok.shape) != tuple(ids.shape) \
            or tuple(T_cam_tag.shape) != (*ids.shape, 4, 4):
        raise ValueError(f"a chunk takes ids and ok (B, D) with B >= 1 and T_cam_tag (B, D, 4, 4), got "
                         f"{tuple(ids.shape)}, {tuple(ok.shape)}, {tuple(T_cam_tag.shape)}")
    if state.local.device.type == "cpu":
        return scan_chain_graph_plain(state, ids, T_cam_tag, ok, project_rotation)
    r = chain_graph.chain_graph_scan(
        state.local, state.world, state.weight, state.present, state.updated, state.reference,
        state.coordinate_id, state.has_estimate, ids.contiguous(), T_cam_tag.contiguous(), ok.contiguous())
    T_avg, valid = r["avg_T"], r["valid"]
    if project_rotation:
        T_avg = torch.cat([torch.cat([project_to_so3(T_avg[:, :3, :3]), T_avg[:, :3, 3:]], dim=2),
                           T_avg[:, 3:]], dim=1)
    T_avg = torch.where(valid[:, None, None], T_avg, torch.eye(4, dtype=T_avg.dtype, device=T_avg.device))
    scan = GraphScan(avg_T=T_avg, **{k: r[k] for k in (
        "valid", "visible", "present", "weight", "local", "world", "coordinate_id", "n_visible", "n_nodes",
        "avg_node_distance")})
    last = GraphState(
        local=scan.local[-1], world=scan.world[-1], weight=scan.weight[-1], present=scan.present[-1],
        visible=scan.visible[-1], updated=r["updated"], reference=r["reference"],
        coordinate_id=scan.coordinate_id[-1], estimated_pose=T_avg[-1], has_estimate=r["has_estimate"])
    return last, scan


def scan_chain_graph_plain(state: GraphState, ids, T_cam_tag, ok, project_rotation: bool = True):
    """The kernel's plain version: the per-frame loop it replaces."""
    frames = []
    for b in range(ids.shape[0]):
        state = update_graph(state, ids[b], T_cam_tag[b], ok[b])
        T_avg, valid, state = estimate_pose_average(state, project_rotation=project_rotation)
        frames.append((T_avg, valid, state, average_distance_to_nodes(state)))
    return state, GraphScan(
        avg_T=torch.stack([f[0] for f in frames]),
        valid=torch.stack([f[1] for f in frames]),
        visible=torch.stack([f[2].visible for f in frames]),
        present=torch.stack([f[2].present for f in frames]),
        weight=torch.stack([f[2].weight for f in frames]),
        local=torch.stack([f[2].local for f in frames]),
        world=torch.stack([f[2].world for f in frames]),
        coordinate_id=torch.stack([f[2].coordinate_id for f in frames]),
        n_visible=torch.stack([f[2].visible.sum() for f in frames]),
        n_nodes=torch.stack([f[2].present.sum() for f in frames]),
        avg_node_distance=torch.stack([f[3] for f in frames]),
    )
