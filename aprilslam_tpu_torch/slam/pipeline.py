"""The full SLAM step: frames -> detections -> poses -> graph -> BA -> estimate
(port of ``aprilslam_tpu/slam/pipeline.py``, the ``estimator="ba"``,
``ba_schedule="chunk"`` configuration).

Detection + PnP run batched over the whole frame chunk; a batched dual-init
localization against the previous chunk's map seeds each frame; a loop over
the chunk's frames does the sequential graph/keyframe bookkeeping; one LM-BA
solve refines the map at the chunk boundary; then every frame is
re-localized against the final map and its pose observability evaluated,
batched over the chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ..detect import DetectorParams, detect_fn
from ..device import resolve_device
from ..families import TagFamily
from ..geometry import PinholeCamera, se3_inverse
from ..pose import poses_from_detections
from .ba import BAState, ba_add_frame, ba_init, ba_optimize
from .graph import GraphState, average_distance_to_nodes, estimate_pose_average, init_graph, update_graph
from .localize import joint_camera_pose, pose_observability

BIG = 2**30


@dataclass(frozen=True)
class SlamOutputs:
    poses: torch.Tensor  # (B, 4, 4) camera pose in world (anchor tag) frame
    valid: torch.Tensor  # (B,) bool
    reproj_rms: torch.Tensor  # (B,) localization reprojection rms (px)
    # Smallest singular value of the frame's 6-dof localization Jacobian
    # against the final map, over loc_used; 0 when no mapped landmark was used.
    pose_obs: torch.Tensor  # (B,) float32
    loc_used: torch.Tensor  # (B, M) bool: landmarks the reported localization used
    n_visible: torch.Tensor  # (B,) visible mapped tags
    n_nodes: torch.Tensor  # (B,) graph size after the frame
    avg_node_distance: torch.Tensor  # (B,)
    coord_id: torch.Tensor  # (B,) int32 tag frame the pose is expressed in
    loop_closures: torch.Tensor  # (B,) int32 (0: the pose graph is not ported)
    node_visible: torch.Tensor  # (B, M) bool
    node_weight: torch.Tensor  # (B, M) chain depth
    node_local: torch.Tensor  # (B, M, 4, 4)
    node_world: torch.Tensor  # (B, M, 4, 4)
    det_ids: torch.Tensor  # (B, D) int32, -1 padding
    det_corners: torch.Tensor  # (B, D, 4, 2) full-res pixels
    det_ok: torch.Tensor  # (B, D) bool PnP-ok


def _where_state(cond: torch.Tensor, a, b):
    """Select every field of two dataclass states by a () bool."""
    return type(a)(**{
        f.name: torch.where(cond, getattr(a, f.name), getattr(b, f.name)) for f in fields(a)
    })


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, section 1: {item})")


def scatter_frame(ids, ok, corners, M: int):
    """Per-frame detections -> per-slot corners (..., M, 4, 2) and seen mask (..., M)."""
    okm = ok & (ids >= 0) & (ids < M)
    slot = torch.where(okm, ids.clamp(0, M - 1), M).long()
    onehot = torch.nn.functional.one_hot(slot, M + 1)[..., :M].to(corners.dtype)  # (..., D, M)
    corn_m = torch.einsum("...dm,...dcx->...mcx", onehot, torch.nan_to_num(corners))
    return corn_m, onehot.sum(-2) > 0


def build_slam_step(
    family: str | TagFamily,
    camera: PinholeCamera,
    tag_size: float,
    detector_params: DetectorParams | None = None,
    estimator: str = "ba",
    graph_capacity: int = 64,
    pnp_iters: int = 8,
    joint_iters: int = 6,
    ba_keyframes: int = 16,
    ba_obs: int = 512,
    ba_iters_per_frame: int = 3,
    ba_schedule: str = "chunk",
    ba_chunk_iters: int | None = None,
    init_joint_iters: int | None = None,
    dist_coeffs=None,
    pgo: bool = False,
    kf_every: int = 0,
    device: str | torch.device | None = None,
):
    """Returns (slam_step, init_state) where
    ``slam_step(state, frames) -> (state, SlamOutputs)`` processes a
    (B, H, W) chunk of frames sequentially w.r.t. the state (GraphState,
    BAState).

    Only the chunk-scheduled bundle-adjustment configuration is ported; the
    defaults select it (the JAX package defaults to estimator="joint",
    ba_schedule="frame"). ``init_joint_iters`` bounds the depth of the
    pre-BA seeding localization; the reported pose comes from the post-BA
    re-localization at ``joint_iters``.
    """
    if estimator != "ba":
        raise _unported(f"estimator={estimator!r}", "off-path estimators and schedule")
    if ba_schedule != "chunk":
        raise _unported(f"ba_schedule={ba_schedule!r}", "off-path estimators and schedule")
    if dist_coeffs is not None:
        raise _unported("dist_coeffs", "off-path estimators and schedule")
    if pgo:
        raise _unported("pgo=True", "config-2 backend")
    dev = resolve_device(device)
    detect = detect_fn(family, detector_params, device=dev)
    K = torch.as_tensor(camera.matrix, device=dev)
    if init_joint_iters is None:
        init_joint_iters = joint_iters
    eye4 = torch.eye(4, device=dev)

    def pre_localize(ba: BAState, ids, ok, seed, corners, T, T_alt):
        """Dual-init seeding localization of every frame of the chunk against
        the previous chunk's map, batched over frames."""
        Ml = ba.n_landmarks
        corn_m, seen = scatter_frame(ids, ok, corners, Ml)
        use = seen & ba.lm_active
        idsc = ids.clamp(0, Ml - 1).long()
        valid_id = (ids >= 0) & (ids < Ml)
        mappable = ba.lm_active[idsc]
        cand = ok & seed & valid_id & mappable
        cand_loc = ok & valid_id & mappable
        c_idx = torch.argmin(torch.where(cand, ids, torch.where(cand_loc, ids + Ml, BIG)), dim=-1)
        c_id = torch.gather(idsc, 1, c_idx[:, None])[:, 0]
        T_lm = torch.where(ba.lm_active[c_id][:, None, None], ba.lm_pose[c_id], eye4)
        Tc = T[torch.arange(T.shape[0], device=dev), c_idx]
        Tc_alt = T_alt[torch.arange(T.shape[0], device=dev), c_idx]
        T0 = torch.stack([T_lm @ se3_inverse(Tc), T_lm @ se3_inverse(Tc_alt)], dim=1)  # (B, 2, 4, 4)
        T_ab, r_ab = joint_camera_pose(
            ba.lm_pose, use[:, None], corn_m[:, None], K, tag_size, T0, iters=init_joint_iters)
        pick = r_ab[:, 0] <= r_ab[:, 1]
        return (
            torch.where(pick[:, None, None], T_ab[:, 0], T_ab[:, 1]),
            torch.where(pick, r_ab[:, 0], r_ab[:, 1]).to(torch.float32),
            use.any(-1),
        )

    def per_frame(graph: GraphState, ba: BAState, ids, T, T_alt, ok, seed, corners, T_pre, r_pre, use_pre):
        """Sequential bookkeeping for one frame: chaining graph update, keyframe
        policy and insertion, and the in-scan pose (refined after the chunk)."""
        graph = update_graph(graph, ids, T, ok & seed)
        avg_T, avg_valid, graph = estimate_pose_average(graph, project_rotation=True)
        Ml = ba.n_landmarks
        corn_m, seen = scatter_frame(ids, ok, corners, Ml)
        idsc = ids.clamp(0, Ml - 1).long()
        valid_id = (ids >= 0) & (ids < Ml)
        anchor_eff = torch.where(
            ba.anchor >= 0, ba.anchor, torch.where(ok & seed & valid_id, ids, BIG).min())
        mappable = ba.lm_active[idsc] | (ids == anchor_eff)
        cand = ok & seed & valid_id & mappable
        cand_loc = ok & valid_id & mappable
        has_cand = cand.any()
        c_idx = torch.argmin(torch.where(cand, ids, torch.where(cand_loc, ids + Ml, BIG)))
        c_id = idsc[c_idx]
        T_lm = torch.where(ba.lm_active[c_id], ba.lm_pose[c_id], eye4)
        T_wc0 = T_lm @ se3_inverse(T[c_idx])
        # Frames whose visible tags were all seeded this chunk fall back to the
        # PnP chain through the in-scan candidate (the bootstrap path).
        T_init = torch.where(use_pre, T_pre, T_wc0)
        r_loc = torch.where(use_pre, r_pre, 0.0)

        # Keyframe policy: adopt the frame while the window has free slots,
        # when it can seed a tag the map lacks, or on the kf_every cadence —
        # only if its own pose is reliably anchored (has_cand).
        seed_new = ok & seed & valid_id & ~ba.lm_active[idsc]
        window_free = ba.kf_active.sum() < ba.n_keyframes
        adopt = seed_new.any() | window_free
        if kf_every > 0:
            adopt = adopt | (ba.frame_count % kf_every == 0)
        is_kf = has_cand & adopt
        ba_kf = ba_add_frame(ba, ids, corners, ok, T_init, T, seed_ok=ok & seed)
        ba = _where_state(is_kf, ba_kf, ba)
        ba = replace(ba, frame_count=ba.frame_count + 1)

        use = seen & ba.lm_active
        # Report in the graph's coordinate frame (lowest id ever seen); until
        # that tag is an active landmark, fall back to the chain average.
        coord = graph.coordinate_id
        c_slot = coord.clamp(0, Ml - 1).long()
        frame_ok = (coord >= 0) & (coord < Ml) & ba.lm_active[c_slot]
        T_wa = torch.where(frame_ok, ba.lm_pose[c_slot], eye4)
        ba_valid = use.any() & (cand_loc.any() | avg_valid) & frame_ok
        pose = torch.where(ba_valid, se3_inverse(T_wa) @ T_init, avg_T)
        graph = replace(graph, estimated_pose=pose)
        out = dict(
            poses=pose,
            valid=avg_valid,
            reproj_rms=r_loc,
            loc_used=use,
            n_visible=graph.visible.sum(),
            n_nodes=graph.present.sum(),
            avg_node_distance=average_distance_to_nodes(graph),
            coord_id=graph.coordinate_id,
            node_visible=graph.visible,
            node_weight=graph.weight,
            node_local=graph.local,
            node_world=graph.world,
        )
        return graph, ba, out

    def reloc(ba: BAState, ids, ok, corners, poses, coord, valid, rms):
        """Re-localize every frame against the FINAL map, batched."""
        Ml = ba.n_landmarks
        corn_m, seen = scatter_frame(ids, ok, corners, Ml)
        use = seen & ba.lm_active
        c_slot = coord.clamp(0, Ml - 1).long()
        frame_ok = (coord >= 0) & (coord < Ml) & ba.lm_active[c_slot]
        T_wa = torch.where(frame_ok[:, None, None], ba.lm_pose[c_slot], eye4)
        T_w, rms_new = joint_camera_pose(ba.lm_pose, use, corn_m, K, tag_size, T_wa @ poses,
                                         iters=joint_iters)
        keep = valid & frame_ok & use.any(-1)
        return (
            torch.where(keep[:, None, None], se3_inverse(T_wa) @ T_w, poses),
            torch.where(keep, rms_new.to(rms.dtype), rms),
            use, keep, frame_ok, T_wa,
        )

    def slam_step(state, frames):
        graph, ba = state
        frames = torch.as_tensor(frames, device=dev)
        det = detect(frames)
        T_all, ok_all, _rms, seed_all, T_alt_all = poses_from_detections(
            det, K, tag_size, iters=pnp_iters)
        ids = det.ids
        T_pre, r_pre, use_pre = pre_localize(ba, ids, ok_all, seed_all, det.corners, T_all, T_alt_all)

        outs = []
        for b in range(frames.shape[0]):
            graph, ba, o = per_frame(graph, ba, ids[b], T_all[b], T_alt_all[b], ok_all[b],
                                     seed_all[b], det.corners[b], T_pre[b], r_pre[b], use_pre[b])
            outs.append(o)
        o = {k: torch.stack([x[k] for x in outs]) for k in outs[0]}

        B = frames.shape[0]
        chunk_iters = ba_chunk_iters if ba_chunk_iters is not None else min(B * ba_iters_per_frame, 16)
        if chunk_iters > 0:
            ba = ba_optimize(ba, K, tag_size, iters=chunk_iters)

        poses, rms, use_full, keep, frame_ok, T_wa = reloc(
            ba, ids, ok_all, det.corners, o["poses"], o["coord_id"], o["valid"], o["reproj_rms"])
        # Observability over the landmark set the reported pose was solved with.
        use_b = torch.where(keep[:, None], use_full, o["loc_used"])
        s = pose_observability(ba.lm_pose, use_b, K, tag_size, T_wa @ poses)
        pose_obs = torch.where(o["valid"] & frame_ok & use_b.any(-1), s, 0.0)
        outs = SlamOutputs(
            poses=poses,
            valid=o["valid"],
            reproj_rms=rms,
            pose_obs=pose_obs,
            loc_used=o["loc_used"],
            n_visible=o["n_visible"],
            n_nodes=o["n_nodes"],
            avg_node_distance=o["avg_node_distance"],
            coord_id=o["coord_id"],
            loop_closures=torch.zeros((B,), dtype=torch.int32, device=dev),
            node_visible=o["node_visible"],
            node_weight=o["node_weight"],
            node_local=o["node_local"],
            node_world=o["node_world"],
            det_ids=ids,
            det_corners=det.corners,
            det_ok=ok_all,
        )
        return (graph, ba), outs

    def init():
        return (init_graph(graph_capacity, device=dev),
                ba_init(ba_keyframes, graph_capacity, ba_obs, device=dev))

    return slam_step, init


class SlamSystem:
    """Stateful wrapper: consumes whole frame chunks per ``process`` call.

    Keyword arguments are those of :func:`build_slam_step`; ``device=None``
    means the CUDA device."""

    def __init__(
        self,
        camera: PinholeCamera,
        family: str | TagFamily = "tagStandard41h12",
        tag_size: float = 10.0,
        estimator: str = "ba",
        detector_params: DetectorParams | None = None,
        graph_capacity: int = 64,
        ba_schedule: str = "chunk",
        device: str | torch.device | None = None,
        **step_kwargs,
    ):
        self._step, self._init = build_slam_step(
            family, camera, tag_size,
            detector_params=detector_params,
            estimator=estimator,
            graph_capacity=graph_capacity,
            ba_schedule=ba_schedule,
            device=device,
            **step_kwargs,
        )
        self.state = self._init()

    def process(self, frames) -> SlamOutputs:
        self.state, outs = self._step(self.state, frames)
        return outs

    @property
    def graph_state(self) -> GraphState:
        return self.state[0]

    @property
    def ba_state(self) -> BAState:
        return self.state[1]

    @property
    def coordinate_id(self) -> int:
        return int(self.graph_state.coordinate_id)

    def reset(self):
        self.state = self._init()
