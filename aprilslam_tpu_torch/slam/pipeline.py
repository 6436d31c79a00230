"""The full SLAM step: frames -> detections -> poses -> graph -> estimate
(port of ``aprilslam_tpu/slam/pipeline.py``).

Detection + PnP run batched over the whole frame chunk; a loop over the
chunk's frames does the sequential graph, keyframe and pose-graph
bookkeeping. Under ``estimator="ba"`` with ``ba_schedule="chunk"`` a batched
dual-init localization against the previous chunk's map seeds each frame,
one LM-BA solve refines the map at the chunk boundary, and every frame is
re-localized against the final map; under ``ba_schedule="frame"`` the
localization and the BA solve run inside the loop. Pose observability is
evaluated against the final map, batched over the chunk.

The step is its back end applied to its front end (detection and PnP),
which works frame by frame: ``parallel/sequences.py`` runs the front end
once over every sequence's frames (``_step_halves``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Literal

import numpy as np
import torch

from ..detect import DetectorParams, detect_fn
from ..device import resolve_device
from ..families import TagFamily
from ..geometry import PinholeCamera, se3_inverse, undistort_pixels
from ..pose import poses_from_detections
from ..utils.profiling import span
from .ba import BAState, _take, ba_add_frame, ba_init, ba_optimize
from .graph import GraphState, average_distance_to_nodes, estimate_pose_average, init_graph, update_graph
from .localize import joint_camera_pose, pose_observability
from .loop import apply_node_deltas, loop_window_open, pgo_init, pgo_solve, pgo_track_frame
from .taggraph import TagGraphState, taggraph_accumulate, taggraph_init, taggraph_solve, taggraph_support

Estimator = Literal["reference_chain", "chain_avg", "joint", "ba"]
ESTIMATORS = ("reference_chain", "chain_avg", "joint", "ba")
BIG = 2**30


@dataclass(frozen=True)
class SlamOutputs:
    poses: torch.Tensor  # (B, 4, 4) camera pose in world (anchor tag) frame
    valid: torch.Tensor  # (B,) bool
    reproj_rms: torch.Tensor  # (B,) localization reprojection rms (px); 0 for chain estimators
    # Smallest singular value of the frame's 6-dof localization Jacobian
    # against the final map, over loc_used; 0 when no mapped landmark was used.
    pose_obs: torch.Tensor  # (B,) float32
    loc_used: torch.Tensor  # (B, M) bool: landmarks the reported localization used
    n_visible: torch.Tensor  # (B,) visible mapped tags
    n_nodes: torch.Tensor  # (B,) graph size after the frame
    avg_node_distance: torch.Tensor  # (B,)
    coord_id: torch.Tensor  # (B,) int32 tag frame the pose is expressed in
    loop_closures: torch.Tensor  # (B,) int32 cumulative loop edges (0 if pgo is off)
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


def scatter_frame(ids, ok, corners, M: int):
    """Per-frame detections -> per-slot corners (..., M, 4, 2) and seen mask (..., M)."""
    okm = ok & (ids >= 0) & (ids < M)
    slot = torch.where(okm, ids.clamp(0, M - 1), M).long()
    onehot = torch.nn.functional.one_hot(slot, M + 1)[..., :M].to(corners.dtype)  # (..., D, M)
    corn_m = torch.einsum("...dm,...dcx->...mcx", onehot, torch.nan_to_num(corners))
    return corn_m, onehot.sum(-2) > 0


def apply_taggraph(tg: TagGraphState, ba: BAState, due: torch.Tensor, iters: int) -> BAState:
    """Refine the landmark map against the landmark pose graph and move each
    keyframe rigidly with its dominant observed tag's correction, so its
    reprojection residuals stay and the next BA pass does not pull the tags
    back.

    A tag is movable once the graph holds at least 24 pair sightings of it;
    the rest are held and anchor the solve. The whole solve is gated by
    ``due`` (new loop edges, or the taggraph_every cadence), decided on the
    host with one read; the skipped branch returns ``ba`` itself."""
    supp = taggraph_support(tg)
    movable = ba.lm_active & (supp >= 24.0)
    hold = ba.lm_active & ~movable
    if not bool(due & movable.any() & (ba.anchor >= 0)):
        return ba
    with span("slam.taggraph.solve"):
        Ml, Kf = ba.n_landmarks, ba.n_keyframes
        eye4 = torch.eye(4, dtype=ba.lm_pose.dtype, device=ba.lm_pose.device)
        new_lm, moved = taggraph_solve(
            tg, ba.lm_pose, ba.lm_active, ba.anchor, hold=hold, iters=iters,
            max_edges=min(128, max(16, (tg.capacity * tg.capacity) // 4)))
        delta_lm = torch.where((moved & movable)[:, None, None], new_lm @ se3_inverse(ba.lm_pose), eye4)
        # Dominant moved tag per keyframe by live observation count.
        onehot_kf = torch.nn.functional.one_hot(ba.obs_kf.long(), Kf).to(torch.float32)
        onehot_lm = torch.nn.functional.one_hot(ba.obs_lm.long(), Ml).to(torch.float32)
        counts = onehot_kf.T @ (onehot_lm * ba.obs_ok.to(torch.float32)[:, None])  # (Kf, Ml)
        cm = counts * movable.to(torch.float32)[None, :]
        m_star = torch.argmax(cm, dim=1)
        has = (cm.max(dim=1).values > 0) & ba.kf_active & moved
        kf_delta = torch.where(has[:, None, None], delta_lm[m_star], eye4)
        return replace(ba, lm_pose=new_lm, kf_pose=kf_delta @ ba.kf_pose)


def build_slam_step(
    family: str | TagFamily,
    camera: PinholeCamera,
    tag_size: float,
    detector_params: DetectorParams | None = None,
    estimator: Estimator = "joint",
    graph_capacity: int = 64,
    pnp_iters: int = 8,
    joint_iters: int = 6,
    ba_keyframes: int = 16,
    ba_obs: int = 512,
    ba_iters_per_frame: int = 3,
    ba_schedule: Literal["frame", "chunk"] = "frame",
    ba_chunk_iters: int | None = None,
    init_joint_iters: int | None = None,
    dist_coeffs=None,
    pgo: bool = False,
    pgo_nodes: int = 64,
    pgo_edges: int = 192,
    pgo_loop_gap: int = 24,
    kf_every: int = 0,
    taggraph_every: int = 1,
    pgo_opt_iters: int | None = None,
    taggraph_iters: int | None = None,
    device: str | torch.device | None = None,
):
    """Returns (slam_step, init_state) where
    ``slam_step(state, frames) -> (state, SlamOutputs)`` processes a
    (B, H, W) chunk of frames sequentially w.r.t. the state.

    The state is a ``GraphState`` for the chain estimators
    (``reference_chain``, ``chain_avg``) and ``joint``; ``(GraphState,
    BAState)`` for ``estimator="ba"``; and ``(GraphState, BAState, PgoState,
    TagGraphState)`` for ``estimator="ba"`` with ``pgo=True``.

    * ``ba_schedule="frame"`` runs the dual-init localization and
      ``ba_iters_per_frame`` LM-BA iterations inside the per-frame loop;
      ``"chunk"`` localizes the chunk batched against the previous chunk's
      map, solves BA once at the chunk boundary, and re-localizes every
      frame against the final map.
    * ``init_joint_iters`` bounds the depth of the pre-BA seeding
      localization; the reported pose comes from the post-BA one at
      ``joint_iters``.
    * ``dist_coeffs`` (OpenCV k1, k2, p1, p2[, k3]) undistorts the detected
      corners once, at the detect -> geometry boundary.
    * ``pgo=True`` (with ``estimator="ba"``) runs two pose graphs beside BA:
      the camera pose graph (``slam/loop.py``: nodes and loop edges minted
      per frame, solved inline under the frame schedule and at the chunk
      boundary under the chunk schedule) and the landmark pose graph
      (``slam/taggraph.py``: co-visible pairs accumulated per chunk, the map
      refined on the ``taggraph_every`` cadence or when loop edges are new).
      ``pgo_opt_iters``/``taggraph_iters`` default to 10/6 under the frame
      schedule and to 4/3 under the chunk schedule, which re-solves warm.
    * ``device=None`` means the CUDA device.
    """
    if estimator not in ESTIMATORS:
        raise ValueError(f"estimator must be one of {ESTIMATORS}, not {estimator!r}")
    if ba_schedule not in ("frame", "chunk"):
        raise ValueError(f"ba_schedule must be 'frame' or 'chunk', not {ba_schedule!r}")
    dev = resolve_device(device)
    detect = detect_fn(family, detector_params, device=dev)
    K = torch.as_tensor(camera.matrix, device=dev)
    use_ba = estimator == "ba"
    use_pgo = pgo and use_ba
    ba_per_frame = ba_schedule == "frame"
    chunk_ba = use_ba and not ba_per_frame
    gate_seeding = estimator in ("joint", "ba")
    if init_joint_iters is None:
        init_joint_iters = joint_iters
    if pgo_opt_iters is None:
        pgo_opt_iters = 10 if ba_per_frame else 4
    if taggraph_iters is None:
        taggraph_iters = 6 if ba_per_frame else 3
    dist = None if dist_coeffs is None else torch.as_tensor(
        np.asarray(dist_coeffs, dtype=np.float32), device=dev)
    eye4 = torch.eye(4, device=dev)
    every_chunk = torch.ones((), dtype=torch.bool, device=dev)

    def localize(lm_pose, umask, corn_m, T_a, T_b, iters):
        """Dual-init localization: with a single visible tag the GN inherits
        the planar branch of its init, so try both PnP branches and keep the
        better fit."""
        T_ab, r_ab = joint_camera_pose(lm_pose, umask[None], corn_m[None], K, tag_size,
                                       torch.stack([T_a, T_b]), iters=iters)
        pick = r_ab[0] <= r_ab[1]
        return torch.where(pick, T_ab[0], T_ab[1]), torch.where(pick, r_ab[0], r_ab[1])

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

    def per_frame(graph: GraphState, ba, pgo_s, ids, T, T_alt, ok, seed, corners, pre):
        """Sequential bookkeeping for one frame: chaining graph update, the
        estimator's pose, and under "ba" the keyframe policy and insertion
        and the camera pose graph. Nothing here reads a value back to the
        host beyond what ``update_graph`` does."""
        with span("slam.scan.graph"):
            graph = update_graph(graph, ids, T, ok & seed if gate_seeding else ok)
            avg_T, avg_valid, graph = estimate_pose_average(
                graph, project_rotation=estimator != "reference_chain")
        rms = torch.zeros((), dtype=torch.float32, device=dev)
        pose = avg_T
        # Landmarks the reported pose is solved with: the chain estimators
        # average over the visible nodes.
        loc_used = graph.visible
        if estimator == "joint":
            corn_m, seen = scatter_frame(ids, ok, corners, graph.capacity)
            loc_used = seen & graph.present
            T_wc, rms = joint_camera_pose(graph.world, loc_used, corn_m, K, tag_size, avg_T,
                                          iters=joint_iters)
            pose = torch.where(avg_valid, T_wc, avg_T)
            graph = replace(graph, estimated_pose=pose)
        elif use_ba:
            # The camera pose used for keyframe insertion is derived from a
            # branch-reliable detection of an active landmark (or the anchor
            # itself on the first frame), then jointly refined.
            Ml = ba.n_landmarks
            corn_m, seen = scatter_frame(ids, ok, corners, Ml)
            use = seen & ba.lm_active
            idsc = ids.clamp(0, Ml - 1).long()
            valid_id = (ids >= 0) & (ids < Ml)
            active_d = ba.lm_active[idsc]
            anchor_eff = torch.where(
                ba.anchor >= 0, ba.anchor, torch.where(ok & seed & valid_id, ids, BIG).min())
            mappable = active_d | (ids == anchor_eff)
            cand = ok & seed & valid_id & mappable
            cand_loc = ok & valid_id & mappable
            has_cand = cand.any()
            # Prefer a branch-reliable candidate; fall back to any ok one.
            c_idx = torch.argmin(torch.where(cand, ids, torch.where(cand_loc, ids + Ml, BIG)))
            c_id = _take(idsc, c_idx)
            T_lm = torch.where(_take(ba.lm_active, c_id), _take(ba.lm_pose, c_id), eye4)
            T_wc0 = T_lm @ se3_inverse(_take(T, c_idx))
            if ba_per_frame:
                T_wc0b = T_lm @ se3_inverse(_take(T_alt, c_idx))
                T_loc, r_loc = localize(ba.lm_pose, use, corn_m, T_wc0, T_wc0b, init_joint_iters)
                T_init = torch.where(use.any(), T_loc, T_wc0)
            else:
                # The seeding localization ran batched before the loop; frames
                # whose visible tags were all seeded this chunk fall back to
                # the PnP chain through the in-loop candidate (the bootstrap).
                T_pre, r_pre, use_pre = pre
                T_init = torch.where(use_pre, T_pre, T_wc0)
                r_loc = torch.where(use_pre, r_pre, 0.0)

            # Keyframe policy: adopt the frame while the window has free
            # slots, when it can seed a tag the map lacks, or on the kf_every
            # cadence (of the persistent frame counter), and only if its own
            # pose is reliably anchored (has_cand).
            with span("slam.scan.keyframe"):
                seed_new = ok & seed & valid_id & ~active_d
                adopt = seed_new.any() | (ba.kf_active.sum() < ba.n_keyframes)
                if kf_every > 0:
                    adopt = adopt | (ba.frame_count % kf_every == 0)
                is_kf = has_cand & adopt
                kf_slot = ba.kf_ptr % ba.n_keyframes  # the slot the keyframe lands in
                ba_kf = ba_add_frame(ba, ids, corners, ok, T_init, T, seed_ok=ok & seed)
                if ba_per_frame:
                    ba_kf = ba_optimize(ba_kf, K, tag_size, iters=ba_iters_per_frame)
                ba = _where_state(is_kf, ba_kf, ba)
                ba = replace(ba, frame_count=ba.frame_count + 1)

            use = seen & ba.lm_active
            loc_used = use
            if ba_per_frame:
                pose_w, rms = localize(ba.lm_pose, use, corn_m, T_init, T_wc0b, joint_iters)
            else:
                # The reported pose comes from the re-localization after the
                # chunk: reuse the seeding localization here.
                pose_w, rms = T_init, r_loc

            if use_pgo:
                # A re-observation of a long-unseen landmark (or one inside an
                # open loop window) becomes a node even when the keyframe
                # policy would skip the frame, so the loop edge has a node to
                # attach to. Loop and odometry measurements come only from
                # branch-reliable PnP (ok & seed).
                with span("slam.scan.pgo"):
                    maybe_loop = (seen & (
                        ((pgo_s.lm_node >= 0) & ((pgo_s.frame - pgo_s.lm_frame) > pgo_loop_gap))
                        | loop_window_open(pgo_s))).any()
                    is_node = is_kf | (maybe_loop & use.any())
                    pgo_s, delta, closed = pgo_track_frame(
                        pgo_s, pose_w, use.any(), ids, T, ok & seed, is_node,
                        torch.where(is_kf, kf_slot, ba.n_keyframes),
                        loop_gap=pgo_loop_gap, solve=ba_per_frame, opt_iters=pgo_opt_iters)
                    if ba_per_frame:
                        # Without a solve, delta is the exact identity and the
                        # products below return their inputs.
                        ba = replace(
                            ba,
                            lm_pose=apply_node_deltas(delta, pgo_s.lm_ref, ba.lm_pose),
                            kf_pose=apply_node_deltas(delta, pgo_s.kf_node, ba.kf_pose),
                        )
                        last_node = (pgo_s.node_ptr - 1) % pgo_s.n_nodes_capacity
                        pose_w = torch.where(closed, _take(delta, last_node) @ pose_w, pose_w)

            # Report in the graph's coordinate frame (lowest id ever seen);
            # until that tag is an active landmark, fall back to the chain
            # average, which always lives there.
            coord = graph.coordinate_id
            c_slot = coord.clamp(0, Ml - 1)
            frame_ok = (coord >= 0) & (coord < Ml) & _take(ba.lm_active, c_slot)
            T_wa = torch.where(frame_ok, _take(ba.lm_pose, c_slot), eye4)
            ba_valid = use.any() & (cand_loc.any() | avg_valid) & frame_ok
            pose = torch.where(ba_valid, se3_inverse(T_wa) @ pose_w, avg_T)
            graph = replace(graph, estimated_pose=pose)

        out = dict(
            poses=pose,
            valid=avg_valid,
            reproj_rms=rms,
            loc_used=loc_used,
            n_visible=graph.visible.sum(),
            n_nodes=graph.present.sum(),
            avg_node_distance=average_distance_to_nodes(graph),
            coord_id=graph.coordinate_id,
            loop_closures=(pgo_s.n_loops if use_pgo else torch.zeros((), dtype=torch.int32, device=dev)),
            node_visible=graph.visible,
            node_weight=graph.weight,
            node_local=graph.local,
            node_world=graph.world,
        )
        return graph, ba, pgo_s, out

    def taggraph_due(ba: BAState, B: int) -> torch.Tensor:
        if taggraph_every > 1:
            return (ba.frame_count // B) % taggraph_every == 0
        return every_chunk

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
            use, keep,
        )

    def front(frames):
        """Detection, undistortion and PnP of (N, H, W[, 3]) frames. Every
        output is per frame, so N may hold several sequences' chunks.
        Returns (det, T, ok, seed, T_alt)."""
        with span("slam.front"):
            with span("slam.detect"):
                det = detect(torch.as_tensor(frames, device=dev))
            with span("slam.pnp"):
                if dist is not None:
                    det = replace(det, corners=undistort_pixels(det.corners, K, dist))
                T_all, ok_all, _rms, seed_all, T_alt_all = poses_from_detections(
                    det, K, tag_size, iters=pnp_iters)
            return det, T_all, ok_all, seed_all, T_alt_all

    def back(state, front_out):
        """The chunk's back end from ``front``'s outputs for its B frames."""
        with span("slam.back"):
            return chunk_back(state, front_out)

    def chunk_back(state, front_out):
        pgo_s = tg = None
        if use_pgo:
            graph, ba, pgo_s, tg = state
        elif use_ba:
            graph, ba = state
        else:
            graph, ba = state, None
        det, T_all, ok_all, seed_all, T_alt_all = front_out
        ids = det.ids
        B = ids.shape[0]
        pre = None
        if chunk_ba:
            with span("slam.pre_localize"):
                pre = pre_localize(ba, ids, ok_all, seed_all, det.corners, T_all, T_alt_all)

        with span("slam.scan"):
            outs = []
            for b in range(B):
                graph, ba, pgo_s, o = per_frame(
                    graph, ba, pgo_s, ids[b], T_all[b], T_alt_all[b], ok_all[b], seed_all[b],
                    det.corners[b], None if pre is None else tuple(x[b] for x in pre))
                outs.append(o)
            o = {k: torch.stack([x[k] for x in outs]) for k in outs[0]}
        poses, rms, loc_used = o["poses"], o["reproj_rms"], o["loc_used"]

        if chunk_ba:
            # Chunk-level mapping pass with the per-frame schedule's budget.
            chunk_iters = ba_chunk_iters if ba_chunk_iters is not None else min(B * ba_iters_per_frame, 16)
            if chunk_iters > 0:
                with span("slam.ba"):
                    ba = ba_optimize(ba, K, tag_size, iters=chunk_iters)
            if use_pgo:
                # The camera pose-graph solve hoisted to the chunk boundary:
                # every loop edge minted during the chunk in one solve, then
                # the keyframe window conjugated by the node corrections. It
                # runs only when loop edges are pending: one host read per
                # chunk decides, and the skipped branch leaves both states.
                pending = pgo_s.n_loops > pgo_s.n_solved
                if bool(pending):
                    with span("slam.pgo_solve"):
                        pgo_s, delta, _closed = pgo_solve(pgo_s, opt_iters=pgo_opt_iters)
                        ba = replace(ba, kf_pose=apply_node_deltas(delta, pgo_s.kf_node, ba.kf_pose))
                # The landmark pose graph accumulates every chunk (it is the
                # evidence) and refines the map when due.
                with span("slam.taggraph"):
                    tg = taggraph_accumulate(tg, ids, T_all, ok_all & seed_all)
                    ba = apply_taggraph(tg, ba, pending | taggraph_due(ba, B), taggraph_iters)
            with span("slam.reloc"):
                poses, rms, use_full, keep = reloc(
                    ba, ids, ok_all, det.corners, poses, o["coord_id"], o["valid"], rms)
            # Observability over the landmark set the reported pose was solved with.
            loc_obs = torch.where(keep[:, None], use_full, loc_used)
        else:
            if use_pgo:
                # Frame schedule: the camera pose-graph solve already ran in
                # the loop; fold the chunk into the landmark pose graph.
                with span("slam.taggraph"):
                    tg = taggraph_accumulate(tg, ids, T_all, ok_all & seed_all)
                    ba = apply_taggraph(tg, ba, taggraph_due(ba, B), taggraph_iters)
            loc_obs = loc_used

        # Pose observability against the final map: BA's landmarks, else the
        # chaining graph (whose world frame is the coordinate frame).
        coord = o["coord_id"]
        with span("slam.observability"):
            world_f, active_f = (ba.lm_pose, ba.lm_active) if use_ba else (graph.world, graph.present)
            Mf = world_f.shape[0]
            c_slot = coord.clamp(0, Mf - 1).long()
            frame_ok = (coord >= 0) & (coord < Mf) & active_f[c_slot]
            T_wa = torch.where(frame_ok[:, None, None], world_f[c_slot], eye4)
            s = pose_observability(world_f, loc_obs, K, tag_size, T_wa @ poses)
            pose_obs = torch.where(o["valid"] & frame_ok & loc_obs.any(-1), s, 0.0)

        outs = SlamOutputs(
            poses=poses,
            valid=o["valid"],
            reproj_rms=rms,
            pose_obs=pose_obs,
            loc_used=loc_used,
            n_visible=o["n_visible"],
            n_nodes=o["n_nodes"],
            avg_node_distance=o["avg_node_distance"],
            coord_id=coord,
            loop_closures=o["loop_closures"],
            node_visible=o["node_visible"],
            node_weight=o["node_weight"],
            node_local=o["node_local"],
            node_world=o["node_world"],
            det_ids=ids,
            det_corners=det.corners,
            det_ok=ok_all,
        )
        if use_pgo:
            return (graph, ba, pgo_s, tg), outs
        return ((graph, ba) if use_ba else graph), outs

    def slam_step(state, frames):
        with span("slam.step"):
            return back(state, front(frames))

    slam_step._halves = (front, back)

    def init():
        g = init_graph(graph_capacity, device=dev)
        if not use_ba:
            return g
        ba = ba_init(ba_keyframes, graph_capacity, ba_obs, device=dev)
        if not use_pgo:
            return (g, ba)
        return (g, ba, pgo_init(pgo_nodes, pgo_edges, graph_capacity, ba_keyframes, device=dev),
                taggraph_init(graph_capacity, device=dev))

    return slam_step, init


def _step_halves(step):
    """(front, back) of a step built by :func:`build_slam_step`:
    ``step(state, frames) == back(state, front(frames))``, where ``front``
    (detection and PnP) works frame by frame over any batch."""
    return step._halves


class SlamSystem:
    """Stateful wrapper: consumes whole frame chunks per ``process`` call.

    Keyword arguments are those of :func:`build_slam_step` (the rest pass
    through to it); ``device=None`` means the CUDA device."""

    def __init__(
        self,
        camera: PinholeCamera,
        family: str | TagFamily = "tagStandard41h12",
        tag_size: float = 10.0,
        estimator: Estimator = "joint",
        detector_params: DetectorParams | None = None,
        graph_capacity: int = 64,
        dist_coeffs=None,
        pgo: bool = False,
        pgo_nodes: int = 64,
        pgo_edges: int = 192,
        pgo_loop_gap: int = 24,
        ba_schedule: Literal["frame", "chunk"] = "frame",
        ba_chunk_iters: int | None = None,
        init_joint_iters: int | None = None,
        kf_every: int = 0,
        taggraph_every: int = 1,
        pgo_opt_iters: int | None = None,
        taggraph_iters: int | None = None,
        device: str | torch.device | None = None,
        **step_kwargs,
    ):
        self._step, self._init = build_slam_step(
            family, camera, tag_size,
            detector_params=detector_params,
            estimator=estimator,
            graph_capacity=graph_capacity,
            dist_coeffs=dist_coeffs,
            pgo=pgo,
            pgo_nodes=pgo_nodes,
            pgo_edges=pgo_edges,
            pgo_loop_gap=pgo_loop_gap,
            ba_schedule=ba_schedule,
            ba_chunk_iters=ba_chunk_iters,
            init_joint_iters=init_joint_iters,
            kf_every=kf_every,
            taggraph_every=taggraph_every,
            pgo_opt_iters=pgo_opt_iters,
            taggraph_iters=taggraph_iters,
            device=device,
            **step_kwargs,
        )
        self.state = self._init()

    def process(self, frames) -> SlamOutputs:
        self.state, outs = self._step(self.state, frames)
        return outs

    @property
    def graph_state(self) -> GraphState:
        return self.state[0] if isinstance(self.state, tuple) else self.state

    @property
    def ba_state(self) -> BAState | None:
        return self.state[1] if isinstance(self.state, tuple) else None

    @property
    def pgo_state(self):
        return self.state[2] if isinstance(self.state, tuple) and len(self.state) > 2 else None

    @property
    def coordinate_id(self) -> int:
        return int(self.graph_state.coordinate_id)

    def reset(self):
        self.state = self._init()
