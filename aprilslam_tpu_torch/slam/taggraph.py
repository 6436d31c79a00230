"""Landmark (tag-to-tag) pose graph, the map corrector of the loop-closure
back end (port of ``aprilslam_tpu/slam/taggraph.py``).

* Every frame in which two tags are co-visible yields a relative-pose
  measurement ``T_ij = inv(T_obs_i) @ T_obs_j``, independent of the camera
  pose estimate and of the map.
* Measurements accumulate per ordered pair (i < j) as a running
  tangent-space mean around the pair's reference (its first sighting).
* A small LM pose-graph solve (``slam/pgo.py``) over the active tags,
  gauge-fixed at the anchor, replaces the chained seeding error with the
  averaged geometry.

Tie orders follow the JAX package's ``top_k`` (equal values, lowest index
first) through stable descending sorts. Where several measurements of a
pair arrive in one chunk for a pair without a reference, the last one in
flat order is elected, as the reference's scatter does on the CPU, here
deterministically on every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..geometry import se3_exp, se3_inverse, se3_log
from .pgo import PoseGraphEdges, pgo_optimize


@dataclass(frozen=True)
class TagGraphState:
    """Per ordered pair (i < j) of tag slots: running tangent-space mean.

    ``mean_T(i, j) = ref_T[i, j] @ exp(sum_dev[i, j] / count[i, j])``."""

    ref_T: torch.Tensor  # (M, M, 4, 4) first accepted measurement per pair
    sum_dev: torch.Tensor  # (M, M, 6) sum of se3_log deviations from ref
    count: torch.Tensor  # (M, M) accepted measurement count
    rejected: torch.Tensor  # (M, M) rejections since the reference was elected

    @property
    def capacity(self) -> int:
        return int(self.count.shape[0])


def taggraph_init(n_landmarks: int = 64, dtype=torch.float32, device=None) -> TagGraphState:
    """An empty pair accumulator on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    M = n_landmarks
    return TagGraphState(
        ref_T=torch.eye(4, dtype=dtype, device=device).expand(M, M, 4, 4).clone(),
        sum_dev=torch.zeros((M, M, 6), dtype=dtype, device=device),
        count=torch.zeros((M, M), dtype=dtype, device=device),
        rejected=torch.zeros((M, M), dtype=dtype, device=device),
    )


def _stable_topk(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` on a 1-D tensor: the k largest, equal values in
    index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def taggraph_accumulate(
    tg: TagGraphState,
    ids: torch.Tensor,  # (B, D) or (D,) int32 detection tag ids
    T_obs: torch.Tensor,  # (B, D, 4, 4) or (D, 4, 4) PnP tag-in-camera poses
    reliable: torch.Tensor,  # (B, D) or (D,) bool: branch-reliable PnP only
    max_dev_t: float = 5.0,
    max_dev_r: float = 0.5,
    compact_budget: int = 512,
) -> TagGraphState:
    """Fold a chunk of detections into the pair accumulator.

    All D^2 ordered pairs per frame are formed batched. A measurement
    deviating from its pair's reference by more than ``max_dev_t`` units or
    ``max_dev_r`` radians is rejected (a wrong planar branch). Valid pairs
    are compacted to ``compact_budget`` before the per-pair math; overflow
    drops measurements."""
    M = tg.capacity
    dtype, dev = tg.sum_dev.dtype, tg.sum_dev.device
    if ids.ndim == 1:
        ids, T_obs, reliable = ids[None], T_obs[None], reliable[None]
    B, D = ids.shape

    idp = ids[:, :, None].expand(B, D, D).reshape(-1)
    idq = ids[:, None, :].expand(B, D, D).reshape(-1)
    rp = reliable[:, :, None].expand(B, D, D).reshape(-1)
    rq = reliable[:, None, :].expand(B, D, D).reshape(-1)
    valid = rp & rq & (idp >= 0) & (idq > idp) & (idq < M)
    Tp = T_obs[:, :, None].expand(B, D, D, 4, 4).reshape(-1, 4, 4)
    Tq = T_obs[:, None, :].expand(B, D, D, 4, 4).reshape(-1, 4, 4)
    if compact_budget and compact_budget < valid.shape[0]:
        # Valid-first compaction: the 4x4 math runs on the budget only.
        _, sel = _stable_topk(valid.to(torch.int32), compact_budget)
        idp, idq, valid, Tp, Tq = idp[sel], idq[sel], valid[sel], Tp[sel], Tq[sel]
    T_pair = se3_inverse(Tp.to(dtype)) @ Tq.to(dtype)

    i = idp.clamp(0, M - 1).long()
    j = idq.clamp(0, M - 1).long()
    flat = torch.where(valid, i * M + j, M * M)  # invalid -> the dropped pad slot
    n = flat.shape[0]

    # Pass 1: elect a reference for pairs seen for the first time: the last
    # valid measurement of the pair in flat order.
    pos = torch.arange(n, device=dev)
    last = torch.full((M * M + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, flat, pos, reduce="amax")[:-1]
    touched = last >= 0
    cand = T_pair[last.clamp(min=0)]
    count_flat = tg.count.reshape(-1)
    is_new = touched & (count_flat == 0)
    ref = torch.where(is_new[:, None, None], cand, tg.ref_T.reshape(-1, 4, 4))

    # Pass 2: tangent deviations against the (possibly new) reference.
    ref_k = ref[flat.clamp(max=M * M - 1)]
    dev_k = se3_log(se3_inverse(ref_k) @ T_pair)
    ok_dev = (torch.linalg.norm(dev_k[:, 3:], dim=-1) < max_dev_t) & (
        torch.linalg.norm(dev_k[:, :3], dim=-1) < max_dev_r)
    keep = valid & ok_dev
    # Segment sums as one-hot products: deterministic on the card. Rows not
    # kept are zeroed first: a padding detection's PnP pose may be NaN, and
    # 0 * NaN would reach every pair through the product.
    dev_k = torch.where(keep[:, None], dev_k, 0.0)
    onehot_keep = F.one_hot(torch.where(keep, flat, M * M), M * M + 1)[:, :M * M].to(dtype)
    onehot_rej = F.one_hot(torch.where(valid & ~ok_dev, flat, M * M), M * M + 1)[:, :M * M].to(dtype)
    sum_dev = tg.sum_dev.reshape(-1, 6) + onehot_keep.T @ dev_k.to(dtype)
    count = count_flat + onehot_keep.sum(0)
    rejected = tg.rejected.reshape(-1) + onehot_rej.sum(0)
    # Self-healing election: a pair rejecting more than it accepts (plus
    # slack) resets, and the next chunk elects a new reference.
    reset = rejected > (count + 2.0)
    sum_dev = torch.where(reset[:, None], 0.0, sum_dev)
    count = torch.where(reset, 0.0, count)
    rejected = torch.where(reset, 0.0, rejected)
    return TagGraphState(
        ref_T=ref.reshape(M, M, 4, 4),
        sum_dev=sum_dev.reshape(M, M, 6),
        count=count.reshape(M, M),
        rejected=rejected.reshape(M, M),
    )


def taggraph_edges(tg: TagGraphState, lm_active: torch.Tensor, max_edges: int = 128,
                   min_count: float = 3.0) -> PoseGraphEdges:
    """The top-``max_edges`` pairs by count as pose-graph edges, weighted by
    sqrt(count); pairs below ``min_count`` sightings are not ok."""
    M = tg.capacity
    dtype = tg.sum_dev.dtype
    act = lm_active.to(dtype)
    cnt = tg.count * act[:, None] * act[None, :]
    top, kidx = _stable_topk(cnt.reshape(-1), min(max_edges, M * M))
    mean_dev = tg.sum_dev.reshape(-1, 6)[kidx] / torch.clamp(tg.count.reshape(-1)[kidx, None], min=1.0)
    T_mean = tg.ref_T.reshape(-1, 4, 4)[kidx] @ se3_exp(mean_dev)
    return PoseGraphEdges(
        i=(kidx // M).to(torch.int32),
        j=(kidx % M).to(torch.int32),
        T_meas=T_mean.to(dtype),
        weight=torch.sqrt(torch.clamp(top, min=1.0)).to(dtype),
        ok=top >= min_count,
    )


def taggraph_support(tg: TagGraphState) -> torch.Tensor:
    """(M,) total accepted pair sightings incident to each tag."""
    return tg.count.sum(0) + tg.count.sum(1)


def taggraph_solve(
    tg: TagGraphState,
    lm_pose: torch.Tensor,  # (M, 4, 4) current landmark world poses
    lm_active: torch.Tensor,  # (M,) bool
    anchor: torch.Tensor,  # () int32 gauge tag slot (-1 = none yet)
    hold: torch.Tensor | None = None,  # (M,) bool: tags NOT to move
    iters: int = 6,
    max_edges: int = 128,
    rot_weight: float = 25.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine landmark poses against the averaged co-visibility graph.

    Returns ``(new_lm_pose, moved)``: poses in the same floating world
    gauge (the anchor pinned where it sits), and a () bool saying whether a
    solve ran. Without an anchor, an ok edge or a movable tag, ``lm_pose``
    itself comes back and ``moved`` is False. That gate is decided on the
    host, one read per call, so the skipped branch is an exact pass-through."""
    edges = taggraph_edges(tg, lm_active, max_edges=max_edges)
    movable = lm_active if hold is None else (lm_active & ~hold)
    have = edges.ok.any() & (anchor >= 0) & movable.any()
    if not bool(have):
        return lm_pose, have
    new = pgo_optimize(lm_pose, edges, active=movable, iters=iters, rot_weight=rot_weight,
                       gauge_index=anchor.clamp(0, tg.capacity - 1))
    return new, have
