"""Multi-sequence SLAM: independent trajectories, one state each
(port of ``aprilslam_tpu/parallel/sequences.py``).

BASELINE config 3, "8 simulated trajectories processed in parallel". The
JAX package maps the step over the sequences of a ``data`` mesh axis. The
port's step is a host loop over each chunk's frames (``slam/pipeline.py``),
so ``parallel_step`` runs the S sequences' steps one after another on the
mesh's device, each with its own state; detection is not batched across
sequences. The sequences share nothing, so the outputs are those of S
separate steps, stacked.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..detect import DetectorParams
from ..families import TagFamily
from ..geometry import PinholeCamera
from ..slam.pipeline import SlamOutputs, build_slam_step
from .mesh import Mesh


def build_parallel_slam(
    mesh: Mesh,
    family: str | TagFamily,
    camera: PinholeCamera,
    tag_size: float,
    detector_params: DetectorParams | None = None,
    estimator: str = "joint",
    graph_capacity: int = 64,
    axis: str = "data",
    **step_kwargs,
):
    """Returns (parallel_step, init_states, shard) where

    * ``parallel_step(states, frames) -> (states, outputs)`` takes a list of
      S per-sequence states and ``frames`` shaped (S, B, H, W), and returns
      the new states and ``SlamOutputs`` whose fields are stacked (S, B, ...);
    * ``init_states()`` builds the S initial states;
    * ``shard(x)`` places an (S, ...) array on the mesh's device.

    ``step_kwargs`` forward to :func:`build_slam_step`: the production
    configuration (``estimator="ba"``, ``ba_schedule="chunk"``,
    ``pgo=True``, ...) runs per sequence; the pose-graph state is
    per-sequence too.
    """
    n_seq = mesh.local_size(axis)
    step, init_one = build_slam_step(
        family, camera, tag_size,
        detector_params=detector_params,
        estimator=estimator,
        graph_capacity=graph_capacity,
        device=mesh.device,
        **step_kwargs,
    )

    def parallel_step(states: list, frames):
        frames = shard(frames)
        if len(states) != n_seq or frames.shape[0] != n_seq:
            raise ValueError(f"expected {n_seq} states and sequences, got {len(states)} "
                             f"and {frames.shape[0]}")
        new_states, outs = [], []
        for s in range(n_seq):
            st, o = step(states[s], frames[s])
            new_states.append(st)
            outs.append(o)
        return new_states, SlamOutputs(**{
            f.name: torch.stack([getattr(o, f.name) for o in outs]) for f in fields(SlamOutputs)
        })

    def init_states() -> list:
        return [init_one() for _ in range(n_seq)]

    def shard(x) -> torch.Tensor:
        return torch.as_tensor(x, device=mesh.device)

    return parallel_step, init_states, shard
