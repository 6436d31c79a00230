"""Multi-sequence SLAM: independent trajectories, one state each
(port of ``aprilslam_tpu/parallel/sequences.py``).

BASELINE config 3, "8 simulated trajectories processed in parallel (batched
detection + independent BA)". The JAX package maps the whole step over the
sequences of a ``data`` mesh axis. The port's step splits at the
detect -> geometry boundary (``slam/pipeline.py``): ``parallel_step`` runs
the front end (detection, with the CCL kernel on the card, and PnP) once
over the S x B frames of every sequence, then each sequence's back end, a
host loop over its chunk's frames, on its own state, in sequence order. The
front end works frame by frame and the sequences share nothing else, so the
outputs are those of S separate steps, stacked.

Each call opens ``slam.fleet``, with ``slam.fleet.front`` around the
batched front end (one ``slam.front``) and ``slam.fleet.back`` around the S
back ends (S ``slam.back``) and the stack of their outputs.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..detect import Detections, DetectorParams
from ..families import TagFamily
from ..geometry import PinholeCamera
from ..slam.pipeline import SlamOutputs, _step_halves, build_slam_step
from ..utils.profiling import span
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
    ``pgo=True``, ...) runs its back end per sequence; the pose-graph state
    is per-sequence too. The detector and PnP run once per call over all
    S x B frames.
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

    front, back = _step_halves(step)

    def parallel_step(states: list, frames):
        with span("slam.fleet"):
            frames = shard(frames)
            if len(states) != n_seq or frames.shape[0] != n_seq:
                raise ValueError(f"expected {n_seq} states and sequences, got {len(states)} "
                                 f"and {frames.shape[0]}")
            B = frames.shape[1]
            with span("slam.fleet.front"):
                det, *poses = front(frames.reshape((n_seq * B,) + frames.shape[2:]))
            with span("slam.fleet.back"):
                new_states, outs = [], []
                for s in range(n_seq):
                    rows = slice(s * B, (s + 1) * B)
                    det_s = Detections(**{f.name: getattr(det, f.name)[rows] for f in fields(Detections)})
                    st, o = back(states[s], (det_s, *(x[rows] for x in poses)))
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
