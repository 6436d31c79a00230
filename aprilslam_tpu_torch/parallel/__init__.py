"""The parallel layer: meshes, sharded BA, multi-sequence SLAM and
multi-process support (port of ``aprilslam_tpu/parallel``).

Imports are lazy (PEP 562): ``initialize_distributed`` must run before
anything touches CUDA (it picks each rank's card), and importing the
detection and BA modules here would build their tensors.
"""

import importlib

_EXPORTS = {
    "make_mesh": ".mesh",
    "make_mesh_2d": ".mesh",
    "shard_leading": ".mesh",
    "replicated": ".mesh",
    "build_distributed_ba": ".distributed_ba",
    "shard_observations_by_owner": ".distributed_ba",
    "stack_ba_states": ".distributed_ba",
    "build_keyframe_ba": ".keyframe_ba",
    "KeyframeBAProblem": ".keyframe_ba",
    "partition_obs_by_keyframe": ".keyframe_ba",
    "keyframe_ba_cost": ".keyframe_ba",
    "synthesize_trajectory_problem": ".keyframe_ba",
    "build_parallel_slam": ".sequences",
    "initialize_distributed": ".multihost",
    "is_multiprocess": ".multihost",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
