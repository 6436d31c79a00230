from .graph import (
    GraphState,
    init_graph,
    update_graph,
    estimate_pose_average,
    average_distance_to_nodes,
    NO_ANCHOR,
)
from .localize import joint_camera_pose, pose_observability
from .ba import BAState, ba_init, ba_add_frame, ba_optimize, ba_cost, latest_pose
from .pipeline import SlamSystem, SlamOutputs, build_slam_step

__all__ = [
    "GraphState",
    "init_graph",
    "update_graph",
    "estimate_pose_average",
    "average_distance_to_nodes",
    "NO_ANCHOR",
    "joint_camera_pose",
    "pose_observability",
    "BAState",
    "ba_init",
    "ba_add_frame",
    "ba_optimize",
    "ba_cost",
    "latest_pose",
    "SlamSystem",
    "SlamOutputs",
    "build_slam_step",
]
