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
from .pgo import PoseGraphEdges, edges_init, add_edge, edges_from_trajectory, pgo_optimize, pgo_cost
from .loop import PgoState, pgo_init, pgo_track_frame, pgo_solve, apply_node_deltas
from .taggraph import (
    TagGraphState,
    taggraph_init,
    taggraph_accumulate,
    taggraph_edges,
    taggraph_support,
    taggraph_solve,
)
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
    "PoseGraphEdges",
    "edges_init",
    "add_edge",
    "edges_from_trajectory",
    "pgo_optimize",
    "pgo_cost",
    "PgoState",
    "pgo_init",
    "pgo_track_frame",
    "pgo_solve",
    "apply_node_deltas",
    "TagGraphState",
    "taggraph_init",
    "taggraph_accumulate",
    "taggraph_edges",
    "taggraph_support",
    "taggraph_solve",
    "SlamSystem",
    "SlamOutputs",
    "build_slam_step",
]
