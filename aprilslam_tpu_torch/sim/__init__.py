from .config import SceneConfig, TagConfig, randomize_scene, DEFAULT_SCENE
from .ground_truth import (
    camera_to_tag_transforms,
    camera_in_tag_frames,
    tag_distances_from_camera,
    tag_to_tag_distance,
    closest_tag,
    visibility_by_distance,
    tags_unoccluded,
)
from .rasterizer import SceneTensors, scene_tensors, render_frames, project_border_corners, render_sequence
from . import trajectory
from . import degrade

__all__ = [
    "SceneConfig",
    "TagConfig",
    "randomize_scene",
    "DEFAULT_SCENE",
    "camera_to_tag_transforms",
    "camera_in_tag_frames",
    "tag_distances_from_camera",
    "tag_to_tag_distance",
    "closest_tag",
    "visibility_by_distance",
    "tags_unoccluded",
    "SceneTensors",
    "scene_tensors",
    "render_frames",
    "project_border_corners",
    "render_sequence",
    "trajectory",
    "degrade",
]
