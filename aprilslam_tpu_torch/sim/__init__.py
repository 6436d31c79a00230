from .config import SceneConfig, TagConfig, DEFAULT_SCENE, randomize_scene
from .ground_truth import camera_to_tag_transforms, camera_in_tag_frames
from .rasterizer import SceneTensors, scene_tensors, render_frames
from . import trajectory

__all__ = [
    "SceneConfig",
    "TagConfig",
    "DEFAULT_SCENE",
    "randomize_scene",
    "camera_to_tag_transforms",
    "camera_in_tag_frames",
    "SceneTensors",
    "scene_tensors",
    "render_frames",
    "trajectory",
]
