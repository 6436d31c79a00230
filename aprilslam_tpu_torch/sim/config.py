"""Scene configuration: JSON schema, validation, and unit system
(port of ``aprilslam_tpu/sim/config.py``; numpy only).

Fields: ``display_width/height``, vertical ``fov_y``, ``near/far_clip``,
``size_scale`` scaling of ``tag_size_inner/outer``, ``actual_size_in_mm``,
an optional ``family`` (default tagStandard41h12), and a tag list with
id/image/position/rotation.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass

import numpy as np

DEFAULT_SCENE = os.path.join(os.path.dirname(__file__), "data", "default_scene.json")


@dataclass(frozen=True)
class TagConfig:
    id: int
    position: np.ndarray  # (3,) GL world units
    rotation: np.ndarray  # (3,) degrees [rx, ry, rz], applied Rz@Ry@Rx
    image: str = ""


@dataclass(frozen=True)
class SceneConfig:
    display_width: int
    display_height: int
    fov_y: float
    near_clip: float
    far_clip: float
    size_scale: float
    tag_size_inner_raw: float
    tag_size_outer_raw: float
    actual_size_in_mm: float
    tags: tuple[TagConfig, ...]
    family: str = "tagStandard41h12"
    background: float = 52.9 / 255.0  # gray level of the purple clear colour

    @property
    def display_size(self) -> tuple[int, int]:
        return (self.display_width, self.display_height)

    @property
    def tag_size_inner(self) -> float:
        """Detected-border square size in sim units."""
        return self.tag_size_inner_raw * self.size_scale

    @property
    def tag_size_outer(self) -> float:
        """Rendered quad size in sim units."""
        return self.tag_size_outer_raw * self.size_scale

    def simulation_units_to_mm(self, value: float) -> float:
        return value * self.actual_size_in_mm / self.tag_size_inner

    def mm_to_simulation_units(self, value_mm: float) -> float:
        return value_mm * self.tag_size_inner / self.actual_size_in_mm

    def tag_ids(self) -> np.ndarray:
        return np.array([t.id for t in self.tags], dtype=np.int32)

    def tag_positions(self) -> np.ndarray:
        return np.stack([t.position for t in self.tags]).astype(np.float32)

    def tag_rotations(self) -> np.ndarray:
        return np.stack([t.rotation for t in self.tags]).astype(np.float32)

    @staticmethod
    def from_file(path: str | None = None) -> "SceneConfig":
        with open(path or DEFAULT_SCENE) as f:
            return SceneConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(raw: dict) -> "SceneConfig":
        required = [
            "display_width", "display_height", "fov_y", "near_clip", "far_clip",
            "size_scale", "tag_size_inner", "tag_size_outer", "actual_size_in_mm", "tags",
        ]
        missing = [k for k in required if k not in raw]
        if missing:
            raise ValueError(f"Scene config missing required keys: {missing}")
        if raw["display_width"] <= 0 or raw["display_height"] <= 0:
            raise ValueError("display dimensions must be positive")
        if not (0.0 < raw["fov_y"] < 180.0):
            raise ValueError(f"fov_y must be in (0, 180), got {raw['fov_y']}")
        if raw["near_clip"] >= raw["far_clip"]:
            raise ValueError("near_clip must be < far_clip")
        if raw["near_clip"] <= 0:
            raise ValueError("near_clip must be positive")
        for key in ("size_scale", "tag_size_inner", "tag_size_outer", "actual_size_in_mm"):
            if raw[key] <= 0:
                raise ValueError(f"{key} must be positive")
        if not raw["tags"]:
            raise ValueError("tags list must be non-empty")

        tags = []
        for i, t in enumerate(raw["tags"]):
            for key in ("position", "rotation"):
                if key not in t:
                    raise ValueError(f"tag entry {i} missing '{key}'")
            tag_id = t.get("tag_id", t.get("id"))
            if tag_id is None and "image" in t:
                m = re.search(r"(\d+)", os.path.basename(t["image"]))
                if m:
                    tag_id = int(m.group(1))
            if tag_id is None:
                raise ValueError(f"tag entry {i} has no id/tag_id/image-derived id")
            pos = np.asarray(t["position"], dtype=np.float32)
            rot = np.asarray(t["rotation"], dtype=np.float32)
            if pos.shape != (3,) or rot.shape != (3,):
                raise ValueError(f"tag {tag_id}: position/rotation must be 3-vectors")
            tags.append(TagConfig(id=int(tag_id), position=pos, rotation=rot, image=t.get("image", "")))
        ids = [t.id for t in tags]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tag ids in scene: {sorted(ids)}")

        return SceneConfig(
            display_width=int(raw["display_width"]),
            display_height=int(raw["display_height"]),
            fov_y=float(raw["fov_y"]),
            near_clip=float(raw["near_clip"]),
            far_clip=float(raw["far_clip"]),
            size_scale=float(raw["size_scale"]),
            tag_size_inner_raw=float(raw["tag_size_inner"]),
            tag_size_outer_raw=float(raw["tag_size_outer"]),
            actual_size_in_mm=float(raw["actual_size_in_mm"]),
            tags=tuple(tags),
            family=str(raw.get("family", "tagStandard41h12")),
        )


def randomize_scene(raw: dict, percentage: float = 0.1, seed: int | None = None) -> dict:
    """Perturb every tag position/rotation by +-percentage (relative; absolute
    for zero entries), drawing from ``np.random.default_rng(seed)`` in the
    same order as the JAX package, so the same seed gives the same scene."""
    rng = np.random.default_rng(seed)
    out = json.loads(json.dumps(raw))

    def rand_val(v: float) -> float:
        if v == 0:
            return float(rng.uniform(-percentage, percentage))
        return float(v * (1.0 + rng.uniform(-percentage, percentage)))

    for tag in out["tags"]:
        tag["position"] = [rand_val(v) for v in tag["position"]]
        tag["rotation"] = [rand_val(v) for v in tag["rotation"]]
    return out
