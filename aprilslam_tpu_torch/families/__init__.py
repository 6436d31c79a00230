"""Tag families as data: bit-grid codebooks with a matmul matcher.

Port of ``aprilslam_tpu/families/__init__.py`` (numpy only). The port keeps
its own copy of the family data files under ``families/data``.

Cell-grid conventions (AprilTag 3 layout descriptions):
* ``total_width`` — grid side length in cells (incl. border and margin).
* ``width_at_border`` — side length of the square the quad detector localizes.
* ``reversed_border`` — False: black border with white outside (tag36h11).
  True: white ring just inside a black ring (tagStandard41h12), with data
  bits outside the black ring.
* Grid row 0 is the TOP of the canonical (rotation 0) tag image.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclass(frozen=True)
class TagFamily:
    name: str
    grids: np.ndarray  # (N, C, C) uint8, 0=black 1=white, rotation-0 canonical
    total_width: int
    width_at_border: int
    reversed_border: bool
    min_hamming: int

    @property
    def n_codes(self) -> int:
        return int(self.grids.shape[0])

    def border_rings(self) -> tuple[np.ndarray, np.ndarray]:
        """(black_mask, white_mask): cells whose colour is known a priori."""
        C = self.total_width
        m = (C - self.width_at_border) // 2  # offset of the border square

        def ring_at(o: int) -> np.ndarray:
            r = np.zeros((C, C), dtype=bool)
            r[o : C - o, o : C - o] = True
            if C - 2 * o > 2:
                r[o + 1 : C - o - 1, o + 1 : C - o - 1] = False
            return r

        if self.reversed_border:
            return ring_at(m - 1), ring_at(m)
        return ring_at(m), ring_at(m - 1)

    def sample_mask(self) -> np.ndarray:
        """Cells participating in codebook matching (bool (C, C))."""
        C = self.total_width
        if self.reversed_border:
            return np.ones((C, C), dtype=bool)
        m = (C - self.width_at_border) // 2
        mask = np.zeros((C, C), dtype=bool)
        mask[m : C - m, m : C - m] = True
        return mask

    def codebook(self) -> tuple[np.ndarray, np.ndarray]:
        """``(templates (4N, D) float32 of +-1, meta (4N, 2) int32 (id, rot))``,
        rotation-major: entry ``k * N + i`` is code ``i`` rotated ``k`` times
        by 90 deg CCW in grid space."""
        masks = self.sample_mask()
        n = self.n_codes
        tmpl = np.zeros((4 * n, int(masks.sum())), dtype=np.float32)
        meta = np.zeros((4 * n, 2), dtype=np.int32)
        for k in range(4):
            rot = np.rot90(self.grids, k=k, axes=(1, 2))
            tmpl[k * n : (k + 1) * n] = rot[:, masks].astype(np.float32) * 2.0 - 1.0
            meta[k * n : (k + 1) * n, 0] = np.arange(n)
            meta[k * n : (k + 1) * n, 1] = k
        return tmpl, meta

    def cell_centers_quad_frame(self) -> np.ndarray:
        """(C, C, 2) cell-centre coordinates in the detected-quad frame
        ([-1, 1]^2 over the border square, +x right, +y down)."""
        C = self.total_width
        idx = np.arange(C, dtype=np.float32)
        u = (idx + 0.5 - C / 2.0) * (2.0 / self.width_at_border)
        uu, vv = np.meshgrid(u, u, indexing="xy")
        return np.stack([uu, vv], axis=-1)


def _load(name: str) -> TagFamily:
    path = os.path.join(_DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise ValueError(f"Unknown tag family '{name}'. Built-ins: {list_families()}")
    z = np.load(path)
    return TagFamily(
        name=str(z["name"]),
        grids=np.asarray(z["grids"], dtype=np.uint8),
        total_width=int(z["total_width"]),
        width_at_border=int(z["width_at_border"]),
        reversed_border=bool(z["reversed_border"]),
        min_hamming=int(z["min_hamming"]),
    )


@lru_cache(maxsize=None)
def get_family(name: str) -> TagFamily:
    return _load(name)


def list_families() -> list[str]:
    return sorted(f[:-4] for f in os.listdir(_DATA_DIR) if f.endswith(".npz"))
