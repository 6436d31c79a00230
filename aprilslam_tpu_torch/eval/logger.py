"""Structured CSV logging — schema parity with the reference DataLogger
(port of ``aprilslam_tpu/eval/logger.py``).

Writes the same three CSVs (data_logger.py:101-154):
* ``slam_simulation_data.csv`` — 17 columns of per-frame estimate-vs-GT;
* ``error_analysis.csv`` — 22 columns of per-node error attribution;
* ``covariance_analysis.csv`` — 8 columns for the live covariance monitor;
with the same flush-every-10-rows policy (data_logger.py:189-190) and
runtime/FPS statistics (data_logger.py:266-286).

Rows arrive as numpy arrays already on the host; the Euler angles are taken
there, from a CPU tensor, never with a device round trip per row.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..geometry import matrix_to_euler_zyx

MAIN_HEADER = [
    "Time", "Number_of_Nodes", "Average_Distance",
    "Est_X", "Est_Y", "Est_Z", "Est_Roll", "Est_Pitch", "Est_Yaw",
    "GT_X", "GT_Y", "GT_Z", "GT_Roll", "GT_Pitch", "GT_Yaw",
    "Translation_Difference", "Rotation_Difference", "Reproj_RMS",
]

ERROR_HEADER = [
    "Number_of_Jumps",
    "Est_X_Local", "Est_Y_Local", "Est_Z_Local",
    "Est_Roll_Local", "Est_Pitch_Local", "Est_Yaw_Local",
    "Est_X_World", "Est_Y_World", "Est_Z_World",
    "Est_Roll_World", "Est_Pitch_World", "Est_Yaw_World",
    "Tag_Est_X", "Tag_Est_Y", "Tag_Est_Z",
    "Tag_Est_Roll", "Tag_Est_Pitch", "Tag_Est_Yaw",
    "Error_World", "Error_Local", "Translation_Error",
]

COV_HEADER = [
    "Number_of_Jumps",
    "Tag_Est_X", "Tag_Est_Y", "Tag_Est_Z",
    "Tag_Est_Roll", "Tag_Est_Pitch", "Tag_Est_Yaw",
    "Translation_Error",
]


def euler_of(T: np.ndarray) -> np.ndarray:
    """[roll, pitch, yaw] radians from a 4x4 (reference euler convention),
    in float32 on the CPU as the JAX package computes it."""
    R = torch.from_numpy(np.asarray(T[:3, :3], dtype=np.float32))
    return matrix_to_euler_zyx(R).numpy()


class DataLogger:
    """CSV logger with reference-schema outputs."""

    def __init__(self, output_dir: str = "data/csv", flush_every: int = 10):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.flush_every = flush_every
        self._t0 = time.time()
        self._rows = 0
        self._frames = 0

        self._main_f = open(os.path.join(output_dir, "slam_simulation_data.csv"), "w", newline="")
        self._main = csv.writer(self._main_f)
        self._main.writerow(MAIN_HEADER)

        self._err_f = open(os.path.join(output_dir, "error_analysis.csv"), "w", newline="")
        self._err = csv.writer(self._err_f)
        self._err.writerow(ERROR_HEADER)

        self._cov_f = open(os.path.join(output_dir, "covariance_analysis.csv"), "w", newline="")
        self._cov = csv.writer(self._cov_f)
        self._cov.writerow(COV_HEADER)

    # ------------------------------------------------------------------ main
    def log_frame(
        self,
        est_pose: np.ndarray,  # (4, 4)
        gt_pose: np.ndarray,  # (4, 4)
        n_nodes: int,
        avg_distance: float,
        t: float | None = None,
        reproj_rms: float = 0.0,
    ) -> None:
        te = float(np.linalg.norm(est_pose[:3, 3] - gt_pose[:3, 3]))
        re = float(np.linalg.norm(est_pose[:3, :3] - gt_pose[:3, :3], "fro"))
        ee = euler_of(est_pose)
        ge = euler_of(gt_pose)
        self._main.writerow(
            [
                round(t if t is not None else time.time() - self._t0, 4),
                int(n_nodes),
                round(float(avg_distance), 6),
                *[round(float(v), 6) for v in est_pose[:3, 3]],
                *[round(float(v), 6) for v in ee],
                *[round(float(v), 6) for v in gt_pose[:3, 3]],
                *[round(float(v), 6) for v in ge],
                round(te, 6),
                round(re, 6),
                round(float(reproj_rms), 6),
            ]
        )
        self._frames += 1
        self._maybe_flush()

    # ------------------------------------------------------------- per node
    def log_node(
        self,
        n_jumps: float,
        local: np.ndarray,
        world: np.ndarray,
        tag_est: np.ndarray,
        error_world: float,
        error_local: float,
        translation_error: float,
    ) -> None:
        le, we, te_ = euler_of(local), euler_of(world), euler_of(tag_est)
        self._err.writerow(
            [
                n_jumps,
                *[round(float(v), 6) for v in local[:3, 3]], *[round(float(v), 6) for v in le],
                *[round(float(v), 6) for v in world[:3, 3]], *[round(float(v), 6) for v in we],
                *[round(float(v), 6) for v in tag_est[:3, 3]], *[round(float(v), 6) for v in te_],
                round(float(error_world), 6),
                round(float(error_local), 6),
                round(float(translation_error), 6),
            ]
        )
        self._cov.writerow(
            [
                n_jumps,
                *[round(float(v), 6) for v in tag_est[:3, 3]],
                *[round(float(v), 6) for v in te_],
                round(float(translation_error), 6),
            ]
        )
        self._maybe_flush()

    def _maybe_flush(self):
        self._rows += 1
        if self._rows % self.flush_every == 0:
            self._main_f.flush()
            self._err_f.flush()
            self._cov_f.flush()

    # ------------------------------------------------------------------ stats
    def get_statistics(self) -> dict:
        runtime = time.time() - self._t0
        return {
            "runtime_seconds": runtime,
            "frames_logged": self._frames,
            "average_fps": self._frames / runtime if runtime > 0 else 0.0,
            "output_directory": self.output_dir,
        }

    def close(self):
        for f in (self._main_f, self._err_f, self._cov_f):
            try:
                f.flush()
                f.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
