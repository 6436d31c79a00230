"""The port's entry points default to the CUDA device: with no ``device`` they
run on the card, and where there is none they raise instead of falling back
to the CPU."""

import numpy as np
import pytest
import torch

from aprilslam_tpu_torch.apps import calibrate, video_detection
from aprilslam_tpu_torch.calib import board_points, calibrate_camera
from aprilslam_tpu_torch.detect import FamilyTensors, detect_fn
from aprilslam_tpu_torch.families import get_family
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.sim import SceneConfig, render_sequence
from aprilslam_tpu_torch.slam import ba_init, edges_init, init_graph, pgo_init, taggraph_init

ENTRY_POINTS = {
    # The detector is built with no device, then run on a blank frame on the card.
    "detect_fn": lambda: detect_fn("tagStandard41h12")(
        torch.zeros((1, 96, 96), dtype=torch.uint8, device="cuda")).ids,
    "init_graph": lambda: init_graph(16).local,
    "ba_init": lambda: ba_init(16, 16, 64).kf_pose,
    "pgo_init": lambda: pgo_init(8, 24, 16, 16).node_pose,
    "taggraph_init": lambda: taggraph_init(16).count,
    "edges_init": lambda: edges_init(8).T_meas,
    "FamilyTensors": lambda: FamilyTensors(get_family("tagStandard41h12")).templates,
    # The device is checked when the sequence is asked for, before any batch.
    "render_sequence": lambda: next(render_sequence(
        SceneConfig.from_file(), np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
        camera=PinholeCamera.from_fov(64, 64, 45.0), batch=1)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    make = ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        return
    assert make().device.type == "cuda"


# Entry points whose result lives on the host: they are called at their
# defaults, and without a GPU they must raise before doing any work.
HOST_RESULT_ENTRY_POINTS = {
    "calibrate_camera": lambda tmp: calibrate_camera(
        board_points(4, 3, 1.0), [np.zeros((12, 2), np.float32)] * 3),
    "video_detection.main": lambda tmp: video_detection.main(["--source", str(tmp / "none.y4m")]),
    "calibrate.main": lambda tmp: calibrate.main(["solve", "--images", str(tmp / "*.png")]),
}


@pytest.mark.parametrize("name", sorted(HOST_RESULT_ENTRY_POINTS))
def test_host_result_entry_point_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs these on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HOST_RESULT_ENTRY_POINTS[name](tmp_path)
