"""The port's entry points default to the CUDA device: with no ``device`` they
run on the card, and where there is none they raise instead of falling back
to the CPU."""

import pytest
import torch

from aprilslam_tpu_torch.detect import detect_fn
from aprilslam_tpu_torch.slam import ba_init, init_graph

ENTRY_POINTS = {
    # The detector is built with no device, then run on a blank frame on the card.
    "detect_fn": lambda: detect_fn("tagStandard41h12")(
        torch.zeros((1, 96, 96), dtype=torch.uint8, device="cuda")).ids,
    "init_graph": lambda: init_graph(16).local,
    "ba_init": lambda: ba_init(16, 16, 64).kf_pose,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    make = ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        return
    assert make().device.type == "cuda"
