"""A run driven on the CPU at a small size: ``correct`` holds for the
program, and comes out false for the control (the reference in bfloat16 in
the program's place) and for each fault planted in the timed path.

Besides the benchmark's cells, the front end's entry is driven as the
``default_1k.tagpose_fleet`` cell would drive it (PERF.md § 7: the cell
waits for the detector's fault at the frame's edge to be mended)."""

import pytest
import torch

from perfbench import control, harness

FLEET = {"name": "default_1k.tagpose_fleet", "config": "sim_default_1k", "traffic": "tagpose_fleet", "chips": 1,
         "why": "detect and PnP only"}
SMALL = {
    # The whole 96-frame loop, so that a session closes its loop in the window.
    "loop_1k.closure": {"resolution": [640, 640], "warmup_calls": 0},
    "default_1k.tagpose_fleet": {"resolution": [384, 384], "pool": {"kind": "monte_carlo", "frames": 16},
                                 "frames_per_call": 8, "warmup_calls": 1},
}
SECONDS = {"loop_1k.closure": 60.0, "default_1k.tagpose_fleet": 1.0}
FAULTS = {"loop_1k.closure": ["half_batch", "altered", "frozen_state"],
          "default_1k.tagpose_fleet": ["half_batch", "altered"]}


@pytest.fixture(scope="module", params=sorted(SMALL))
def reading(request):
    torch.set_num_threads(2)
    cell = request.param
    listed = {w["name"] for w in harness.benchmark()["workloads"]}
    return cell, control.readings(cell if cell in listed else FLEET, 2**31 + 77, SECONDS[cell], FAULTS[cell],
                                  torch.device("cpu"), overrides=SMALL[cell])


def test_the_program_is_correct_and_the_control_is_not(reading):
    cell, r = reading
    assert r["correct"], r["program"]
    assert not r["control_correct"], r["control"]


def test_every_fault_is_caught(reading):
    cell, r = reading
    assert set(r["faults"]) == set(FAULTS[cell])
    for name, f in r["faults"].items():
        assert not f["correct"], (name, f["nums"])
