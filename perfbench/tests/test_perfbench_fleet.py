"""The fleet cell ``fleet8_1k.loop`` (``configs/sim_fleet8_1k.json`` under
``traffic/fleet_loop.json``) driven on the CPU at a small size: ``correct``
holds for the program (every stream judged on its own), and comes out false
for the control (the reference in bfloat16 in the program's place) and for
each fault planted in the timed path, the entry's own ``stream0_only``
among them.

At 4 frames a stream and call one stream's ATE reads 2.44 su against the
1.797 guarantee, and the JAX package's step reads 2.45 on the same frames:
config 3's back end drifts on the loop's far leg without loop closure
(ROADMAP 3b). That case is kept as a known failure."""

import json
import time

import pytest
import torch

from perfbench import control, harness

CELL = harness.find_cell("fleet8_1k.loop")
S = 3
SEED = 2**31 + 77
FAULTS = ["half_batch", "altered", "frozen_state", "stream0_only"]


def small(B: int) -> dict:
    """3 streams of B frames a call at 640 px, the whole loop, no warm-up."""
    return {"resolution": [640, 640], "streams": S,
            "pool": {"kind": "fleet_loop", "frames": S * 96, "streams": S, "loop_frames": 96, "phase": 12,
                     "chunk": B},
            "frames_per_call": S * B, "session_calls": 96 // B, "warmup_calls": 0}


@pytest.fixture(scope="module")
def rendered():
    """Runs of one size render the same pool from the same seed, which
    takes a minute on the CPU, so the first rendering serves them all."""
    torch.set_num_threads(2)
    make, cache = harness.make_inputs, {}

    def render_once(cfg, trf, seed, device):
        key = json.dumps([cfg, trf, seed, str(device)], sort_keys=True)
        if key not in cache:
            cache[key] = make(cfg, trf, seed, device)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "make_inputs", render_once)
        yield


@pytest.fixture(scope="module")
def reading(rendered):
    """The program's, the control's and each fault's readings on one seed,
    at the cell's own 8 frames a stream and call."""
    return control.readings(CELL, SEED, 45.0, FAULTS, torch.device("cpu"), overrides=small(8))


def test_the_deployment_streams_agree_with_its_pool():
    cfg, trf = harness.config(CELL["config"]), harness.traffic(CELL["traffic"])
    pool = trf["pool"]
    assert cfg["streams"] == pool["streams"] == 8 and pool["chunk"] == 8
    assert trf["frames_per_call"] == pool["streams"] * pool["chunk"]
    assert trf["session_calls"] * pool["chunk"] == pool["loop_frames"]
    assert cfg["reduced"] == [] and cfg["step"]["pgo"] is False


def test_the_program_is_correct_and_the_control_is_not(reading):
    assert reading["correct"], reading["program"]
    assert reading["program"]["streams"] == S
    assert not reading["control_correct"], reading["control"]


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="ROADMAP 3b: config 3's back end (the port's and the JAX package's) drifts "
                          "past the 1.797 su ATE guarantee on one stream at 4 frames a call")
def test_the_program_is_correct_at_four_frames_a_stream_and_call(rendered):
    result, st = harness.run_cell(CELL, SEED, 45.0, False, torch.device("cpu"), time.perf_counter(),
                                  overrides=small(4), log=lambda s: None)
    assert result["correct"], st["nums"]


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_caught(reading, fault):
    f = reading["faults"][fault]
    assert not f["correct"], (fault, f["nums"])
