"""The port's runtime helpers: checkpoint/resume of every SLAM state form
and the profiler trace (the spans: tests/test_torch_spans.py)."""

import dataclasses
import json
import os

import pytest
import torch

from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.slam import build_slam_step
from aprilslam_tpu_torch.utils import CheckpointManager, resolve_device, trace

FORMS = {
    "graph": dict(estimator="joint"),
    "graph_ba": dict(estimator="ba"),
    "graph_ba_pgo_taggraph": dict(estimator="ba", pgo=True),
}


def _init(kwargs):
    cam = PinholeCamera.from_fov(64, 64, 45.0)
    _step, init = build_slam_step("tagStandard41h12", cam, 10.0, graph_capacity=16,
                                  device="cpu", **kwargs)
    return init()


def _scramble(state, gen):
    """Every field filled with seeded random values of its dtype, so a
    round trip that dropped or mixed fields would show."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _scramble(v, gen)
        elif v.dtype == torch.bool:
            out[f.name] = torch.rand(v.shape, generator=gen) < 0.5
        elif v.is_floating_point():
            out[f.name] = torch.randn(v.shape, generator=gen, dtype=v.dtype)
        else:
            out[f.name] = torch.randint(-5, 1000, v.shape, generator=gen, dtype=v.dtype)
    return type(state)(**out)


def _states(state):
    return [state] if dataclasses.is_dataclass(state) else list(state)


def _assert_bit_equal(got, want):
    assert type(got) is type(want)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            _assert_bit_equal(g, w)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device, f.name
        assert g.numpy().tobytes() == w.numpy().tobytes(), f.name


@pytest.mark.parametrize("form", sorted(FORMS))
def test_checkpoint_round_trip_is_bit_equal(form, tmp_path):
    template = _init(FORMS[form])
    gen = torch.Generator().manual_seed(len(form))
    saved = (_scramble(template, gen) if dataclasses.is_dataclass(template)
             else tuple(_scramble(s, gen) for s in template))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(8, saved, metadata={"frames": 8})
    assert mgr.latest_step() == 8
    got = mgr.restore(template)
    assert type(got) is type(saved) and len(_states(got)) == len(_states(saved)) == len(_states(template))
    for g, w in zip(_states(got), _states(saved)):
        _assert_bit_equal(g, w)
    with open(tmp_path / "ckpt" / "step_8" / "metadata.json") as f:
        assert json.load(f) == {"frames": 8}
    mgr.close()


def test_checkpoint_retention_steps_and_errors(tmp_path):
    state = _init(FORMS["graph_ba"])
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    assert mgr.latest_step() is None
    gen = torch.Generator().manual_seed(0)
    saved = {}
    for step in (4, 8, 12, 16):
        saved[step] = tuple(_scramble(s, gen) for s in state)
        mgr.save(step, saved[step])
    assert sorted(os.listdir(tmp_path)) == ["step_12", "step_16"]
    assert mgr.latest_step() == 16
    for g, w in zip(mgr.restore(state, step=12), saved[12]):
        _assert_bit_equal(g, w)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=4)
    # The template decides the form: a lone graph is not a (graph, ba) pair.
    with pytest.raises(ValueError):
        mgr.restore(state[0])
    # A template of another capacity is refused, field by field.
    bigger = (dataclasses.replace(state[0], weight=torch.ones(17)), state[1])
    with pytest.raises(ValueError, match="weight"):
        mgr.restore(bigger)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_resolve_device_is_the_runtime_setup():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        return
    assert resolve_device(None).type == "cuda"
