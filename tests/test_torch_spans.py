"""The port's spans (``utils/profiling.py``): the recorder's nesting, request
ids, self time and sync attribution; a span with neither switch on does
nothing; and the step's spans under a CPU ``torch.profiler`` and the
recorder, whose outputs stay bit for bit those of a run without either."""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aprilslam_tpu_torch.detect import DetectorParams
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu_torch.slam import SlamSystem
from aprilslam_tpu_torch.slam.taggraph import taggraph_support
from aprilslam_tpu_torch.utils import SpanRecorder, span

SYNC_TEXT = "called a synchronizing CUDA operation"  # torch's sync debug warning
# tests/test_torch_pipeline_options.py's pgo case, its out-and-back path
# stretched to 8 chunks so that both pose-graph solves run.
RES, B, CHUNKS = 384, 4, 8
OUT_AND_BACK = np.array([[0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [0.0, 0.0, 10.0]])
STEP = dict(estimator="ba", ba_schedule="chunk", pgo=True, pgo_loop_gap=4, graph_capacity=16,
            ba_keyframes=16, ba_obs=512, init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3)
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
STAGES = ("stage_threshold", "stage_ccl", "stage_quads", "stage_decode", "stage_refine")
# Spans per chunk of B frames under the chunk schedule with pgo; the two
# solves' spans open only when their gates pass.
PER_CHUNK = {"slam.step": 1, "slam.front": 1, "slam.detect": 1, "slam.pnp": 1, "slam.back": 1,
             "slam.pre_localize": 1, "slam.scan": 1, "slam.scan.graph": B, "slam.scan.keyframe": B,
             "slam.scan.pgo": B, "slam.ba": 1, "slam.taggraph": 1, "slam.reloc": 1,
             "slam.observability": 1, **{s: 1 for s in STAGES}}
PROFILED = (6, 7)  # the last chunks, run under the profiler too


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_the_recorder_nests_spans_with_parents_requests_and_self_time():
    with SpanRecorder() as rec:
        for _ in range(2):
            with span("a"):
                with span("b"):
                    time.sleep(0.002)
                with span("c"):
                    with span("b"):
                        pass
                time.sleep(0.001)
    names = [r[0] for r in rec.records]
    assert names == ["a", "b", "c", "b"] * 2
    parents = [None if r[1] is None else names[r[1]] for r in rec.records]
    assert parents == [None, "a", "a", "c"] * 2
    assert [r[2] for r in rec.records] == [0] * 4 + [4] * 4  # the outermost span's index
    assert all(r[4] >= r[3] for r in rec.records)
    s = rec.summary()
    assert {k: v["calls"] for k, v in s.items()} == {"a": 2, "b": 4, "c": 2}
    assert {k: v["parent"] for k, v in s.items()} == {"a": None, "b": "a", "c": "a"}
    ns = lambda i: rec.records[i][4] - rec.records[i][3]  # noqa: E731
    assert s["a"]["self_s"] == pytest.approx((ns(0) - ns(1) - ns(2) + ns(4) - ns(5) - ns(6)) * 1e-9)
    assert s["a"]["host_s"] >= 0.006 and s["a"]["self_s"] >= 0.002
    assert s["c"]["self_s"] == pytest.approx((ns(2) - ns(3) + ns(6) - ns(7)) * 1e-9)
    assert None not in s and all(v["syncs"] == 0 for v in s.values())


def test_one_recorder_at_a_time_and_only_its_own_thread():
    with SpanRecorder() as rec:
        with pytest.raises(RuntimeError):
            with SpanRecorder():
                pass
        other = threading.Thread(target=lambda: span("elsewhere").__enter__())
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        with span("here"):
            pass
    assert [r[0] for r in rec.records] == ["here"]
    with SpanRecorder():  # the first one let go on exit
        pass


def test_a_span_with_neither_switch_on_records_nothing_and_dispatches_no_op():
    assert not torch._C._autograd._profiler_enabled()
    with OpCount() as c:
        for _ in range(10):
            with span("slam.step"):
                pass
    assert c.n == 0
    with OpCount() as c:
        with span("slam.step"):
            torch.ones(3) + 1
    with OpCount() as bare:
        torch.ones(3) + 1
    assert c.n == bare.n


def test_syncs_count_against_the_innermost_open_span(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda message, *args: shown.append(str(message)))
    filters, show = list(warnings.filters), warnings.showwarning
    with SpanRecorder(syncs=True) as rec:
        assert modes == ["warn"]
        warnings.warn(SYNC_TEXT)  # outside every span
        with span("slam.scan"):
            warnings.warn(SYNC_TEXT)
            with span("slam.scan.graph"):
                for _ in range(3):
                    warnings.warn(SYNC_TEXT)  # the same line: each one counts
            with span("slam.scan.pgo"):
                pass
            warnings.warn("not a sync")  # shown as before
    assert modes == ["warn", 0] and shown == ["not a sync"]
    assert warnings.filters == filters and warnings.showwarning is show
    s = rec.summary()
    assert {k: v["syncs"] for k, v in s.items()} == {
        "slam.scan": 1, "slam.scan.graph": 3, "slam.scan.pgo": 0, None: 1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pgo chunk-schedule step over CHUNKS chunks, twice from its initial
    state: once with neither switch on, once with every chunk under a
    recorder and the chunks of PROFILED under the CPU profiler as well.
    Returns (plain outputs, recorded outputs, each chunk's recorder summary,
    the profiled chunks' ``user_annotation`` ranges, each chunk's taggraph
    gate read from the state after it, each chunk's pending loop edges)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = SceneConfig.from_file()
        cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
        tr = trajectory.scripted_waypoints(CHUNKS * B, OUT_AND_BACK)
        f = render_frames(scene_tensors(cfg, device="cpu"), tr.positions, tr.rotations, cam.inv_matrix,
                          RES, RES, 2, device="cpu")
        u8 = (f * 255.0).clamp(0, 255).to(torch.uint8)
        chunks = [u8[k * B:(k + 1) * B] for k in range(CHUNKS)]
        plain = SlamSystem(cam, detector_params=PARAMS, device="cpu", **STEP)
        want = [plain.process(c) for c in chunks]
        system = SlamSystem(cam, detector_params=PARAMS, device="cpu", **STEP)
        got, summaries, gates, pending = [], [], [], []

        def run(k):
            _g, _ba, pgo_s, _tg = system.state
            solved = int(pgo_s.n_solved)
            with SpanRecorder() as rec:
                got.append(system.process(chunks[k]))
            summaries.append(rec.summary())
            _g, ba, pgo_s, tg = system.state
            gates.append(bool(((taggraph_support(tg) >= 24.0) & ba.lm_active).any() & (ba.anchor >= 0)))
            pending.append(int(pgo_s.n_loops) > solved)

        for k in range(PROFILED[0]):
            run(k)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for k in PROFILED:
                run(k)
        path = tmp_path_factory.mktemp("spans") / "trace.json"
        prof.export_chrome_trace(str(path))
        ranges = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "user_annotation"]
    finally:
        torch.set_num_threads(prev)
    return want, got, summaries, ranges, gates, pending


def _expected(gates, pending, ks):
    want = {n: c * len(ks) for n, c in PER_CHUNK.items()}
    want["slam.pgo_solve"] = sum(pending[k] for k in ks)
    want["slam.taggraph.solve"] = sum(gates[k] for k in ks)
    return {n: c for n, c in want.items() if c}


def test_every_span_of_the_step_is_a_profiler_range_and_a_record(runs):
    _want, _got, summaries, ranges, gates, pending = runs
    assert any(pending) and any(gates)  # both solves' spans are exercised
    for k, s in enumerate(summaries):
        assert {n: v["calls"] for n, v in s.items()} == _expected(gates, pending, [k]), k
    counts = {}
    for e in ranges:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == _expected(gates, pending, PROFILED)
    assert sorted(n for n in counts if n.startswith("stage_")) == sorted(STAGES)
    assert all(n.startswith("slam.") for n in counts if not n.startswith("stage_"))
    s = summaries[PROFILED[-1]]
    assert {n: v["parent"] for n, v in s.items() if v["parent"] in ("slam.step", "slam.front")} == {
        "slam.front": "slam.step", "slam.back": "slam.step", "slam.detect": "slam.front",
        "slam.pnp": "slam.front"}
    assert s["slam.taggraph.solve"]["parent"] == "slam.taggraph"
    assert s["slam.scan.graph"]["parent"] == "slam.scan" and s["slam.ba"]["parent"] == "slam.back"


def test_the_step_outputs_are_bit_identical_with_spans_recorded(runs):
    want, got, *_ = runs
    for w, g in zip(want, got):
        for name in w.__dataclass_fields__:
            a, b = getattr(w, name), getattr(g, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.numpy().tobytes() == b.numpy().tobytes(), name
