"""The readings of the program's own spans (``perfbench/spans.py``) and
their metric readers, on hand-worked traces and records."""

import re
import warnings

import pytest

from perfbench import harness, spans, trace
from perfbench.trace import WINDOW, reduce_trace

SYNC_TEXT = "called a synchronizing CUDA operation"


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# A window of 1000 us: slam.step [10, 910] holds slam.front [20, 100] (with
# the detector's stage_ccl [30, 60]) and slam.back [100, 900], which holds
# slam.scan [200, 400] (with slam.scan.graph [250, 300]) and slam.ba [500, 600].
EVENTS = [
    ev("user_annotation", WINDOW, 0, 1000),
    ev("user_annotation", "slam.step", 10, 900),
    ev("user_annotation", "slam.front", 20, 80),
    ev("user_annotation", "stage_ccl", 30, 30),
    ev("user_annotation", "slam.back", 100, 800),
    ev("user_annotation", "slam.scan", 200, 200),
    ev("user_annotation", "slam.scan.graph", 250, 50),
    ev("user_annotation", "slam.ba", 500, 100),
    ev("user_annotation", "slam.elsewhere", 260, 10, tid=2),  # another thread: not read
    ev("gpu_user_annotation", "slam.scan", 255, 100, tid=7),  # the card's copy: not read
    ev("cpu_op", "aten::add", 520, 10),
    ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=1),  # stage_ccl, in slam.front
    ev("cuda_runtime", "cudaLaunchKernel", 260, 1, corr=2),  # slam.scan.graph
    ev("cuda_runtime", "cudaMemcpyAsync", 350, 1, corr=3),  # slam.scan
    ev("cuda_runtime", "cudaLaunchKernel", 450, 1, corr=4),  # slam.back
    ev("cuda_runtime", "cudaLaunchKernel", 950, 1, corr=5),  # outside every span
    ev("kernel", "ccl_local", 50, 10, tid=7, corr=1),
    ev("kernel", "graph_kernel", 270, 40, tid=7, corr=2),
    ev("gpu_memcpy", "Memcpy DtoH", 360, 20, tid=7, corr=3),
    ev("kernel", "back_kernel", 460, 60, tid=7, corr=4),
    ev("kernel", "late", 955, 5, tid=7, corr=5),
    ev("gpu_memset", "Memset", 980, 10, tid=7, corr=6),  # no launch on record
]


def test_device_time_goes_to_the_innermost_span_open_at_the_launch():
    r = spans.reduce_spans(EVENTS)
    assert r["span_device_s"] == pytest.approx({
        "slam.front": 10e-6, "slam.scan.graph": 40e-6, "slam.scan": 20e-6, "slam.back": 60e-6,
        None: 15e-6})
    t = reduce_trace(EVENTS)
    assert sum(r["span_device_s"].values()) == pytest.approx(sum(t["stage_s"].values()) + t["outside_stage_s"])
    assert r["span_parents"] == {"slam.step": None, "slam.front": "slam.step", "slam.back": "slam.step",
                                 "slam.scan": "slam.back", "slam.scan.graph": "slam.scan",
                                 "slam.ba": "slam.back"}


def test_idle_pieces_split_at_span_boundaries_and_sum_to_the_idle_time():
    r = spans.reduce_spans(EVENTS)
    # Busy [50,60] [270,310] [360,380] [460,520] [955,960] [980,990]; the
    # idle stretches, cut at 10 20 100 200 250 300 400 500 600 900 910:
    want = {
        None: (10 + 45 + 20 + 10) * 1e-6,  # [0,10] [910,955] [960,980] [990,1000]
        "slam.step": (10 + 10) * 1e-6,  # [10,20] [900,910]
        "slam.front": (30 + 40) * 1e-6,  # [20,50] [60,100]
        "slam.back": (100 + 60 + 300) * 1e-6,  # [100,200] [400,460] [600,900]
        "slam.scan": (50 + 50 + 20) * 1e-6,  # [200,250] [310,360] [380,400]
        "slam.scan.graph": 20e-6,  # [250,270]
        "slam.ba": 80e-6,  # [520,600]
    }
    assert r["span_idle_s"] == pytest.approx(want)
    t = reduce_trace(EVENTS)
    assert sum(r["span_idle_s"].values()) == pytest.approx(t["window_s"] - t["busy_s"])
    assert spans.subtree(r["span_parents"], "slam.back") == {"slam.back", "slam.scan", "slam.scan.graph",
                                                             "slam.ba"}


def test_the_existing_keys_of_the_trace_reduction_are_unchanged():
    plain = reduce_trace(EVENTS)
    spans_only = spans.reduce_spans(EVENTS)
    assert not set(plain) & set(spans_only)
    merged = {**plain, **spans_only}
    assert {k: merged[k] for k in plain} == plain
    assert set(plain) == {"window_s", "busy_s", "kernels", "stage_s", "outside_stage_s", "ccl_s", "breakdown"}


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_each_reader_does_its_arithmetic():
    parents = {"slam.step": None, "slam.back": "slam.step", "slam.scan": "slam.back",
               "slam.scan.graph": "slam.scan", "slam.scan.pgo": "slam.scan", "slam.ba": "slam.back",
               "slam.pgo_solve": "slam.back", "slam.taggraph": "slam.back",
               "slam.taggraph.solve": "slam.taggraph"}
    calls = {"slam.scan": 12, "slam.ba": 12, "slam.pgo_solve": 3, "slam.taggraph": 12, "slam.taggraph.solve": 9}
    host = {"slam.scan": 6.0, "slam.ba": 1.2, "slam.pgo_solve": 0.6, "slam.taggraph": 1.8}
    rec = {
        "frames_per_call": 8, "span_calls": 12,
        "spans": {n: {"calls": calls.get(n, 12), "host_s": host.get(n, 0.0), "self_s": 0.0, "syncs": 0,
                      "parent": p} for n, p in parents.items()},
        "span_syncs": {"slam.scan": 24, "slam.scan.graph": 2400, "slam.scan.pgo": 0, "slam.ba": 100, None: 12},
        "trace": {"frames": 16, "window_s": 4.0, "span_parents": parents,
                  "span_device_s": {"slam.back": 0.002, "slam.scan.graph": 0.004, "slam.ba": 0.01,
                                    "slam.step": 0.5, None: 1.0},
                  "span_idle_s": {"slam.scan": 0.5, "slam.scan.graph": 1.5, "slam.back": 1.0, None: 0.5}},
    }
    assert read("scan.host_ms_per_chunk", rec) == pytest.approx(500.0)
    assert read("scan.host_syncs_per_chunk", rec) == pytest.approx(202.0)
    assert read("ba.host_ms_per_chunk", rec) == pytest.approx(100.0)
    assert read("loop.host_ms_per_chunk", rec) == pytest.approx(200.0)
    assert read("taggraph.solves_per_chunk", rec) == pytest.approx(0.75)
    assert read("backend.device_ms_per_chunk", rec) == pytest.approx(8.0)  # 16 ms over 2 chunks
    assert read("scan.idle_pct", rec) == pytest.approx(50.0)
    del rec["spans"]["slam.pgo_solve"], rec["spans"]["slam.taggraph.solve"]  # no solve ran
    assert read("loop.host_ms_per_chunk", rec) == pytest.approx(150.0)
    assert read("taggraph.solves_per_chunk", rec) == 0.0
    table = spans.table(rec, 8)
    assert table["slam.scan.graph"]["syncs"] == 200.0 and table["None"]["syncs"] == 1.0
    assert table["slam.scan"]["host_ms"] == pytest.approx(500.0)
    assert table["slam.ba"]["device_ms"] == pytest.approx(5.0)


@pytest.mark.parametrize("metric", [m["name"] for m in spans.METRICS])
def test_each_reader_reads_nothing_from_a_program_without_spans(metric):
    assert read(metric, {"height": 1000, "width": 1000, "decimate": 2}) is None
    # A parent program's traced run: the trace holds no slam.* span, no passes ran.
    parent = {"frames_per_call": 8, "trace": {"frames": 16, "window_s": 4.0, **spans.reduce_spans(
        [ev("user_annotation", WINDOW, 0, 100), ev("kernel", "k", 10, 5, tid=7, corr=1)])}}
    assert read(metric, parent) is None


def test_the_metrics_would_meet_the_contract_and_join_the_cell_only_while_hooked():
    names = {m["name"] for m in harness.benchmark()["per_layer"]}
    for m in spans.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", m["name"]) and m["name"] not in names
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"]) and m["better"] == "lower"
        assert 1 <= len(m["layer"]) <= 200 and m["moves"] == "fps"
        assert m["source"] in ("device_trace", "program_span", "program_counter")
    before = [m["name"] for m in harness.cell_metrics("loop_1k.closure", "per_layer")]
    reduce_fn, traced_fn = trace.reduce_trace, harness.traced
    with spans.hooked():
        during = [m["name"] for m in harness.cell_metrics("loop_1k.closure", "per_layer")]
        assert trace.reduce_trace is not reduce_fn and harness.traced is not traced_fn
        assert [m["name"] for m in harness.cell_metrics("loop_1k.closure", "end_to_end")] == ["fps", "setup_s"]
    assert during == before + [m["name"] for m in spans.METRICS]
    assert trace.reduce_trace is reduce_fn and harness.traced is traced_fn
    assert [m["name"] for m in harness.cell_metrics("loop_1k.closure", "per_layer")] == before


class FakeCaller:
    """Session traffic of 12 calls of 8 frames; each call opens the step's
    spans and makes one sync in the scan and one outside every span."""

    session, F = 12, 8

    def __init__(self):
        self.calls = []

    def call(self, k):
        from aprilslam_tpu_torch.utils import span

        self.calls.append(k)
        with span("slam.step"):
            with span("slam.back"):
                with span("slam.scan"):
                    warnings.warn(SYNC_TEXT)
        warnings.warn(SYNC_TEXT)


def test_the_two_passes_run_a_session_each_from_a_boundary():
    caller = FakeCaller()
    out = spans.passes(caller, {"trace": {"count_calls": 12}}, 30)
    assert caller.calls == list(range(36, 48)) + list(range(60, 72))  # as harness.traced steps
    assert out["span_calls"] == 12 and len(out["span_steps_s"]) == 12
    assert {n: v["calls"] for n, v in out["spans"].items()} == {"slam.step": 12, "slam.back": 12, "slam.scan": 12}
    assert out["spans"]["slam.scan"]["parent"] == "slam.back"
    assert out["span_syncs"] == {"slam.step": 0, "slam.back": 0, "slam.scan": 12, None: 12}
