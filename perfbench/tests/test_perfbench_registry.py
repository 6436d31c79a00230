"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, traffic mix and metric by its name."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[kind]]
        assert len(got) == len(set(got))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in cells:
        mine = {m["name"] for m in harness.cell_metrics(cell, "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.cell_metrics(cell, "per_layer")
        assert layer and all(m["moves"] in mine for m in layer)
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_harness_finds_each_cell_by_name(cell):
    w = harness.find_cell(cell)
    cfg, trf = harness.config(w["config"]), harness.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert trf["pool"]["frames"] % trf["frames_per_call"] == 0
    assert set(cfg["reduced"]) <= set(cfg) | {"resolution"}


TRAFFIC = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", TRAFFIC)
def test_each_traffic_mix_is_data_whose_entry_and_pool_are_found_by_name(mix):
    """A mix names its entry and its pool kind; each is a module of its own."""
    trf = harness.traffic(mix)
    entry = harness.load("entries", trf["entry"])
    assert callable(entry.Program) and callable(entry.judge_answers) and callable(entry.alter)
    assert isinstance(entry.FRAME_FLAGS, tuple)
    pos, rot = harness.load("pools", trf["pool"]["kind"]).poses(trf["pool"], 2**31 + 3)
    assert pos.shape == rot.shape == (trf["pool"]["frames"], 3)
    with pytest.raises(KeyError):
        harness.load("entries", "no_such_entry")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = harness.metric_reader(metric)
    assert callable(read)
    if metric in ("fps", "setup_s", "call_p95_ms"):
        return
    assert read({"height": 1000, "width": 1000, "decimate": 2}) is None


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no_such.cell")
