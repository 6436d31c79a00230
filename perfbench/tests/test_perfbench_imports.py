"""Nothing the benchmark runs imports the JAX stack, the JAX package or the
repo's other harnesses, and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_a_forbidden_module(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    mods = imported_modules(path)
    assert not {m for m in mods if m.split(".")[0] == "aprilslam_tpu_torch"}
    assert all(m.split(".")[0] in ("torch", "numpy", "__future__") or m.startswith("perfbench.reference")
               for m in mods), mods


def test_the_check_compares_whole_top_level_names():
    mods = {"jax.numpy": 1, "aprilslam_tpu.slam": 1, "aprilslam_tpu_torch.slam": 1, "tools.x": 1,
            "bench_torch": 1, "jaxtyping": 1, "toolsmith": 1, "torch": 1}
    assert harness.forbidden_modules(mods) == ["aprilslam_tpu", "bench_torch", "jax", "tools"]
    assert harness.forbidden_modules({"aprilslam_tpu_torch": 1, "chip_smoke_x": 1}) == []
    assert harness.forbidden_modules({"chip_smoke": 1, "jaxlib.xla": 1, "flax": 1}) == [
        "chip_smoke", "flax", "jaxlib"]


def test_a_run_loads_no_forbidden_module():
    """Import what a run imports, the program included, in a fresh process."""
    code = ("import sys; sys.path.insert(0, %r); import perfbench.harness as h, perfbench.run, "
            "perfbench.control; from perfbench.inputs import render; "
            "import aprilslam_tpu_torch.slam, aprilslam_tpu_torch.detect, aprilslam_tpu_torch.pose; "
            "print(h.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_without_the_program_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "loop_1k.closure", "--seed",
                          "2147483650", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
