"""The PyTorch port stands alone: no jax, no JAX package, its own data files."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.ops import ccl
from aprilslam_tpu_torch.slam import SlamSystem, build_slam_step

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "aprilslam_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
MODULES = sorted(
    str(Path(f).with_suffix("")).replace("/", ".").removesuffix(".__init__") for f in PORT_FILES
)
DATA_FILES = [
    "families/data/tag36h11.npz",
    "families/data/tagStandard41h12.npz",
    "sim/data/default_scene.json",
]
# The native runtime's sources: the port builds its own copies.
NATIVE_SOURCES = ["runtime/rasterizer.cpp", "runtime/video_io.cpp"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'aprilslam_tpu' or k.startswith('aprilslam_tpu.') for k in sys.modules)\n"
        # The card's machine has no matplotlib: viz/ imports it for a figure only.
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


TOOLS = ["tools/ccl_ab.py", "tools/scaling_bench_torch.py", "tools/scaling_proc_worker_torch.py",
         "tools/profile_step_torch.py", "tools/probe_robustness_torch.py", "tools/probe_detect_stages_torch.py",
         "tools/probe_ascii_torch.py", "tools/probe_ate_dist_torch.py", "tools/probe_tail_split_torch.py",
         "tools/probe_negev_torch.py", "tools/probe_pgo_cost_torch.py", "tools/probe_pgo_iters_torch.py",
         "tools/probe_quads_torch.py", "tools/probe_quads_batch_torch.py"]


@pytest.mark.parametrize("rel", PORT_FILES + ["bench_torch.py", "chip_smoke.py"] + TOOLS)
def test_no_jax_import(rel):
    roots = _imported_roots(ROOT / rel)
    assert not roots & {"jax", "jaxlib", "aprilslam_tpu"}, (rel, roots)


@pytest.mark.parametrize("rel", DATA_FILES + NATIVE_SOURCES)
def test_data_files_are_copies(rel):
    assert (PORT / rel).read_bytes() == (ROOT / "aprilslam_tpu" / rel).read_bytes()


def test_kf_proc_gpu_refuses_more_processes_than_cards(monkeypatch):
    """``--platform gpu`` checks the card count before it starts a worker."""
    spec = importlib.util.spec_from_file_location("scaling_bench_torch", ROOT / "tools" / "scaling_bench_torch.py")
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)

    def no_spawn(*a, **k):
        raise AssertionError("a worker was started")

    monkeypatch.setattr(sb.subprocess, "Popen", no_spawn)
    args = sb.parse_args(["--mode", "kf-proc", "--platform", "gpu",
                          "--processes", f"1,{torch.cuda.device_count() + 1}"])
    with pytest.raises(ValueError, match="one card per process"):
        sb.kf_proc_bench(args)


@pytest.mark.parametrize("argv", [
    ["tools/scaling_bench_torch.py", "--mode", "lm"],
    ["tools/scaling_bench_torch.py", "--mode", "kf"],
    ["tools/scaling_bench_torch.py", "--mode", "kf-proc", "--processes", "1"],
    ["tools/scaling_proc_worker_torch.py", "--num-processes", "1", "--process-id", "0", "--port", "1"],
    ["tools/profile_step_torch.py"],
    ["tools/probe_robustness_torch.py"],
    ["tools/probe_detect_stages_torch.py"],
    ["tools/probe_ascii_torch.py"],
    ["tools/probe_ate_dist_torch.py"],
    ["tools/probe_tail_split_torch.py"],
    ["tools/probe_negev_torch.py"],
], ids=["scaling-lm", "scaling-kf", "scaling-kf-proc", "proc-worker", "profile-step", "probe-robustness",
        "probe-detect-stages", "probe-ascii", "probe-ate-dist", "probe-tail-split", "probe-negev"])
def test_tools_exit_nonzero_without_a_gpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout
    assert not any(line.startswith("{") for line in res.stdout.splitlines()), res.stdout
    assert "CUDA" in res.stderr or "card" in res.stderr, res.stderr[-2000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    cam = PinholeCamera.from_fov(64, 64, 45.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cam)


@pytest.mark.parametrize("kwargs", [
    dict(estimator="joint"),
    dict(ba_schedule="frame"),
    dict(pgo=True),
    dict(dist_coeffs=np.zeros(5, np.float32)),
])
def test_unported_options_raise(kwargs):
    """Every option of the JAX step is ported: none of these raises any more,
    and each builds the state the JAX package's ``init`` builds."""
    cam = PinholeCamera.from_fov(64, 64, 45.0)
    _step, init = build_slam_step("tagStandard41h12", cam, 10.0, device="cpu", **kwargs)
    # The default estimator is "joint", whose state is the graph alone (pgo
    # needs estimator="ba" and is ignored otherwise, as in JAX).
    assert type(init()).__name__ == "GraphState"


def test_ccl_wrapper_dispatch():
    """CPU tensors take the plain version without counting a launch; other
    non-CUDA devices are refused."""
    t = torch.zeros((1, 4, 4), dtype=torch.int8)
    before = ccl.ccl_launches
    assert torch.equal(ccl.connected_components(t), ccl.connected_components_plain(t))
    assert ccl.ccl_launches == before
    with pytest.raises(ValueError):
        ccl.connected_components(torch.zeros((1, 4, 4), dtype=torch.int8, device="meta"))
