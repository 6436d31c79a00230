"""The PyTorch port stands alone: no jax, no JAX package, its own data files."""

import ast
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


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'aprilslam_tpu' or k.startswith('aprilslam_tpu.') for k in sys.modules)\n"
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


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py", "tools/ccl_ab.py"])
def test_no_jax_import(rel):
    roots = _imported_roots(ROOT / rel)
    assert not roots & {"jax", "jaxlib", "aprilslam_tpu"}, (rel, roots)


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_files_are_copies(rel):
    assert (PORT / rel).read_bytes() == (ROOT / "aprilslam_tpu" / rel).read_bytes()


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
    cam = PinholeCamera.from_fov(64, 64, 45.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_slam_step("tagStandard41h12", cam, 10.0, device="cpu", **kwargs)


def test_ccl_wrapper_dispatch():
    """CPU tensors take the plain version without counting a launch; other
    non-CUDA devices are refused."""
    t = torch.zeros((1, 4, 4), dtype=torch.int8)
    before = ccl.ccl_launches
    assert torch.equal(ccl.connected_components(t), ccl.connected_components_plain(t))
    assert ccl.ccl_launches == before
    with pytest.raises(ValueError):
        ccl.connected_components(torch.zeros((1, 4, 4), dtype=torch.int8, device="meta"))
