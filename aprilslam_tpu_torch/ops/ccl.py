"""Connected-component labelling: the CUDA kernel's wrapper and its plain version.

Port of ``aprilslam_tpu/ops/ccl_pallas.py`` (the one Pallas kernel of the
JAX package). ``connected_components`` launches the hand-written Hopper
kernel in ``csrc/ccl.cu`` for a CUDA tensor and takes the plain PyTorch
version only for a tensor on the CPU; it never falls back from one to the
other. Both return the converged labels: each known pixel gets the minimum
linear index of its 4-connected same-colour component, unknown (-1) pixels
get the sentinel ``H * W``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, from the
source in the checkout, into ``build/aprilslam_tpu_torch/`` beside the
package, and rebuilt when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ccl.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aprilslam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches through the wrapper (one per labelled batch).
ccl_launches = 0
# The frame is a grid dimension of at most 65535 blocks (gridDim.z of
# ccl_local, gridDim.y of ccl_border and ccl_resolve); every offset into the
# batch is a size_t, so nothing else bounds B.
MAX_FRAMES = 65535

_lib = None
# The service's handler threads may make the first call together: one
# builds and loads the library, the others wait for it.
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CCL kernel cannot be built")


def build_ccl(verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/ccl.cu`` unless a build of this exact source exists.

    Returns (shared library path, seconds spent compiling; 0.0 if cached).
    Raises when nvcc is missing or the compile fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"ccl_{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0
    cmd = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, lib_path)
    return lib_path, seconds


def _library():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib_path, _ = build_ccl()
                lib = ctypes.CDLL(str(lib_path))
                lib.aprilslam_ccl.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                lib.aprilslam_ccl.restype = ctypes.c_int
                _lib = lib
    return _lib


def connected_components(trinary: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int8 trinary map -> (B, H, W) int32 converged labels.

    CUDA tensors go to the kernel (it must be contiguous int8 of rank 3);
    CPU tensors to :func:`connected_components_plain`."""
    global ccl_launches
    if trinary.device.type == "cpu":
        return connected_components_plain(trinary)
    if trinary.device.type != "cuda":
        raise ValueError(f"unsupported device {trinary.device}")
    if trinary.dtype != torch.int8 or trinary.dim() != 3 or not trinary.is_contiguous():
        raise ValueError(
            "the CCL kernel takes a contiguous (B, H, W) int8 tensor, got "
            f"{tuple(trinary.shape)} {trinary.dtype} contiguous={trinary.is_contiguous()}"
        )
    B, H, W = trinary.shape
    if H * W >= 2**31 - 1:
        raise ValueError("frames of 2**31 - 1 pixels or more do not fit int32 labels")
    if B > MAX_FRAMES:
        raise ValueError(f"the kernel's grid takes at most {MAX_FRAMES} frames per call, got {B}")
    lib = _library()
    labels = torch.empty((B, H, W), dtype=torch.int32, device=trinary.device)
    with torch.cuda.device(trinary.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aprilslam_ccl(trinary.data_ptr(), labels.data_ptr(), B, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"CCL kernel launch failed: cudaError_t {rc}")
    ccl_launches += 1
    return labels


def _segmented_min(lab: torch.Tensor, seg: torch.Tensor, dim: int) -> torch.Tensor:
    """Min over each run along ``dim``; ``seg`` numbers the runs (non-decreasing).

    Offsetting by run number turns the segmented scan into a plain cummin:
    later runs sit far below earlier ones, so no value crosses a run start."""
    big = 1 << 32
    fwd = torch.cummin(lab - seg * big, dim=dim).values + seg * big
    rseg = seg.amax(dim=dim, keepdim=True) - seg.flip(dim)
    bwd = (torch.cummin(lab.flip(dim) - rseg * big, dim=dim).values + rseg * big).flip(dim)
    return torch.minimum(fwd, bwd)


def connected_components_plain(trinary: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch labelling with the kernel's contract, iterated to convergence.

    Rounds of segmented min-scans along rows and columns plus one pointer
    jump (labels are pixel indices, so a label is a pointer), until no label
    changes."""
    B, H, W = trinary.shape
    N = H * W
    known = trinary >= 0
    lin = torch.arange(N, dtype=torch.int64, device=trinary.device).reshape(H, W)
    lab = torch.where(known, lin, N)
    same_r = torch.zeros_like(known)
    same_r[:, :, 1:] = (trinary[:, :, 1:] == trinary[:, :, :-1]) & known[:, :, 1:]
    same_c = torch.zeros_like(known)
    same_c[:, 1:, :] = (trinary[:, 1:, :] == trinary[:, :-1, :]) & known[:, 1:, :]
    seg_r = torch.cumsum(~same_r, dim=2)
    seg_c = torch.cumsum(~same_c, dim=1)
    while True:
        prev = lab
        lab = _segmented_min(lab, seg_r, dim=2)
        lab = _segmented_min(lab, seg_c, dim=1)
        flat = lab.reshape(B, N)
        flat = torch.minimum(flat, torch.gather(flat, 1, flat.clamp(max=N - 1)))
        lab = flat.reshape(B, H, W)
        if torch.equal(lab, prev):
            break
    return torch.where(known, lab, N).to(torch.int32)
