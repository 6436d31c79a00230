"""Building and loading the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, cached under
``build/aprilslam_tpu_torch/`` beside the package by the hash of its source
(``<stem>_<sha>.so``, rebuilt when the source changes), and loaded with
ctypes on first use.
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
from collections.abc import Callable
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aprilslam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: Path, verbose: bool = False) -> tuple[Path, float]:
    """Compile ``source`` unless a build of this exact source exists.

    Returns (shared library path, seconds spent compiling; 0.0 if cached).
    ``verbose`` prints ptxas's registers and shared memory per kernel.
    Raises when nvcc is missing or the compile fails."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0
    cmd = [nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(source)]
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


class KernelLibrary:
    """One kernel source, built and loaded once per process on first use.

    ``bind`` declares the argtypes and restype of the library's functions.
    The service's handler threads may make the first call together: one
    builds and loads the library, the others wait for it."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / name
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> tuple[Path, float]:
        return build(self.source, verbose)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.build()[0]))
                    self._bind(lib)
                    self._lib = lib
        return self._lib
