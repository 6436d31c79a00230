"""Time versions of the CCL kernel against each other on one GPU.

    python3 tools/ccl_ab.py --source NAME=PATH [--source NAME=PATH ...]

Builds the checkout's ``aprilslam_tpu_torch/csrc/ccl.cu`` (as ``checkout``)
and every other ``ccl.cu`` given with ``--source`` (an earlier version of
the kernel, or a copy with other tile constants), all ``nvcc`` runs at once.

Each build is held bit for bit against the plain version, then all builds
are timed with CUDA events in turns (A, B, ..., then back; device time from
a replayed CUDA graph, and back-to-back eager calls), and each launch's
device time is read with torch.profiler. The inputs: the rendered
main-path input at 8x500x500, block-random 8x500x500, serpentine 1x500x500,
all-white 8x500x500 and chip_smoke.py's stress inputs. Prints one JSON
line per build and the card line; exits non-zero without a GPU or on any
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from aprilslam_tpu_torch.ops import ccl, nvcc  # noqa: E402

OUT = ROOT / "build" / "ccl_ab"


def build_all(sources: dict[str, Path]) -> dict[str, Path]:
    """nvcc every source at once; name -> shared library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"{name}.so"
        cmd = [nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}:\n{out}")
        print(f"nvcc {name}:\n{out}", file=sys.stderr)
        libs[name] = lib
    return libs


def launcher(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    lib.aprilslam_ccl.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aprilslam_ccl.restype = ctypes.c_int

    def run(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
        rc = lib.aprilslam_ccl(t.data_ptr(), out.data_ptr(), *t.shape,
                               torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"launch failed: cudaError_t {rc}")
        return out

    return run


def rendered_trinary(dev) -> torch.Tensor:
    """chip_smoke.py's main-path input: the first chunk of 8 frames."""
    from aprilslam_tpu_torch.detect.threshold import (
        adaptive_threshold_with_levels, decimate, to_grayscale)
    from aprilslam_tpu_torch.geometry import PinholeCamera
    from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory

    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(cs.RES, cs.RES, cfg.fov_y)
    traj = trajectory.monte_carlo(cs.BATCH, seed=3)
    frames = torch.clamp(render_frames(scene_tensors(cfg, device=dev), traj.positions, traj.rotations,
                                       cam.inv_matrix, cs.RES, cs.RES, 2, device=dev) * 255.0,
                         0, 255).to(torch.uint8)
    dec = decimate(to_grayscale(frames), 2)
    return adaptive_threshold_with_levels(dec, tile=4, min_contrast=0.08)[0].contiguous()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another ccl.cu")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = cs.card_line()
    dev = torch.device("cuda")
    sources = {"checkout": ccl.SOURCE}
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
    runs = {name: launcher(lib) for name, lib in build_all(sources).items()}

    rng = np.random.default_rng(0)
    timed = {
        "rendered_chunk0_8x500x500": rendered_trinary(dev),
        "block_random_8x500x500": cs.block_random(rng, 8, 500, 500),
        "serpentine_1x500x500": cs.serpentine(500, 500),
        "all_white_8x500x500": np.ones((8, 500, 500), np.int8),
        **cs.stress_cases(rng),
    }
    inputs = {k: torch.as_tensor(v, device=dev).contiguous() for k, v in timed.items()}
    for case, t in inputs.items():
        want = ccl.connected_components_plain(t)
        for name, run in runs.items():
            cs.check(torch.equal(run(t), want), f"{name} != plain on {case}")
    device_ms = {name: {case: [] for case in timed} for name in runs}
    eager_ms = {name: {case: [] for case in timed} for name in runs}
    order = list(runs)
    for turn in range(args.turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            for case in timed:
                call = lambda: runs[name](inputs[case])
                device_ms[name][case].append(cs.time_cuda_graph(call))
                eager_ms[name][case].append(cs.time_cuda(call, 200))
    for name, run in runs.items():
        split = {case: cs.launch_split(lambda: run(inputs[case])) for case in timed}
        print(json.dumps({"build": name, "card": card, "device_ms": device_ms[name], "eager_ms": eager_ms[name],
                          "launch_ms": split}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
