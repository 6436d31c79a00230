"""The chaining graph's per-chunk scan: the CUDA kernel's wrapper.

``chain_graph_scan`` launches the hand-written Hopper kernel in
``csrc/chain_graph.cu`` once for a chunk of B frames: the graph update and
the pose average of every frame, with each frame's snapshot of the graph.
It takes CUDA tensors only and raises on anything the kernel does not take.
The plain version is ``slam/graph.py``'s per-frame loop of ``update_graph``
and ``estimate_pose_average``; ``slam.graph.scan_chain_graph`` takes it for
CPU tensors and this wrapper for CUDA ones, and never falls back from one to
the other.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use (see
``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .nvcc import KernelLibrary

# Kernel launches through the wrapper (one per chunk on the main path).
chain_graph_launches = 0
# The graph lives in shared memory, 139 * M + 128 bytes; 1024 slots take
# 142,464 of the 232,448 a block may have on Hopper.
MAX_CAPACITY = 1024


def _bind(lib: ctypes.CDLL) -> None:
    lib.aprilslam_chain_graph.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aprilslam_chain_graph.restype = ctypes.c_int
    lib.aprilslam_empty_launch.argtypes = [ctypes.c_void_p]
    lib.aprilslam_empty_launch.restype = ctypes.c_int


_library = KernelLibrary("chain_graph.cu", _bind)


def build_chain_graph(verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/chain_graph.cu`` unless a build of this exact source
    exists. Returns (shared library path, seconds spent compiling; 0.0 if
    cached)."""
    return _library.build(verbose)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"the chain-graph kernel takes {name} as a contiguous {shape} {dtype}, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}")


def chain_graph_scan(local, world, weight, present, updated, reference, coordinate_id, has_estimate,
                     ids, T_cam_tag, ok) -> dict[str, torch.Tensor]:
    """One launch over a chunk: the graph's fields (``GraphState``'s, M
    slots) and the chunk's ``ids`` (B, D) int32, ``T_cam_tag`` (B, D, 4, 4)
    float32 and ``ok`` (B, D) bool, all contiguous on one CUDA device.

    Returns the per-frame ``avg_T`` (B, 4, 4) (the weighted average, its
    rotation not yet projected), ``valid``, ``visible``, ``present``,
    ``weight``, ``local``, ``world``, ``coordinate_id``, ``n_visible``,
    ``n_nodes``, ``avg_node_distance``, and the last frame's ``updated``,
    ``reference`` and ``has_estimate``."""
    global chain_graph_launches
    if ids.dim() != 2 or ids.shape[0] < 1:
        raise ValueError(f"ids must be (B, D) with B >= 1, got {tuple(ids.shape)}")
    B, D = ids.shape
    M = local.shape[0] if local.dim() == 3 else -1
    if not 1 <= M <= MAX_CAPACITY:
        raise ValueError(f"the chain-graph kernel takes 1 to {MAX_CAPACITY} slots, got local "
                         f"{tuple(local.shape)}")
    inputs = [("ids", ids, torch.int32, (B, D)), ("T_cam_tag", T_cam_tag, torch.float32, (B, D, 4, 4)),
              ("ok", ok, torch.bool, (B, D)), ("local", local, torch.float32, (M, 4, 4)),
              ("world", world, torch.float32, (M, 4, 4)), ("weight", weight, torch.float32, (M,)),
              ("present", present, torch.bool, (M,)), ("updated", updated, torch.bool, (M,)),
              ("reference", reference, torch.int32, (M,)), ("coordinate_id", coordinate_id, torch.int32, ()),
              ("has_estimate", has_estimate, torch.bool, ())]
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape)
    dev = local.device
    if dev.type != "cuda" or any(t.device != dev for _, t, _, _ in inputs):
        raise ValueError("the chain-graph kernel takes CUDA tensors on one device, got "
                         + ", ".join(f"{name} on {t.device}" for name, t, _, _ in inputs))
    f32, b8 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bool, device=dev)
    out = {
        "avg_T": torch.empty((B, 4, 4), **f32),
        "valid": torch.empty((B,), **b8),
        "visible": torch.empty((B, M), **b8),
        "present": torch.empty((B, M), **b8),
        "weight": torch.empty((B, M), **f32),
        "local": torch.empty((B, M, 4, 4), **f32),
        "world": torch.empty((B, M, 4, 4), **f32),
        "coordinate_id": torch.empty((B,), dtype=torch.int32, device=dev),
        "n_visible": torch.empty((B,), dtype=torch.int64, device=dev),
        "n_nodes": torch.empty((B,), dtype=torch.int64, device=dev),
        "avg_node_distance": torch.empty((B,), **f32),
        "updated": torch.empty((M,), **b8),
        "reference": torch.empty((M,), dtype=torch.int32, device=dev),
        "has_estimate": torch.empty((), **b8),
    }
    # The kernel's Inputs and Outputs structs, in their order.
    in_ptrs = (ctypes.c_void_p * len(inputs))(*(t.data_ptr() for _, t, _, _ in inputs))
    out_ptrs = (ctypes.c_void_p * len(out))(*(t.data_ptr() for t in out.values()))
    lib = _library.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aprilslam_chain_graph(in_ptrs, out_ptrs, B, D, M, stream)
    if rc != 0:
        raise RuntimeError(f"chain-graph kernel launch failed: cudaError_t {rc}")
    chain_graph_launches += 1
    return out


def empty_launch() -> None:
    """Launch a kernel of one warp that does nothing on the current stream:
    the floor of a launch, beside which the kernel is timed."""
    rc = _library.load().aprilslam_empty_launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError_t {rc}")
