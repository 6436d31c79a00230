"""The chain-graph CUDA kernel against its plain version, on the card.

This file imports neither jax nor the JAX package; ``tests/conftest.py``
imports jax, so where jax is not installed run it as

    python -m pytest --noconftest -m cuda tests/test_torch_chain_graph_card.py

Without a CUDA device every test skips.

Integers and bools must match exactly. Floats must match within 1e-5 of the
tensor's largest magnitude: the kernel's 4x4 products are fused
multiply-adds in its own order, where the plain version's go through
cuBLAS (or the CPU's BLAS), and its sums over slots run in two halves.
"""

import json

import pytest
import torch
from chain_graph_cases import SHAPES, chain_chunk, compare_scans, state_to, to_device

from aprilslam_tpu_torch.ops import chain_graph
from aprilslam_tpu_torch.slam import graph as G

FLOAT_RTOL = 1e-5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_chunk(state, chunk, project_rotation, card):
    """Kernel == plain on the card and on the CPU; one launch counted.
    Returns the kernel's final state and scan."""
    ids, T, ok = to_device(chunk, card)
    before = chain_graph.chain_graph_launches
    got = G.scan_chain_graph(state, ids, T, ok, project_rotation=project_rotation)
    torch.cuda.synchronize()
    assert chain_graph.chain_graph_launches == before + 1
    plain = G.scan_chain_graph_plain(state, ids, T, ok, project_rotation=project_rotation)
    assert chain_graph.chain_graph_launches == before + 1
    assert compare_scans(got, plain) <= FLOAT_RTOL
    cpu = G.scan_chain_graph(state_to(state, "cpu"), *to_device(chunk, "cpu"), project_rotation=project_rotation)
    assert compare_scans(got, cpu) <= FLOAT_RTOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("project_rotation", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_D{}_M{}".format(*s))
@pytest.mark.parametrize("seed", range(4))
def test_random_chunks(card, shape, seed, project_rotation):
    """Two chunks in a row, the second from the kernel's own state."""
    B, D, M = shape
    state = G.init_graph(M, device=card)
    for c in (seed, seed + 100):
        state, _ = check_chunk(state, chain_chunk(c, B, D, M), project_rotation, card)


@pytest.mark.cuda
def test_reanchoring_chunk(card):
    """The anchor moves down three times within the chunk, once with no
    known visible tag to chain through."""
    B, D, M = SHAPES[0]
    _, scan = check_chunk(G.init_graph(M, device=card), chain_chunk(0, B, D, M), True, card)
    coord = scan.coordinate_id.cpu()
    assert len(set(coord[coord < G.NO_ANCHOR].tolist())) >= 3, coord


@pytest.mark.cuda
def test_wrapper_refuses(card):
    M = 16
    s = G.init_graph(M, device=card)
    ids, T, ok = to_device(chain_chunk(0, 2, 4, M), card)
    fields = [s.local, s.world, s.weight, s.present, s.updated, s.reference, s.coordinate_id, s.has_estimate]
    with pytest.raises(ValueError, match="int32"):
        chain_graph.chain_graph_scan(*fields, ids.long(), T, ok)
    with pytest.raises(ValueError, match="float32"):
        chain_graph.chain_graph_scan(*fields, ids, T.double(), ok)
    with pytest.raises(ValueError, match="contiguous"):
        chain_graph.chain_graph_scan(*fields, ids, T.transpose(-1, -2), ok)
    with pytest.raises(ValueError, match="ok"):
        chain_graph.chain_graph_scan(*fields, ids, T, ok[:, :2])
    with pytest.raises(ValueError, match="CUDA"):
        chain_graph.chain_graph_scan(*fields, ids.cpu(), T, ok)
    big = G.init_graph(chain_graph.MAX_CAPACITY + 1, device=card)
    with pytest.raises(ValueError, match="slots"):
        chain_graph.chain_graph_scan(big.local, big.world, big.weight, big.present, big.updated,
                                     big.reference, big.coordinate_id, big.has_estimate, ids, T, ok)


@pytest.mark.cuda
def test_closure_loop_chunks(card, monkeypatch):
    """The closure cell's step (config 2's loop with both pose graphs) through
    ``SlamSystem.process``: one launch per chunk, and every chunk's recorded
    scan input through the kernel and the plain version."""
    from bench_torch import headline_params, pgo_frames

    from aprilslam_tpu_torch.sim import DEFAULT_SCENE
    from aprilslam_tpu_torch.slam import SlamSystem
    from aprilslam_tpu_torch.slam import pipeline

    with open(DEFAULT_SCENE) as f:
        cfg, cam, _traj, chunks = pgo_frames(json.load(f), 1000, 8, card)
    params = headline_params()
    slam = SlamSystem(cam, cfg.family, cfg.tag_size_inner, detector_params=params, device=card,
                      estimator="ba", ba_schedule="chunk", graph_capacity=16, init_joint_iters=3,
                      ba_chunk_iters=4, pnp_iters=3, pgo=True)
    recorded = []
    scan = pipeline.scan_chain_graph

    def record(state, ids, T, ok, project_rotation=True):
        recorded.append((state, ids.clone(), T.clone(), ok.clone()))
        return scan(state, ids, T, ok, project_rotation=project_rotation)

    monkeypatch.setattr(pipeline, "scan_chain_graph", record)
    before = chain_graph.chain_graph_launches
    n = 6
    outs = [slam.process(c) for c in chunks[:n]]
    torch.cuda.synchronize()
    assert chain_graph.chain_graph_launches == before + n
    assert len(recorded) == n
    assert bool(outs[-1].valid.all())
    for state, ids, T, ok in recorded:
        gap = compare_scans(G.scan_chain_graph(state, ids, T, ok), G.scan_chain_graph_plain(state, ids, T, ok))
        assert gap <= FLOAT_RTOL, gap
    assert bool(recorded[-1][0].present.any())
