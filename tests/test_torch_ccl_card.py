"""The CUDA CCL kernel against its plain version and a scipy oracle, on the card.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed; ``tests/conftest.py`` imports jax, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_ccl_card.py

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from scipy import ndimage

from aprilslam_tpu_torch.ops import ccl


def oracle(trinary: np.ndarray) -> np.ndarray:
    """scipy 4-connected labels per colour, as minimum linear indices."""
    B, H, W = trinary.shape
    out = np.full((B, H * W), H * W, np.int64)
    for b in range(B):
        for colour in (0, 1):
            lab, n = ndimage.label(trinary[b] == colour)
            flat = lab.ravel()
            ids, first = np.unique(flat, return_index=True)
            root = np.zeros(n + 1, np.int64)
            root[ids[ids > 0]] = first[ids > 0]
            out[b, flat > 0] = root[flat[flat > 0]]
    return out.reshape(B, H, W)


def block_image(rng, B, H, W):
    base = rng.integers(-1, 2, size=(B, -(-H // 4), -(-W // 4))).astype(np.int8)
    return np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :H, :W].copy()


def serpentine(H, W):
    t = np.zeros((1, H, W), np.int8)
    t[0, 0::2, :] = 1
    for r in range(1, H, 2):
        t[0, r, W - 1 if (r // 2) % 2 == 0 else 0] = 1
    return t


def stress_inputs(rng):
    """Maps that cross tile borders in every way (as chip_smoke.py's)."""
    y, x = np.mgrid[:500, :500]
    frames = lambda img: np.broadcast_to(img.astype(np.int8), (8, 500, 500)).copy()
    return [
        frames((y + x) % 2),  # checkerboard: no same-colour neighbour
        frames(x % 2),  # 1-pixel stripes: one component per column
        frames((x - y) % 16 < 2),  # staircase: diagonal bands over many tiles
        rng.integers(-1, 2, size=(2, 1, 1)).astype(np.int8),
        rng.integers(-1, 2, size=(2, 1, 501)).astype(np.int8),
        rng.integers(-1, 2, size=(2, 501, 1)).astype(np.int8),
        block_image(rng, 2, 37, 501),  # W % 4 != 0
        block_image(rng, 32, 500, 500),
    ]


def check_kernel(t: np.ndarray, device) -> None:
    """Kernel == plain == oracle bit for bit, and one launch counted."""
    tt = torch.as_tensor(t, device=device).contiguous()
    before = ccl.ccl_launches
    got = ccl.connected_components(tt)
    torch.cuda.synchronize()
    assert ccl.ccl_launches == before + 1
    assert torch.equal(got, ccl.connected_components_plain(tt))
    np.testing.assert_array_equal(got.cpu().numpy(), oracle(t))


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_and_oracle(card, seed):
    rng = np.random.default_rng(seed)
    for t in (block_image(rng, 8, 500, 500), serpentine(500, 500),
              rng.integers(-1, 2, size=(3, 37, 501)).astype(np.int8),
              np.full((2, 64, 96), -1, np.int8), np.ones((1, 500, 500), np.int8)):
        check_kernel(t, card)


@pytest.mark.cuda
def test_kernel_on_stress_inputs(card):
    for t in stress_inputs(np.random.default_rng(0)):
        check_kernel(t, card)


@pytest.mark.cuda
@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(B=st.integers(1, 8), H=st.integers(1, 600), W=st.integers(1, 600),
       block=st.integers(1, 40), seed=st.integers(0, 2**32 - 1))
def test_kernel_on_random_shapes(card, B, H, W, block, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, 2, size=(B, -(-H // block), -(-W // block))).astype(np.int8)
    check_kernel(np.repeat(np.repeat(base, block, axis=1), block, axis=2)[:, :H, :W].copy(), card)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError):
        ccl.connected_components(torch.zeros((1, 8, 8), dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        ccl.connected_components(torch.zeros((8, 8), dtype=torch.int8, device=card))
    with pytest.raises(ValueError):
        ccl.connected_components(torch.zeros((1, 8, 16), dtype=torch.int8, device=card)[:, :, ::2])
