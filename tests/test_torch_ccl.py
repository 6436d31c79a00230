"""Port parity: connected-components labelling.

The plain version must give the converged labels bit for bit: the JAX XLA
path at scan_iters=8, the Pallas kernel in interpret mode at 8 rounds, and a
scipy oracle, on block images (as tests/test_ops.py builds them); on a
serpentine no fixed relaxation schedule converges, so only the oracle is
held there. The CUDA kernel itself is compared with the plain version on
the card in ``test_torch_ccl_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from aprilslam_tpu.detect.segment import connected_components as cc_xla
from aprilslam_tpu.ops import connected_components_pallas
from aprilslam_tpu_torch.ops import ccl


def oracle(trinary: np.ndarray) -> np.ndarray:
    """scipy 4-connected labels per colour, as minimum linear indices."""
    B, H, W = trinary.shape
    out = np.full(trinary.shape, H * W, np.int64)
    for b in range(B):
        for colour in (0, 1):
            lab, n = ndimage.label(trinary[b] == colour)
            for k in range(1, n + 1):
                m = lab == k
                out[b][m] = np.flatnonzero(m.ravel()).min()
    return out


def block_image(seed, B=2, H=40, W=52):
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, 2, size=(B, H // 4, W // 4)).astype(np.int8)
    return np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)


def serpentine(H, W):
    t = np.zeros((1, H, W), np.int8)
    t[0, 0::2, :] = 1
    for r in range(1, H, 2):
        t[0, r, W - 1 if (r // 2) % 2 == 0 else 0] = 1
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_xla_pallas_and_oracle(seed):
    t = block_image(seed)
    with jax.enable_x64(False):
        ref = np.asarray(cc_xla(jnp.asarray(t), scan_iters=8, jump_iters=2))
        pal = np.asarray(connected_components_pallas(jnp.asarray(t), rounds=8, interpret=True))
    got = ccl.connected_components_plain(torch.as_tensor(t)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, oracle(t))


@pytest.mark.parametrize("shape", [(1, 37, 61), (1, 64, 9), (1, 9, 64)])
def test_plain_serpentine_matches_oracle(shape):
    t = serpentine(*shape[1:])
    got = ccl.connected_components_plain(torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, oracle(t))
    assert len(np.unique(got[t == 1])) == 1  # one component snakes over the frame


def test_plain_edge_cases():
    rng = np.random.default_rng(5)
    for t in (np.full((2, 7, 9), -1, np.int8), np.ones((1, 5, 5), np.int8),
              rng.integers(-1, 2, size=(3, 13, 17)).astype(np.int8)):
        got = ccl.connected_components_plain(torch.as_tensor(t)).numpy()
        np.testing.assert_array_equal(got, oracle(t))
