"""Custom tag-family generation (greedy lexicode with rotation-aware margin).

Port of ``aprilslam_tpu/families/generate.py`` (numpy only): the same
``(n_codes, seed, total_width, min_hamming)`` give the same grids and name,
since both draw from ``np.random.default_rng(seed)``.

Large-map stress scenes (1000+ tags) need families of arbitrary size with a
guaranteed pairwise Hamming margin across all relative rotations. Layout of
generated families matches tagStandard41h12's (reversed border, data ring
outside the black ring + centre block), so the same detector path handles
built-in and generated families identically.
"""

from __future__ import annotations

import numpy as np

from . import TagFamily, register_family


def _standard_layout(total_width: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Masks for a reversed-border standard layout of side ``total_width``.

    Returns (data_mask, black_mask, white_mask). Data cells are the outermost
    ring plus the centre block inside the white ring; ring 1 is black, ring 2
    white (cf. tagStandard41h12's 9x9 layout).
    """
    C = total_width
    data = np.zeros((C, C), dtype=bool)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = True
    if C > 6:
        data[3 : C - 3, 3 : C - 3] = True
    black = np.zeros((C, C), dtype=bool)
    black[1, 1 : C - 1] = black[C - 2, 1 : C - 1] = True
    black[1 : C - 1, 1] = black[1 : C - 1, C - 2] = True
    white = np.zeros((C, C), dtype=bool)
    white[2, 2 : C - 2] = white[C - 3, 2 : C - 2] = True
    white[2 : C - 2, 2] = white[2 : C - 2, C - 3] = True
    return data, black, white


def _grid_from_bits(bits: np.ndarray, data_mask: np.ndarray, white_mask: np.ndarray) -> np.ndarray:
    grid = np.zeros(data_mask.shape, dtype=np.uint8)
    grid[white_mask] = 1
    grid[data_mask] = bits
    return grid


def generate_family(
    n_codes: int,
    name: str | None = None,
    total_width: int = 9,
    min_hamming: int = 9,
    seed: int = 0,
    register: bool = True,
) -> TagFamily:
    """Generate a custom reversed-border family with ``n_codes`` codes.

    Greedy accept/reject over a counter-seeded PCG stream: a candidate is kept
    iff its Hamming distance to every kept code under every relative rotation
    (and to its own rotations) is >= ``min_hamming``, and it is not
    degenerate (near-uniform).
    """
    data_mask, _black, white_mask = _standard_layout(total_width)
    nbits = int(data_mask.sum())
    if min_hamming > nbits // 2:
        raise ValueError(f"min_hamming {min_hamming} too large for {nbits} data bits")

    rng = np.random.default_rng(seed)
    kept_grids: list[np.ndarray] = []
    kept_rot_bits: list[np.ndarray] = []  # (4, nbits) per kept code

    def rot_bits(grid: np.ndarray) -> np.ndarray:
        return np.stack([np.rot90(grid, k)[data_mask].astype(np.int8) for k in range(4)])

    max_tries = max(200_000, n_codes * 2000)
    tries = 0
    while len(kept_grids) < n_codes and tries < max_tries:
        tries += 1
        bits = rng.integers(0, 2, size=nbits, dtype=np.uint8)
        ones = int(bits.sum())
        if ones < nbits // 4 or ones > 3 * nbits // 4:
            continue
        grid = _grid_from_bits(bits, data_mask, white_mask)
        rb = rot_bits(grid)
        # self-rotation distance
        if min(int(np.sum(rb[0] != rb[k])) for k in range(1, 4)) < min_hamming:
            continue
        ok = True
        for other in kept_rot_bits:
            d = np.sum(rb[0][None, :] != other, axis=1)
            if int(d.min()) < min_hamming:
                ok = False
                break
        if not ok:
            continue
        kept_grids.append(grid)
        kept_rot_bits.append(rot_bits(grid))
    if len(kept_grids) < n_codes:
        raise RuntimeError(
            f"Only found {len(kept_grids)}/{n_codes} codes with margin {min_hamming}; "
            "lower min_hamming or raise total_width."
        )
    fam = TagFamily(
        name=name or f"tpuCustom{total_width}x{total_width}h{min_hamming}n{n_codes}",
        grids=np.stack(kept_grids),
        total_width=total_width,
        width_at_border=total_width - 4,
        reversed_border=True,
        min_hamming=min_hamming,
    )
    if register:
        register_family(fam)
    return fam
