"""Camera poses drawn uniformly in the reference's bounds from the run's
seed (``monte_carlo``), zero rotation: ``{"kind": "monte_carlo", "frames": N}``."""

from perfbench.inputs import scene


def poses(pool: dict, seed: int):
    return scene.monte_carlo(int(pool["frames"]), seed)
