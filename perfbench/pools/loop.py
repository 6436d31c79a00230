"""The scripted two-lap loop (``PGO_WAYPOINTS``), the same for every seed:
``{"kind": "loop", "frames": 96}``."""

from perfbench.inputs import scene


def poses(pool: dict, seed: int):
    return scene.scripted_waypoints(int(pool["frames"]), scene.LOOP_WAYPOINTS)
