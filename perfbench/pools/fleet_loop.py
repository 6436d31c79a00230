"""S camera streams on the scripted two-lap loop (``LOOP_WAYPOINTS``), each
from its own phase, laid out call by call: ``{"kind": "fleet_loop",
"frames": N, "streams": S, "loop_frames": L, "phase": P, "chunk": B}``.
Pool position ``S*B*k + B*s + b`` (call k, stream s, frame b of the
stream's chunk) holds loop frame ``(B*k + b + P*s) mod L``: a call of S*B
frames is one chunk of every stream, each stream's chunks follow each other
along the loop, and the pool holds every stream's whole loop once (N = S*L).
The same for every seed."""

import numpy as np

from perfbench.inputs import scene


def layout(pool: dict) -> np.ndarray:
    """(N,) the loop frame at each pool position."""
    n, S, L = int(pool["frames"]), int(pool["streams"]), int(pool["loop_frames"])
    P, B = int(pool["phase"]), int(pool["chunk"])
    if n != S * L or L % B:
        raise ValueError(f"a fleet pool holds each of its {S} streams' {L}-frame loop once, in chunks of {B}: "
                         f"frames {n}")
    k, s, b = np.meshgrid(np.arange(L // B), np.arange(S), np.arange(B), indexing="ij")
    return ((B * k + b + P * s) % L).reshape(-1)


def poses(pool: dict, seed: int):
    pos, rot = scene.scripted_waypoints(int(pool["loop_frames"]), scene.LOOP_WAYPOINTS)
    i = layout(pool)
    return pos[i], rot[i]
