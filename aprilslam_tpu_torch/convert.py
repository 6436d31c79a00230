"""Carry SLAM state across between the JAX package and the port.

The JAX package's ``GraphState``, ``BAState``, ``PgoState`` (with its nested
``PoseGraphEdges``) and ``TagGraphState`` hold the map a run has built (its
"weights"). Passed as numpy arrays under their field names, they become the
port's dataclasses of tensors and back, so a run can continue in the other
framework from the same state. A nested dataclass is a nested dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import fields

import numpy as np
import torch

from .device import resolve_device
from .slam.ba import BAState
from .slam.graph import GraphState
from .slam.loop import PgoState
from .slam.pgo import PoseGraphEdges
from .slam.taggraph import TagGraphState

_NESTED = {(PgoState, "edges"): PoseGraphEdges}


def _from_numpy(cls, arrays: dict, device: torch.device):
    names = [f.name for f in fields(cls)]
    missing = sorted(set(names) - set(arrays))
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")

    def one(n):
        sub = _NESTED.get((cls, n))
        if sub is not None:
            return _from_numpy(sub, arrays[n], device)
        return torch.as_tensor(np.array(arrays[n]), device=device)

    return cls(**{n: one(n) for n in names})


def _to_numpy(s) -> dict:
    return {
        f.name: (_to_numpy(v) if dataclasses.is_dataclass(v := getattr(s, f.name))
                 else v.detach().cpu().numpy())
        for f in fields(s)
    }


def state_from_jax_numpy(graph: dict, ba: dict | None = None, pgo: dict | None = None,
                         taggraph: dict | None = None, device: str | torch.device | None = None):
    """Build the port's step state from the JAX state's fields: a lone
    GraphState (the chain and joint estimators), (GraphState, BAState), or
    with ``pgo`` and ``taggraph`` the 4-tuple (GraphState, BAState,
    PgoState, TagGraphState)."""
    dev = resolve_device(device)
    if ba is None:
        if pgo is not None or taggraph is not None:
            raise ValueError("a pose-graph state needs its BAState")
        return _from_numpy(GraphState, graph, dev)
    state = (_from_numpy(GraphState, graph, dev), _from_numpy(BAState, ba, dev))
    if pgo is None and taggraph is None:
        return state
    if pgo is None or taggraph is None:
        raise ValueError("pgo and taggraph come together: the 4-tuple state holds both")
    return state + (_from_numpy(PgoState, pgo, dev), _from_numpy(TagGraphState, taggraph, dev))


def state_to_numpy(state):
    """The reverse: each state's fields as numpy arrays under their names
    (nested dataclasses as nested dicts); a lone state gives one dict."""
    if dataclasses.is_dataclass(state):
        return _to_numpy(state)
    return tuple(_to_numpy(s) for s in state)
