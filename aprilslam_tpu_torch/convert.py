"""Carry SLAM state across between the JAX package and the port.

The JAX package's ``GraphState`` and ``BAState`` hold the map a run has
built (its "weights"). Passed as numpy arrays under their field names, they
become the port's dataclasses of tensors and back, so a run can continue in
the other framework from the same state.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .device import resolve_device
from .slam.ba import BAState
from .slam.graph import GraphState


def _from_numpy(cls, arrays: dict[str, np.ndarray], device: torch.device):
    names = [f.name for f in fields(cls)]
    missing = sorted(set(names) - set(arrays))
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(**{n: torch.as_tensor(np.array(arrays[n]), device=device) for n in names})


def state_from_jax_numpy(graph: dict[str, np.ndarray], ba: dict[str, np.ndarray],
                         device: str | torch.device | None = None) -> tuple[GraphState, BAState]:
    """Build the port's (GraphState, BAState) from the JAX state's fields."""
    dev = resolve_device(device)
    return _from_numpy(GraphState, graph, dev), _from_numpy(BAState, ba, dev)


def state_to_numpy(state: tuple[GraphState, BAState]) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The reverse: each state's fields as numpy arrays under their names."""
    return tuple(
        {f.name: getattr(s, f.name).detach().cpu().numpy() for f in fields(s)} for s in state
    )
