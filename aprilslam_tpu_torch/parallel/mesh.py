"""Meshes and sharding helpers (port of ``aprilslam_tpu/parallel/mesh.py``).

The parallel axes are the JAX package's:

* ``data`` — independent sequences (or map sections);
* ``lm``   — landmark blocks of distributed bundle adjustment;
* ``kf``   — keyframe windows of one long trajectory.

A :class:`Mesh` names its axes and their shard counts. Unlike a JAX mesh it
does not need one device per shard: the shard count belongs to the problem.
The shards of an axis that lives in this process sit on the leading
dimension of every sharded tensor (``collectives.StackedAxis``), so S shards
run on one card; a 1-D mesh built with a ``torch.distributed`` process group
puts one shard on each rank (``collectives.ProcessGroupAxis``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .collectives import ProcessGroupAxis, StackedAxis


@dataclass(frozen=True)
class Mesh:
    """Axis names -> global shard counts, the device every local shard lives
    on, and the process group the sharded axis spans (``None``: every shard
    of every axis is in this process, except a multi-process ``data`` axis,
    whose rows are the processes)."""

    shape: dict
    device: torch.device
    group: object = None
    local_data: int | None = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def backend(self) -> str:
        return "stacked" if self.group is None else "process_group"

    def local_size(self, axis: str) -> int:
        """Shards of ``axis`` this process holds on its leading dimension."""
        if axis == "data" and self.local_data is not None:
            return self.local_data
        return 1 if self.group is not None else self.shape[axis]

    def axis(self, name: str, batch: int = 1):
        """The collectives of axis ``name`` over ``batch`` stacked problems."""
        if name not in self.shape:
            raise KeyError(f"mesh has no axis {name!r}: {self.axis_names}")
        if self.group is not None:
            return ProcessGroupAxis(self.group, batch=batch)
        return StackedAxis(self.shape[name], batch=batch)


def _default_shards(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_mesh(n_shards: int | None = None, axis: str = "data", device=None, group=None) -> Mesh:
    """A 1-D mesh of ``n_shards`` shards (default: one per visible device)
    on ``device`` (``None``: the CUDA device, raising without one).

    With ``group`` (a ``torch.distributed`` process group, or
    ``torch.distributed.group.WORLD``) each rank holds one shard and
    ``n_shards``, if given, must equal the group's size."""
    dev = resolve_device(device)
    if group is not None:
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if n_shards not in (None, size):
            raise ValueError(f"a process-group mesh has one shard per rank: {size}, not {n_shards}")
        return Mesh({axis: size}, dev, group=group)
    n = n_shards or _default_shards(dev)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    return Mesh({axis: n}, dev)


def make_mesh_2d(
    n_data: int | None = None,
    n_lm: int | None = None,
    data_axis: str = "data",
    lm_axis: str = "lm",
    device=None,
) -> Mesh:
    """2-D (data x lm) mesh: sequences over ``data``, landmark shards over
    ``lm``.

    As in the JAX package, a process's shards lie along ``lm``, so the
    per-iteration ``lm`` collectives stay inside the process and only the
    embarrassingly parallel ``data`` axis spans processes. ``n_data``
    defaults to the process count (1 without ``torch.distributed``), and
    ``n_lm`` to one shard per visible device; each process holds
    ``n_data / processes`` sequences."""
    import torch.distributed as dist

    dev = resolve_device(device)
    procs = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n_data = procs if n_data is None else n_data
    n_lm = n_lm or _default_shards(dev)
    if n_data % procs:
        raise ValueError(f"n_data={n_data} must divide over {procs} processes")
    return Mesh({data_axis: n_data, lm_axis: n_lm}, dev, local_data=n_data // procs)


def shard_leading(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """(N, ...) -> (S, N / S, ...) on the mesh's device, S being the shards
    of ``axis`` this process holds (all of them on a stacked mesh; its one
    on a process-group mesh, where ``x`` holds this rank's rows)."""
    x = torch.as_tensor(x, device=mesh.device)
    S = mesh.local_size(axis)
    if x.shape[0] % S:
        raise ValueError(f"leading dimension {x.shape[0]} does not split into {S} shards")
    return x.reshape((S, x.shape[0] // S) + tuple(x.shape[1:]))


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` on the mesh's device (every shard reads the same value)."""
    return torch.as_tensor(x, device=mesh.device)
