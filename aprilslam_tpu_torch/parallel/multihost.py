"""Multi-process distribution (port of ``aprilslam_tpu/parallel/multihost.py``).

The JAX package connects processes through ``jax.distributed``; the port
uses a ``torch.distributed`` process group: gloo for CPU processes, NCCL for
GPUs, one rank per process. Nothing here picks a backend on its own: the
caller names the platform, and a missing backend raises.

A mesh built on the group (``make_mesh(group=torch.distributed.group.WORLD)``)
puts one shard of its axis on each rank; ``make_mesh_2d`` lays its ``data``
axis over the processes and keeps each process's ``lm`` shards local.
"""

from __future__ import annotations

import datetime
import logging

import numpy as np
import torch

from .mesh import Mesh

logger = logging.getLogger(__name__)

BACKENDS = {"cpu": "gloo", "gpu": "nccl"}


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    platform: str | None = None,
    timeout_s: float = 60.0,
) -> None:
    """Join this process to a ``torch.distributed`` process group.

    ``coordinator_address`` is rank 0's ``host:port`` (a ``tcp://`` prefix
    is optional); ``num_processes`` the world size and ``process_id`` this
    rank. ``platform`` is ``"cpu"`` (gloo) or ``"gpu"`` (NCCL, the default;
    each rank takes the card ``process_id % device_count``). A rendezvous or
    collective that does not complete within ``timeout_s`` raises.

        initialize_distributed("localhost:9876", num_processes=2, process_id=i, platform="cpu")
    """
    import torch.distributed as dist

    platform = platform or "gpu"
    if platform not in BACKENDS:
        raise ValueError(f"platform must be one of {sorted(BACKENDS)}, not {platform!r}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("coordinator_address, num_processes and process_id are required")
    backend = BACKENDS[platform]
    if backend == "nccl":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("platform 'gpu' needs CUDA and NCCL; pass platform='cpu' for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed up: rank %d/%d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_global(mesh: Mesh, axis: str | None, value) -> torch.Tensor:
    """This process's part of a value every process holds in full: its rows
    of the leading dimension when ``axis`` is split over the ranks of the
    mesh's group, else the whole value; on the mesh's device."""
    import torch.distributed as dist

    x = torch.as_tensor(value)
    if axis is not None and mesh.group is not None:
        n, r = mesh.shape[axis], dist.get_rank(mesh.group)
        if x.shape[0] % n:
            raise ValueError(f"leading dimension {x.shape[0]} does not split over {n} ranks")
        step = x.shape[0] // n
        x = x[r * step:(r + 1) * step]
    return x.to(mesh.device)


def all_processes_cost(cost_local: float) -> np.ndarray:
    """Gather one host scalar from every process, ordered by rank."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([cost_local], dtype=torch.float32, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.cat(parts).cpu().numpy()
