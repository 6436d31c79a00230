"""The port's stand-in for ``shard_map``: one collective interface, two backends.

The JAX solvers are per-shard bodies under ``shard_map`` that use three
collectives: ``psum`` over an axis, ``ppermute`` to the ring neighbours and
``axis_index``. Here a solver body is written once against tensors whose
leading dimension holds the shards this process owns, and calls these
methods on an axis object:

* :class:`StackedAxis` — every shard of the axis lives in this process, on
  the leading dimension (S shards on one card, or on the CPU). ``psum`` is a
  sum over that dimension, the ring exchange a roll of it. The shard count is
  a parameter of the problem, not of the hardware.
* :class:`ProcessGroupAxis` — one shard per rank of a ``torch.distributed``
  process group (gloo on the CPU, NCCL on GPUs, whichever the group was
  created with); the leading dimension holds this rank's one shard.

Both take ``batch``: independent problems stacked in front of the shards
(the ``data`` axis of a 2-D mesh), shape ``(batch * local_shards, ...)``
with the shards of one problem contiguous. Collectives never mix problems.
"""

from __future__ import annotations

import torch

from ..slam.ba import index_add


class StackedAxis:
    """All ``size`` shards of the axis in this process, stacked on dim 0."""

    def __init__(self, size: int, batch: int = 1):
        if size < 1 or batch < 1:
            raise ValueError(f"size and batch must be >= 1, got {size} and {batch}")
        self.size = size
        self.batch = batch

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.batch, self.size) + x.shape[1:])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis; every shard gets the total."""
        b = self._blocks(x)
        return b.sum(1, keepdim=True).expand_as(b).reshape(x.shape)

    def from_right(self, x: torch.Tensor) -> torch.Tensor:
        """Shard d receives shard (d + 1) % size's value."""
        return torch.roll(self._blocks(x), -1, 1).reshape(x.shape)

    def from_left(self, x: torch.Tensor) -> torch.Tensor:
        """Shard d receives shard (d - 1) % size's value."""
        return torch.roll(self._blocks(x), 1, 1).reshape(x.shape)

    def axis_index(self, device=None) -> torch.Tensor:
        """(batch * size,) int64: each row's shard index on the axis."""
        return torch.arange(self.size, device=device).repeat(self.batch)


class ProcessGroupAxis:
    """One shard per rank of ``group`` (``None``: the default world group)."""

    def __init__(self, group=None, batch: int = 1):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupAxis needs torch.distributed to be initialized "
                               "(parallel.initialize_distributed)")
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.batch = batch

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        self._dist.all_reduce(y, group=self.group)
        return y

    def _ring(self, x: torch.Tensor, send_to: int, recv_from: int) -> torch.Tensor:
        if self.size == 1:
            return x.clone()
        dist = self._dist
        x = x.contiguous()
        out = torch.empty_like(x)
        peer = lambda r: dist.get_global_rank(self.group, r) if self.group is not None else r  # noqa: E731
        ops = [dist.P2POp(dist.isend, x, peer(send_to), self.group),
               dist.P2POp(dist.irecv, out, peer(recv_from), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def from_right(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, (self.rank - 1) % self.size, (self.rank + 1) % self.size)

    def from_left(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, (self.rank + 1) % self.size, (self.rank - 1) % self.size)

    def axis_index(self, device=None) -> torch.Tensor:
        return torch.full((self.batch,), self.rank, dtype=torch.int64, device=device)


def flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per-shard local indices (R, ...) in [0, n) -> rows of the flattened
    (R * n) segment dimension: row r's index i becomes r * n + i."""
    r = torch.arange(idx.shape[0], device=idx.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return (idx.long() + r * n).reshape(-1)


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per-shard segment sums: ``vals`` (R, O, ...) summed by local index
    ``idx`` (R, O) in [0, n) into (R, n, ...), scatter-added (in a fixed
    order, ``slam.ba.index_add``) into the flattened (R * n) rows."""
    R = idx.shape[0]
    tail = vals.shape[idx.dim():]
    out = index_add(vals.new_zeros((R * n,) + tail), flat_index(idx, n), vals.reshape((-1,) + tail))
    return out.reshape((R, n) + tail)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather: ``x`` (R, n, ...) read at local indices ``idx``
    (R, O) -> (R, O, ...)."""
    R, n = x.shape[:2]
    return x.reshape((R * n,) + x.shape[2:])[flat_index(idx, n)].reshape(idx.shape + x.shape[2:])
