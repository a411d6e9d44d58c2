"""The ranks' (data x fsdp) layout and batch stripes (counterpart of
dsf_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``('data',)`` mesh, or a
``('data', 'fsdp')`` mesh of shape (n_data // n_fsdp, n_fsdp) whose batch
is split over both axes.  Here the ranks take that layout in row-major
order (rank = row * n_fsdp + column): every rank holds a stripe of the
global batch, ``fsdp_group`` (a row) shares one copy of the parameters
and the optimizer's state in ``n_fsdp`` shards (``parallel.fsdp``), and
``data_group`` (a column) holds the same shard.  A world of 1 has no
groups, and every caller takes its one-device path, unless the mesh asks
for ``collectives`` (a world of one process over a process group of one:
the multi-GPU code path, its collectives included, on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from dsf_tpu_torch.parallel import distributed


def check_layout(world: int, n_fsdp: int = 1,
                 batch_size: Optional[int] = None) -> None:
    """Raise ValueError unless ``n_fsdp`` divides ``world`` (``make_mesh``'s
    rule) and ``world`` divides the global ``batch_size``."""
    if n_fsdp < 1 or world % n_fsdp:
        raise ValueError(f"n_fsdp={n_fsdp} does not divide the world of "
                         f"{world} ranks")
    if batch_size is not None and batch_size % world:
        raise ValueError(f"the global batch of {batch_size} does not divide "
                         f"over {world} ranks")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x fsdp) layout.  ``group`` is the
    whole world (None: the default group), ``fsdp_group`` this rank's row
    and ``data_group`` its column (None where they hold one rank).
    ``collectives`` runs the multi-GPU path at world 1 too."""
    world: int = 1
    rank: int = 0
    n_fsdp: int = 1
    group: Optional[object] = None
    fsdp_group: Optional[object] = None
    data_group: Optional[object] = None
    collectives: bool = False

    @property
    def active(self) -> bool:
        """Whether the statistics, counts and gradients reduce over
        ``group``."""
        return self.world > 1 or self.collectives

    @property
    def fsdp_rank(self) -> int:
        """This rank's shard of the optimizer state."""
        return self.rank % self.n_fsdp

    def stripe(self, x, global_batch: Optional[int] = None):
        """This rank's rows of a global batch ``x`` (rows [r*b, (r+1)*b),
        b = B / world); ``global_batch`` B defaults to ``len(x)``.  A batch
        that does not divide raises."""
        if self.world == 1:
            return x
        B = len(x) if global_batch is None else global_batch
        check_layout(self.world, batch_size=B)
        b = B // self.world
        return x[self.rank * b:(self.rank + 1) * b]


ONE = Mesh()


def make_mesh(n_fsdp: int = 1) -> Mesh:
    """The layout of the current process group (world 1 outside one):
    ``n_fsdp`` must divide the world.  Every rank must call it, in the
    same order (the groups are made collectively)."""
    world, rank = distributed.world(), distributed.rank()
    check_layout(world, n_fsdp)
    if world == 1:
        return ONE
    rows = [list(range(r * n_fsdp, (r + 1) * n_fsdp))
            for r in range(world // n_fsdp)]
    cols = [list(range(c, world, n_fsdp)) for c in range(n_fsdp)]
    fsdp_group = data_group = None
    for ranks in rows:
        g = dist.new_group(ranks) if n_fsdp > 1 else None
        if rank in ranks:
            fsdp_group = g
    for ranks in cols:
        g = dist.new_group(ranks) if len(ranks) > 1 and n_fsdp > 1 else None
        if rank in ranks:
            data_group = g
    return Mesh(world, rank, n_fsdp, None, fsdp_group, data_group)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order (a global
    batch from its stripes); ``t`` itself at world 1."""
    if mesh.world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)
