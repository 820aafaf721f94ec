"""The ``(dp, mp)`` grid of ranks: the port's counterpart of
``paddlerec_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a 2-D device mesh; the port runs
one process a card under ``torch.distributed`` (``tools/launch.py`` spawns
them) and lays its ranks out on the same grid, row-major:

  * ``dp`` — data parallelism: the batch is split along it (a grid column
    holds one copy of every table shard);
  * ``mp`` — model parallelism for the sparse dimension: embedding tables
    are row-sharded along it (a grid row holds one whole table).

Rank ``r`` sits at ``(r // mp, r % mp)``.  ``Mesh.mp_group`` is the
``torch.distributed`` group of its row (the all_to_all of
``parallel/embedding.py`` runs there) and ``Mesh.dp_group`` that of its
column (the table gradients are summed there).  At world size 1 without a
process group the mesh is the 1×1 grid and has no groups.

Config keys: ``runner.mesh_dp`` / ``runner.mesh_mp`` (-1 = the rest of the
world).  Defaults: mp spans the world when ``distributed_embedding`` is on,
else everything is on dp.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

DP_AXIS = "dp"
MP_AXIS = "mp"


def world_size() -> int:
    """The ranks of the default process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """``grid`` (dp, mp) of ranks, this process's ``rank`` and place in it,
    and the process groups of its row (``mp_group``) and column
    (``dp_group``); both ``None`` without a process group."""

    def __init__(self, dp: int, mp: int, rank: int = 0):
        self.dp, self.mp, self.rank = dp, mp, rank
        self.grid = np.arange(dp * mp).reshape(dp, mp)
        self.dp_index, self.mp_index = divmod(rank, mp)
        self.mp_group = self.dp_group = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, MP_AXIS: self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, mp={self.mp}, rank={self.rank})"


def create_mesh(dp: Optional[int] = None, mp: Optional[int] = None,
                world: Optional[int] = None) -> Mesh:
    """The ``dp × mp`` grid over ``world`` ranks (default: the process
    group's size, 1 without one); ``None`` for one axis means the rest.
    Under an initialized process group of that size every rank must call
    this in the same order: it creates the row and column groups."""
    n = world_size() if world is None else int(world)
    if dp is None and mp is None:
        dp, mp = n, 1
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != world size {n}")
    grouped = dist.is_initialized() and dist.get_world_size() == n
    mesh = Mesh(dp, mp, dist.get_rank() if grouped else 0)
    if grouped:
        # new_group is collective: every rank creates every group, in order
        for i in range(dp):
            group = _group(mesh.grid[i].tolist(), n)
            if i == mesh.dp_index:
                mesh.mp_group = group
        for j in range(mp):
            group = _group(mesh.grid[:, j].tolist(), n)
            if j == mesh.mp_index:
                mesh.dp_group = group
    return mesh


def _group(ranks, world: int):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def mesh_from_config(cfg, world: Optional[int] = None) -> Mesh:
    n = world_size() if world is None else int(world)
    dp = cfg.runner("mesh_dp")
    mp = cfg.runner("mesh_mp")
    if dp is None and mp is None:
        if cfg.hyper("distributed_embedding", 0):
            # shard the table over every rank; the batch is still data-parallel
            dp, mp = 1, n
        else:
            dp, mp = n, 1
    return create_mesh(
        None if dp in (None, -1) else int(dp),
        None if mp in (None, -1) else int(mp),
        n,
    )
