"""Sharding rules (``paddlerec_tpu/parallel/sharding.py``): which parameter
is row-sharded over the mesh's mp axis.

A parameter whose path names an embedding table, and whose row count
crosses a threshold and divides by mp, is row-sharded ``(MP_AXIS, None)``;
everything else (dense towers, biases, a sparse run's ``embedding_delta``)
is replicated, ``()``.  A spec is the tuple of a ``PartitionSpec``'s
entries.  ``local_rows`` cuts one mp rank's rows out of a full table, and
``join_rows`` puts the shards back together.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch

from paddlerec_tpu_torch.convert import flatten_tree
from paddlerec_tpu_torch.convert import is_embedding_path as _is_table_name
from paddlerec_tpu_torch.parallel.mesh import MP_AXIS

# tables smaller than this stay replicated (collectives would cost more
# than the memory saved)
MIN_ROWS_TO_SHARD = 8192

Path = Union[str, Sequence[Any]]


def _name(path: Path) -> str:
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def is_embedding_path(path: Path) -> bool:
    """A ``/``- or ``.``-joined name, or a sequence of its parts."""
    return _is_table_name(_name(path))


def param_spec(path: Path, leaf, mp_size: int) -> Tuple:
    shape = tuple(getattr(leaf, "shape", ()))
    if (mp_size > 1 and len(shape) >= 1 and shape[0] >= MIN_ROWS_TO_SHARD
            and shape[0] % mp_size == 0 and is_embedding_path(path)):
        return (MP_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def param_specs(params, mp_size: int) -> Dict[str, Tuple]:
    """The spec of every leaf of a params tree (nested, flat, or a
    state_dict), by its name."""
    return {name: param_spec(name, leaf, mp_size)
            for name, leaf in flatten_tree(params).items()}


def local_rows(table: torch.Tensor, mp_index: int, mp: int) -> torch.Tensor:
    """Rank ``mp_index``'s rows of a full table whose rows divide by ``mp``
    (a view)."""
    rows = table.shape[0]
    if rows % mp:
        raise ValueError(f"{rows} rows do not split over mp={mp}")
    per = rows // mp
    return table[mp_index * per:(mp_index + 1) * per]


def join_rows(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full table from its shards in mp order."""
    return torch.cat(list(shards), dim=0)

