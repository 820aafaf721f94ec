"""Process-wide parallel context (``paddlerec_tpu/parallel/context.py``).

A trainer whose mesh has a distributed path announces it here, and layers
with such a path pick it up without mesh handles threaded through every
model constructor.  The port's trainer runs only the 1x1 mesh yet and
announces nothing: the context stays empty, and layers keep their local
implementations.
"""

from __future__ import annotations

from typing import Optional

from paddlerec_tpu_torch.parallel.mesh import Mesh

_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def model_parallel_size() -> int:
    return _MESH.mp if _MESH is not None else 1


class use_mesh:
    """Context manager: set the active mesh for a scope."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self.prev: Optional[Mesh] = None

    def __enter__(self):
        self.prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)
        return False
