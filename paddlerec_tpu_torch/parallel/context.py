"""Process-wide parallel context (``paddlerec_tpu/parallel/context.py``).

The trainer announces its mesh here (``Trainer.__init__``, ``init_state``,
``train``, ``evaluate``), and layers with a distributed path pick it up
without mesh handles threaded through every model constructor:
``SlotEmbedding`` holds a row shard and looks up through the all_to_all
engine when the mesh's mp is above 1 (``ops/embedding.py``).
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
