"""ctypes binding of the native graph engine (``native/graph_engine.cpp``).

Counterpart of ``paddlerec_tpu/native/graph.py``: ``GraphEngine`` is a CSR
graph store with multithreaded random walks and fixed-fanout neighbour
sampling, the host side of the graph models' input pipeline (the PGLBox
engine analog).  The library is the port's own build of the same source,
read as it is, so both packages give the same walks and samples for one
edge file and seed.  It is compiled with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into the port's git-ignored ``build/native/libgraph.so``, never
into ``native/build/``, which belongs to the JAX package, and rebuilt when
the source is newer; the compiler writes a temporary file that is renamed
into place, so that processes building at once never load a half-written
library.  Without ``g++`` the build raises ``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from paddlerec_tpu_torch.native import BUILD_DIR, NativeUnavailable, build_native  # noqa: F401

_lib = None


def graphlib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native("libgraph.so", "graph_engine.cpp",
                                       ["-shared", "-fPIC", "-pthread"]))
        lib.gr_create.restype = ctypes.c_void_p
        lib.gr_create.argtypes = []
        lib.gr_free.restype = None
        lib.gr_free.argtypes = [ctypes.c_void_p]
        lib.gr_load.restype = ctypes.c_long
        lib.gr_load.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        for name in ("gr_num_nodes", "gr_max_node", "gr_num_edges"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p]
        lib.gr_degree.restype = ctypes.c_long
        lib.gr_degree.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.gr_nodes.restype = ctypes.c_long
        lib.gr_nodes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_long]
        lib.gr_walks.restype = None
        lib.gr_walks.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.gr_sample.restype = None
        lib.gr_sample.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    return _lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


class GraphEngine:
    """CSR graph store with native walks and sampling."""

    def __init__(self, symmetry: bool = True, num_threads: int = 8):
        self._lib = graphlib()
        self._h = self._lib.gr_create()
        self.symmetry = symmetry
        self.num_threads = num_threads

    def load(self, files: Sequence[str]) -> int:
        """Load a shard of edge files (``src dst [etype]`` lines); call once
        per part for a sharded load."""
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        n = self._lib.gr_load(self._h, arr, len(files), int(self.symmetry),
                              self.num_threads)
        if n < 0:
            raise IOError(f"graph load failed ({n})")
        return int(n)

    @property
    def num_nodes(self) -> int:
        return int(self._lib.gr_num_nodes(self._h))

    @property
    def num_edges(self) -> int:
        return int(self._lib.gr_num_edges(self._h))

    @property
    def max_node(self) -> int:
        return int(self._lib.gr_max_node(self._h))

    def degree(self, node: int) -> int:
        return int(self._lib.gr_degree(self._h, int(node)))

    def nodes(self) -> np.ndarray:
        out = np.zeros(self.num_nodes, np.int64)
        n = self._lib.gr_nodes(self._h, _i64p(out), len(out))
        return out[:n]

    def walks(self, starts: np.ndarray, walk_len: int, seed: int = 0) -> np.ndarray:
        """(len(starts), walk_len) walks, -1 past a dead end."""
        starts = np.ascontiguousarray(starts, np.int64).reshape(-1)
        out = np.empty((len(starts), walk_len), np.int64)
        self._lib.gr_walks(self._h, _i64p(starts), len(starts), walk_len,
                           ctypes.c_ulonglong(seed & (2**64 - 1)), _i64p(out))
        return out

    def sample(self, nodes: np.ndarray, fanout: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """``fanout`` neighbours of each node and their mask (0 for a node
        without neighbours), of shape ``nodes.shape + (fanout,)``."""
        flat = np.ascontiguousarray(nodes, np.int64).reshape(-1)
        out = np.empty((len(flat), fanout), np.int64)
        mask = np.empty((len(flat), fanout), np.float32)
        self._lib.gr_sample(self._h, _i64p(flat), len(flat), fanout,
                            ctypes.c_ulonglong(seed & (2**64 - 1)), _i64p(out),
                            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        shape = np.asarray(nodes).shape + (fanout,)
        return out.reshape(shape), mask.reshape(shape)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.gr_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def graph_available() -> bool:
    try:
        graphlib()
        return True
    except NativeUnavailable:
        return False
