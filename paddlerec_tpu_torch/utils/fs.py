"""Filesystem access for donefiles, data gating and published models: the
local part of ``paddlerec_tpu/utils/fs.py``.

The JAX package also routes ``gs://`` paths to an object store; the port
reads and writes the local filesystem (or an NFS mount) only and raises on
a path with a scheme.
"""

from __future__ import annotations

import os


class LocalFS:
    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def append_line(self, path: str, line: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")

    def read_text(self, path: str) -> str:
        with open(path, "r") as f:
            return f.read()


def get_fs(path: str) -> LocalFS:
    """Route a path to its filesystem (local only)."""
    if "://" in path:
        raise NotImplementedError(
            f"{path!r}: object stores are not ported to paddlerec_tpu_torch "
            f"yet; use a local or NFS path"
        )
    return LocalFS()
