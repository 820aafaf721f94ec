"""Filesystem abstraction: local paths + optional object stores.

A copy of ``paddlerec_tpu/utils/fs.py`` (the reference's
tools/utils/static_ps/util_hadoop.py and its HDFSClient plumbing):
donefiles, datasets and published models live on a shared store.  The TPU-era equivalents are
GCS/S3; both are optional deps, and every path-shaped API falls back to
the local filesystem so single-machine runs need nothing.

Scheme routing: ``gs://`` → GCS, ``hdfs://``/``afs://`` → raises with a
pointer (use gs/s3/local), anything else → local.
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
from typing import List


class LocalFS:
    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def append_line(self, path: str, line: str) -> None:
        with self.open(path, "a") as f:
            f.write(line + "\n")

    def read_text(self, path: str) -> str:
        with self.open(path, "r") as f:
            return f.read()

    def ls(self, path: str) -> List[str]:
        if os.path.isdir(path):
            return sorted(
                os.path.join(path, f) for f in os.listdir(path)
            )
        return sorted(_glob.glob(path))

    def open(self, path: str, mode: str = "r"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, mode)

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def upload(self, local: str, remote: str) -> None:
        if os.path.abspath(local) == os.path.abspath(remote):
            return
        if os.path.isdir(local):
            shutil.copytree(local, remote, dirs_exist_ok=True)
        else:
            os.makedirs(os.path.dirname(remote) or ".", exist_ok=True)
            shutil.copy2(local, remote)

    def download(self, remote: str, local: str) -> None:
        self.upload(remote, local)

    def rm(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)


class GCSFS:
    """gs:// paths via google-cloud-storage (optional dep)."""

    def __init__(self):
        try:
            from google.cloud import storage
        except ImportError as e:  # pragma: no cover - optional dep
            raise RuntimeError(
                "google-cloud-storage is not installed; gs:// unavailable"
            ) from e
        self._client = storage.Client()

    def _split(self, path: str):
        assert path.startswith("gs://")
        bucket, _, key = path[5:].partition("/")
        return self._client.bucket(bucket), key

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        return bucket.blob(key).exists()

    def ls(self, path: str) -> List[str]:
        bucket, key = self._split(path)
        return sorted(
            f"gs://{bucket.name}/{b.name}"
            for b in bucket.list_blobs(prefix=key.rstrip("/") + "/")
        )

    def open(self, path: str, mode: str = "r"):
        bucket, key = self._split(path)
        return bucket.blob(key).open(mode)

    def mkdir(self, path: str) -> None:  # object stores have no dirs
        pass

    def upload(self, local: str, remote: str) -> None:
        bucket, key = self._split(remote)
        bucket.blob(key).upload_from_filename(local)

    def download(self, remote: str, local: str) -> None:
        bucket, key = self._split(remote)
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        bucket.blob(key).download_to_filename(local)

    def rm(self, path: str) -> None:
        bucket, key = self._split(path)
        bucket.blob(key).delete()

    def isdir(self, path: str) -> bool:
        # object stores have no dirs: a "dir" exists if any key lives
        # under the prefix
        bucket, key = self._split(path)
        return any(
            True for _ in bucket.list_blobs(
                prefix=key.rstrip("/") + "/", max_results=1
            )
        )

    def append_line(self, path: str, line: str) -> None:
        # GCS has no append: read-modify-write (donefiles are tiny and
        # single-writer by protocol)
        prev = ""
        if self.exists(path):
            with self.open(path, "r") as f:
                prev = f.read()
        with self.open(path, "w") as f:
            f.write(prev + line + "\n")

    def read_text(self, path: str) -> str:
        with self.open(path, "r") as f:
            return f.read()


def get_fs(path: str):
    """Route a path to its filesystem."""
    if path.startswith("gs://"):
        return GCSFS()
    if path.startswith(("hdfs://", "afs://")):
        raise RuntimeError(
            "HDFS/AFS is a paddle-fleet-era store; point the config at a "
            "gs:// bucket or a local/NFS path instead"
        )
    return LocalFS()
