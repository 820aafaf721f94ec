"""NativeSlotDataset: the C++ fast path for slot-text ingestion.

A copy of ``paddlerec_tpu/native/reader.py`` over the port's build of
``native/fast_reader.cpp`` (``native/__init__.py`` ``fastreader``).  It is a
drop-in replacement for ``SlotDataset`` on the Criteo-style schema: each
file is parsed by libfastreader's thread pool into contiguous arrays, then
sliced into batches, with no Python per-line work on the hot path.

Enable with ``runner.reader_type: native`` (``Trainer.make_dataset`` falls
back to the Python ``SlotDataset`` only when the library cannot be built).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from paddlerec_tpu_torch.native import NativeUnavailable, fastreader


def parse_file(path: str, num_sparse: int, dense_dim: int,
               num_threads: int = 8):
    """(labels (N,), sparse (N,S), dense (N,D)) parsed natively."""
    import os as _os

    lib = fastreader()
    max_rows = lib.frd_count_lines(path.encode())
    if max_rows < 0:
        raise FileNotFoundError(path)
    # frd_count_lines counts newlines; a file without a trailing newline
    # still has one more record
    if _os.path.getsize(path) > 0:
        with open(path, "rb") as _f:
            _f.seek(-1, 2)
            if _f.read(1) != b"\n":
                max_rows += 1
    if max_rows == 0:
        return (
            np.zeros((0,), np.int64),
            np.zeros((0, num_sparse), np.int64),
            np.zeros((0, dense_dim), np.float32),
        )
    labels = np.zeros((max_rows,), np.int64)
    sparse = np.zeros((max_rows, num_sparse), np.int64)
    dense = np.zeros((max_rows, max(dense_dim, 1)), np.float32)
    n = lib.frd_parse_file(
        path.encode(), num_sparse, dense_dim, max_rows, num_threads,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        raise IOError(f"fastreader failed on {path}: {n}")
    return labels[:n], sparse[:n], dense[:n, :dense_dim]


class NativeSlotDataset:
    """File list → batches via the native parser."""

    def __init__(self, files: Sequence[str], num_sparse: int, dense_dim: int,
                 batch_size: int, drop_last: bool = True,
                 num_threads: int = 8, shuffle_files: bool = False,
                 seed: int = 0):
        self.files = list(files)
        self.num_sparse = num_sparse
        self.dense_dim = dense_dim
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.shuffle_files = shuffle_files
        self.seed = seed
        self._epoch = 0

    def __iter__(self):
        bs = self.batch_size
        files = list(self.files)
        if self.shuffle_files:
            # seeded + epoch-bumped, mirroring SlotDataset: each epoch
            # draws a fresh permutation, identical across restarts
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(files)
        self._epoch += 1
        # carry partial batches across file boundaries (the Python
        # SlotDataset buffers the same way; dropping per-file remainders
        # silently discarded files smaller than the batch size)
        rem = None
        for path in files:
            labels, sparse, dense = parse_file(
                path, self.num_sparse, self.dense_dim, self.num_threads
            )
            if rem is not None:
                labels = np.concatenate([rem[0], labels])
                sparse = np.concatenate([rem[1], sparse])
                dense = np.concatenate([rem[2], dense])
                rem = None
            n = len(labels)
            stop = n - (n % bs)
            for i in range(0, stop, bs):
                yield self._emit(labels, sparse, dense, i, i + bs, bs)
            if stop < n:
                rem = (labels[stop:], sparse[stop:], dense[stop:])
        if rem is not None and len(rem[0]) and not self.drop_last:
            labels, sparse, dense = rem
            yield self._emit(labels, sparse, dense, 0, len(labels), bs)

    def _emit(self, labels, sparse, dense, i, j, bs):
        rows = j - i
        batch = {
            "label": labels[i:j].astype(np.float32),
            "sparse": sparse[i:j],
            "mask": np.ones(rows, np.float32),
        }
        if self.dense_dim:
            batch["dense"] = dense[i:j]
        if rows < bs:  # pad the tail batch
            pad = bs - rows
            batch["label"] = np.pad(batch["label"], (0, pad))
            batch["sparse"] = np.pad(batch["sparse"], ((0, pad), (0, 0)))
            if self.dense_dim:
                batch["dense"] = np.pad(batch["dense"], ((0, pad), (0, 0)))
            batch["mask"] = np.concatenate(
                [batch["mask"], np.zeros(pad, np.float32)]
            )
        return batch


def native_available() -> bool:
    try:
        fastreader()
        return True
    except NativeUnavailable:
        return False
