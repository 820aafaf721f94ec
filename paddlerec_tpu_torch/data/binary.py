"""slotbin: the binary converted-dataset format (InMemoryDataset analog).

A copy of ``paddlerec_tpu/data/binary.py``: the reader, the writer and the
text converter (``convert_text_files``, over the port's build of the native
parser, ``native/reader.py``; the Python parser where it cannot be built).
Slot text is converted ONCE to a columnar binary file that is then mmapped:
batch assembly is a row-range view of three contiguous arrays, with no
parse work on the host hot path.

File layout (little-endian):

    magic   "SLOTBIN1"                      8 bytes
    u32     header_bytes (data offset)
    u32     num_sparse (S)
    u32     dense_dim (D)
    u64     num_rows (N)
    u32     sparse_itemsize (4=int32, 8=int64)
    u32     ids_per_slot (L; 1 for criteo-style single-id slots)
    ...zero pad to header_bytes...
    f32     labels [N]
    iK      sparse [N, S, L]   (K = sparse_itemsize)
    f32     dense  [N, D]

Files written by either package's ``write_slotbin`` or converter
(``python -m paddlerec_tpu_torch.tools.dataset_convert``) are the same
bytes and read the same; the
trainer auto-detects ``.bin`` files (or ``runner.reader_type: binary``).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"SLOTBIN1"
HEADER_FMT = "<8sIIIQII"  # magic, header_bytes, S, D, N, itemsize, L
HEADER_BYTES = 64  # fixed, room for future fields

Batch = Dict[str, np.ndarray]


def write_slotbin(
    path: str,
    labels: np.ndarray,
    sparse: np.ndarray,
    dense: Optional[np.ndarray] = None,
    sparse_dtype=None,
) -> None:
    """Write one slotbin file.  sparse may be (N,S) or (N,S,L)."""
    labels = np.ascontiguousarray(labels, dtype=np.float32).reshape(-1)
    if sparse.ndim == 2:
        sparse = sparse[:, :, None]
    n, s, l = sparse.shape
    if len(labels) != n:
        raise ValueError(f"labels ({len(labels)}) != sparse rows ({n})")
    if sparse_dtype is None:
        sparse_dtype = sparse.dtype
    sparse_dtype = np.dtype(sparse_dtype)
    if sparse_dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
        raise ValueError(f"sparse dtype must be int32/int64, got {sparse_dtype}")
    if sparse_dtype == np.dtype(np.int32):
        lo, hi = sparse.min(initial=0), sparse.max(initial=0)
        if lo < np.iinfo(np.int32).min or hi > np.iinfo(np.int32).max:
            raise ValueError("ids overflow int32; use sparse_dtype=int64")
    sparse = np.ascontiguousarray(sparse, dtype=sparse_dtype)
    d = 0
    if dense is not None and dense.size:
        dense = np.ascontiguousarray(dense, dtype=np.float32)
        if dense.shape[0] != n:
            raise ValueError("dense rows mismatch")
        d = dense.shape[1]
    header = struct.pack(
        HEADER_FMT, MAGIC, HEADER_BYTES, s, d, n, sparse_dtype.itemsize, l
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(b"\0" * (HEADER_BYTES - len(header)))
        labels.tofile(f)
        sparse.tofile(f)
        if d:
            dense.tofile(f)
    os.replace(tmp, path)  # atomic: readers never see a partial file


def is_slotbin(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == MAGIC
    except OSError:
        return False


class SlotBinFile:
    """mmap view over one slotbin file; slicing rows is zero-copy."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            raw = f.read(struct.calcsize(HEADER_FMT))
        magic, hdr, s, d, n, isz, l = struct.unpack(HEADER_FMT, raw)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a slotbin file")
        self.num_sparse, self.dense_dim, self.num_rows = s, d, n
        self.ids_per_slot = l
        sdt = np.int32 if isz == 4 else np.int64
        off = hdr
        self.labels = np.memmap(path, np.float32, "r", off, (n,))
        off += n * 4
        self.sparse = np.memmap(path, sdt, "r", off, (n, s, l))
        off += n * s * l * isz
        if d:
            self.dense = np.memmap(path, np.float32, "r", off, (n, d))
        else:
            self.dense = None


class BinarySlotDataset:
    """File list → fixed-shape batches from mmapped slotbin files.

    Emits the same batch dict as SlotDataset/NativeSlotDataset:
    label (B,) f32, sparse (B,S) (squeezed when L==1), dense (B,D) f32,
    mask (B,) f32.  Partial batches carry across file boundaries.

    shuffle_files reshuffles the file order per epoch (seeded);
    shuffle_batches additionally permutes batch start offsets within
    each file — the local-shuffle analog of InMemoryDataset (row-level
    global shuffle belongs in the converter's --shuffle pass).
    """

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        drop_last: bool = True,
        shuffle_files: bool = False,
        shuffle_batches: bool = False,
        seed: int = 0,
        squeeze_ids: bool = True,
    ):
        self.files = list(files)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle_files = shuffle_files
        self.shuffle_batches = shuffle_batches
        self.seed = seed
        self.squeeze_ids = squeeze_ids
        self._epoch = 0

    def _emit(self, labels, sparse, dense, mask=None) -> Batch:
        bs = self.batch_size
        rows = len(labels)
        if sparse.ndim == 3 and self.squeeze_ids and sparse.shape[2] == 1:
            sparse = sparse[:, :, 0]
        batch = {
            "label": np.asarray(labels, np.float32),
            "sparse": np.asarray(sparse),
            "mask": np.ones(rows, np.float32) if mask is None else mask,
        }
        if dense is not None:
            batch["dense"] = np.asarray(dense)
        if rows < bs:
            pad = bs - rows
            batch["label"] = np.pad(batch["label"], (0, pad))
            batch["sparse"] = np.pad(
                batch["sparse"], ((0, pad),) + ((0, 0),) * (batch["sparse"].ndim - 1)
            )
            if dense is not None:
                batch["dense"] = np.pad(batch["dense"], ((0, pad), (0, 0)))
            batch["mask"] = np.concatenate(
                [batch["mask"][:rows], np.zeros(pad, np.float32)]
            )
        return batch

    def __iter__(self):
        bs = self.batch_size
        files = list(self.files)
        rng = np.random.RandomState(self.seed + self._epoch)
        if self.shuffle_files:
            rng.shuffle(files)
        self._epoch += 1
        rem: Optional[tuple] = None
        for path in files:
            f = SlotBinFile(path)
            n = f.num_rows
            base = 0
            if rem is not None:
                # fill the carried partial batch from this file's head
                need = bs - len(rem[0])
                take = min(need, n)
                labels = np.concatenate([rem[0], f.labels[:take]])
                sparse = np.concatenate([rem[1], f.sparse[:take]])
                dense = (
                    np.concatenate([rem[2], f.dense[:take]])
                    if f.dense is not None
                    else None
                )
                rem = None
                if len(labels) == bs:
                    yield self._emit(labels, sparse, dense)
                    base = take
                else:
                    rem = (labels, sparse, dense)
                    continue
            starts = list(range(base, n - bs + 1, bs))
            if self.shuffle_batches:
                rng.shuffle(starts)
            for i in starts:
                yield self._emit(
                    f.labels[i : i + bs],
                    f.sparse[i : i + bs],
                    f.dense[i : i + bs] if f.dense is not None else None,
                )
            tail = base + len(starts) * bs
            if tail < n:
                rem = (
                    np.asarray(f.labels[tail:]),
                    np.asarray(f.sparse[tail:]),
                    np.asarray(f.dense[tail:]) if f.dense is not None else None,
                )
        if rem is not None and len(rem[0]) and not self.drop_last:
            yield self._emit(*rem)


def convert_text_files(
    files: Sequence[str],
    out_dir: str,
    num_sparse: int,
    dense_dim: int,
    num_threads: int = 8,
    sparse_dtype=np.int64,
    shuffle_seed: Optional[int] = None,
    workers: int = 1,
) -> List[str]:
    """Convert slot-text files to slotbin (one .bin per input file).

    Uses the native C++ parser when available.  shuffle_seed row-shuffles
    each file during conversion (the global-shuffle analog).
    """
    os.makedirs(out_dir, exist_ok=True)
    jobs = [
        (path, os.path.join(out_dir, os.path.basename(path) + ".bin"),
         num_sparse, dense_dim, num_threads, np.dtype(sparse_dtype).str,
         shuffle_seed)
        for path in files
    ]
    if workers > 1 and len(jobs) > 1:
        from multiprocessing import Pool

        with Pool(workers) as pool:
            return pool.map(_convert_one, jobs)
    return [_convert_one(j) for j in jobs]


def _convert_one(job) -> str:
    path, out, num_sparse, dense_dim, num_threads, sdt, shuffle_seed = job
    labels, sparse, dense = _parse_text(path, num_sparse, dense_dim,
                                        num_threads)
    if shuffle_seed is not None:
        import zlib

        # stable per-file seed: Python's hash() is salted per process,
        # which would make --shuffle conversions irreproducible
        file_key = zlib.crc32(os.path.basename(path).encode())
        perm = np.random.RandomState(
            (shuffle_seed + file_key) % (2**31)
        ).permutation(len(labels))
        labels, sparse = labels[perm], sparse[perm]
        if dense is not None:
            dense = dense[perm]
    write_slotbin(out, labels, sparse, dense, sparse_dtype=np.dtype(sdt))
    return out


def _parse_text(path: str, num_sparse: int, dense_dim: int, num_threads: int):
    try:
        from paddlerec_tpu_torch.native.reader import parse_file

        labels, sparse, dense = parse_file(
            path, num_sparse, dense_dim, num_threads
        )
        return (
            labels.astype(np.float32),
            sparse,
            dense if dense_dim else None,
        )
    except Exception:
        # python fallback: standard slot schema (click/dense_feature/1..S)
        from paddlerec_tpu_torch.data.schema import SlotSchema
        from paddlerec_tpu_torch.data.slot_reader import parse_slot_lines

        schema = SlotSchema(
            label_slot="click",
            sparse_slots=[str(i) for i in range(1, num_sparse + 1)],
            dense_slots=["dense_feature"] if dense_dim else [],
            dense_dims=[dense_dim] if dense_dim else [],
        )
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        arrays = parse_slot_lines(lines, schema)
        return (
            arrays["label"],
            arrays["sparse"][:, :, 0],
            arrays.get("dense"),
        )
