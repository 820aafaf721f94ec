"""Host-side reader for slot:feasign text data.

A copy of the framework-free part of ``paddlerec_tpu/data/slot_reader.py``
(``list_data_files``, ``shard_files``, ``parse_slot_lines``, ``SlotDataset``
with its ``pipe_command`` stage, ``PrefetchIterator``): fixed-shape
numpy batches, the tail batch padded and marked by a ``mask``, and
``(B, S, 1)`` ids squeezed to ``(B, S)``.  The caller moves batches to its
device (``core.device.to_tensors``).

The parse loop accepts the exact line protocol of the reference readers:
``click:1 1:715353 2:817085 ... dense_feature:0.05 dense_feature:0.006 ...``
Missing sparse slots are padded with ``padding_id``; missing dense slots are
zero-filled (criteo_reader.py:80-91 behavior).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from paddlerec_tpu_torch.data.schema import SlotSchema

Batch = Dict[str, np.ndarray]


def list_data_files(data_dir: str, pattern: str = "*") -> List[str]:
    """All regular files under data_dir (sorted for determinism)."""
    files = [
        f
        for f in sorted(glob.glob(os.path.join(data_dir, pattern)))
        if os.path.isfile(f)
    ]
    if not files:
        raise FileNotFoundError(f"no data files found under {data_dir!r}")
    return files


def shard_files(files: Sequence[str], worker_id: int, num_workers: int) -> List[str]:
    """Deterministic per-worker file shard (round-robin).

    Same coverage contract as the reference's block sharding
    (criteo_reader.py:30-43): every file belongs to exactly one worker.
    """
    if num_workers <= 1:
        return list(files)
    if len(files) < num_workers:
        raise ValueError(
            f"number of data files ({len(files)}) is less than the number "
            f"of workers ({num_workers})"
        )
    return list(files[worker_id::num_workers])


def parse_slot_lines(
    lines: Sequence[str], schema: SlotSchema
) -> Dict[str, np.ndarray]:
    """Parse text lines into dense arrays.

    Returns dict with:
      label:  (N,) float32
      sparse: (N, S, L) int64  (L = schema.ids_per_slot)
      dense:  (N, D) float32   (D = schema.dense_dim; omitted when D == 0)
    """
    n = len(lines)
    s = schema.num_sparse
    ids_l = schema.ids_per_slot
    d = schema.dense_dim

    labels = np.zeros((n,), np.float32)
    sparse = np.full((n, s, ids_l), schema.padding_id, np.int64)
    dense = np.zeros((n, d), np.float32) if d else None

    sparse_index = {name: i for i, name in enumerate(schema.sparse_slots)}
    dense_offsets = {}
    dense_dims = {}
    off = 0
    for name, dim in zip(schema.dense_slots, schema.dense_dims):
        dense_offsets[name] = off
        dense_dims[name] = dim
        off += dim
    label_slot = schema.label_slot

    for row, line in enumerate(lines):
        sparse_counts = [0] * s
        dense_counts = dict.fromkeys(dense_offsets, 0)
        for token in line.split():
            slot, sep, value = token.partition(":")
            if not sep:
                continue
            if slot == label_slot:
                labels[row] = float(value)
            elif slot in sparse_index:
                si = sparse_index[slot]
                c = sparse_counts[si]
                if c < ids_l:
                    sparse[row, si, c] = int(value)
                    sparse_counts[si] = c + 1
            elif slot in dense_offsets:
                c = dense_counts[slot]
                if c < dense_dims[slot]:  # extra values: drop, like sparse
                    dense[row, dense_offsets[slot] + c] = float(value)
                    dense_counts[slot] = c + 1
    out = {"label": labels, "sparse": sparse}
    if dense is not None:
        out["dense"] = dense
    return out


class SlotDataset:
    """Iterates fixed-shape batches over a list of files.

    Args:
      files: text files in slot:feasign format.
      schema: slot schema.
      batch_size: rows emitted per batch.
      drop_last: drop the trailing partial batch; when kept (the default)
        it is padded to ``batch_size`` and a "mask" key marks padded rows.
      shuffle_files / seed: epoch-level file order shuffling.
      squeeze_ids: emit sparse as (B, S) instead of (B, S, 1) when L == 1.
      pipe_command: a shell command each file is piped through before the
        parser (``cat file | pipe_command``); a non-zero exit raises.
    """

    def __init__(
        self,
        files: Sequence[str],
        schema: SlotSchema,
        batch_size: int,
        drop_last: bool = False,
        shuffle_files: bool = False,
        seed: int = 0,
        squeeze_ids: bool = True,
        parse_chunk: int = 4096,
        pipe_command: Optional[str] = None,
    ):
        self.files = list(files)
        self.schema = schema
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle_files = shuffle_files
        self.seed = seed
        self.squeeze_ids = squeeze_ids and schema.ids_per_slot == 1
        self.parse_chunk = parse_chunk
        # arbitrary user preprocess subprocess per file (the reference's
        # QueueDataset pipe_command stage)
        self.pipe_command = pipe_command
        self._epoch = 0

    def _file_order(self) -> List[str]:
        files = list(self.files)
        if self.shuffle_files:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(files)
        return files

    def _iter_lines(self) -> Iterator[str]:
        for path in self._file_order():
            if self.pipe_command:
                yield from self._piped_lines(path)
                continue
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line

    def _piped_lines(self, path: str) -> Iterator[str]:
        import subprocess

        with open(path, "rb") as src:
            proc = subprocess.Popen(
                self.pipe_command, shell=True, stdin=src,
                stdout=subprocess.PIPE, text=True,
            )
        assert proc.stdout is not None
        # the consumer may abandon this generator mid-file (drop_last break,
        # eval early-exit): always reap the child and close its pipe, or
        # every abandoned epoch leaks a subprocess
        finished = False
        try:
            for line in proc.stdout:
                line = line.strip()
                if line:
                    yield line
            finished = True
        finally:
            if not finished and proc.poll() is None:
                proc.kill()
            proc.stdout.close()
            rc = proc.wait()
            if finished and rc != 0:
                raise RuntimeError(
                    f"pipe_command {self.pipe_command!r} failed "
                    f"with exit code {rc} on {path}"
                )

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        pend: List[str] = []
        arrays: List[Dict[str, np.ndarray]] = []
        buffered = 0

        def flush_parse():
            nonlocal pend, buffered
            if pend:
                arrays.append(parse_slot_lines(pend, self.schema))
                buffered += len(pend)
                pend = []

        def emit(batch_rows: Dict[str, np.ndarray], pad_to: Optional[int]) -> Batch:
            out = dict(batch_rows)
            n = len(out["label"])
            if pad_to is not None and n < pad_to:
                mask = np.zeros((pad_to,), np.float32)
                mask[:n] = 1.0
                for k, v in out.items():
                    pad_shape = (pad_to - n,) + v.shape[1:]
                    out[k] = np.concatenate(
                        [v, np.zeros(pad_shape, v.dtype)], axis=0
                    )
                out["mask"] = mask
            else:
                out["mask"] = np.ones((n,), np.float32)
            if self.squeeze_ids:
                out["sparse"] = out["sparse"][:, :, 0]
            return out

        def pop_batch(size: int) -> Dict[str, np.ndarray]:
            nonlocal arrays, buffered
            keys = arrays[0].keys()
            merged = {
                k: np.concatenate([a[k] for a in arrays], axis=0) for k in keys
            }
            batch = {k: v[:size] for k, v in merged.items()}
            rest = {k: v[size:] for k, v in merged.items()}
            arrays = [rest] if len(rest["label"]) else []
            buffered -= size
            return batch

        for line in self._iter_lines():
            pend.append(line)
            if len(pend) >= self.parse_chunk:
                flush_parse()
            while buffered >= self.batch_size:
                yield emit(pop_batch(self.batch_size), None)
        flush_parse()
        while buffered >= self.batch_size:
            yield emit(pop_batch(self.batch_size), None)
        if buffered and not self.drop_last:
            yield emit(pop_batch(buffered), self.batch_size)


class PrefetchIterator:
    """Runs an iterator in a background thread with a bounded queue."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer thread
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
