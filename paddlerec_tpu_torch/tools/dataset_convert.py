"""Convert slot-text datasets to the binary slotbin format.

Counterpart of ``paddlerec_tpu/tools/dataset_convert.py``, with the same
flags and the same output bytes: text is parsed once (by the port's build
of the native parser) and mmapped ever after.

Usage:
    python -m paddlerec_tpu_torch.tools.dataset_convert -m config.yaml \
        [--data_dir DIR]... [--out_suffix _bin] [--shuffle] [--workers 8]

Converts runner.train_data_dir and runner.test_data_dir (or explicit
--data_dir args) into sibling ``<dir><out_suffix>/`` directories; point
the config at those (or leave the originals — the trainer auto-detects
``.bin`` files when a directory holds them).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def convert_dir(data_dir: str, out_dir: str, num_sparse: int, dense_dim: int,
                vocab: int, shuffle: bool, workers: int,
                threads: int) -> None:
    from paddlerec_tpu_torch.data.binary import convert_text_files
    from paddlerec_tpu_torch.data.slot_reader import list_data_files

    files = [f for f in list_data_files(data_dir)
             if not f.endswith(".bin")]
    sparse_dtype = np.int32 if 0 < vocab <= 2**31 - 1 else np.int64
    t0 = time.time()
    outs = convert_text_files(
        files, out_dir, num_sparse, dense_dim,
        num_threads=threads, sparse_dtype=sparse_dtype,
        shuffle_seed=2023 if shuffle else None, workers=workers,
    )
    rows = 0
    from paddlerec_tpu_torch.data.binary import SlotBinFile

    for p in outs:
        rows += SlotBinFile(p).num_rows
    dt = time.time() - t0
    print(
        f"converted {len(files)} files / {rows} rows from {data_dir} "
        f"to {out_dir} in {dt:.1f}s ({rows / max(dt, 1e-9):.0f} rows/s)"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="slot text -> slotbin")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--data_dir", action="append", default=None,
                        help="explicit dirs (default: train+test dirs)")
    parser.add_argument("--out_suffix", default="_bin")
    parser.add_argument("--shuffle", action="store_true",
                        help="row-shuffle each file during conversion")
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    parser.add_argument("--threads", type=int, default=4,
                        help="parser threads per file")
    args = parser.parse_args(argv)

    from paddlerec_tpu_torch.core.config import load_config, parse_overrides, resolve_path
    from paddlerec_tpu_torch.data.schema import schema_from_config

    config = load_config(args.config_yaml, parse_overrides(args.opt))
    schema = schema_from_config(config)
    vocab = int(config.hyper("sparse_feature_number", 0))
    dirs = args.data_dir or [
        d for d in (
            resolve_path(config, "runner.train_data_dir"),
            resolve_path(config, "runner.test_data_dir"),
        ) if d
    ]
    for d in dirs:
        convert_dir(
            d, d.rstrip("/") + args.out_suffix,
            len(schema.sparse_slots), schema.dense_dim, vocab,
            args.shuffle, args.workers, args.threads,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
