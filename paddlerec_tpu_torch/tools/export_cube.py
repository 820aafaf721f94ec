"""Export a trained model's embedding tables to cube KV shards: counterpart
of ``paddlerec_tpu/tools/export_cube.py`` (the reference's serving-side
table dump: large sparse tables leave the inference artifact and are
published to the cube KV store the serving fleet queries).

Usage:
    python -m paddlerec_tpu_torch.tools.export_cube -m config.yaml \
        -o runner.model_init_path=output/base_20240101 \
        --out cube_out --shards 8

``runner.model_init_path`` names a checkpoint of the port: a full one
(``<tag>/state``) or a params-only one (``<tag>/params``, the online loop's
base).  The tool reads it on the host and unpacks the tables with numpy; it
is a host tool, with no device and no ``--device``.  Without
``runner.model_init_path`` it exports the tables of a module freshly
initialized on the CPU from ``runner.seed``.  Each table goes to
``<out>/<name with / as _>/cube_shard_<s>.bin``, logical ids as keys.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping

import numpy as np
import torch

from paddlerec_tpu_torch.convert import DELTA_NAME, TABLE_NAME
from paddlerec_tpu_torch.core.config import load_config, parse_overrides, resolve_path
from paddlerec_tpu_torch.ops.packed_embedding import unpack_table


def _host_array(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        # numpy has no bfloat16: its values are exact in float32
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def collect_embedding_tables(params: Mapping[str, Any], vocab_size: int,
                             embedding_dim: int) -> Dict[str, np.ndarray]:
    """Find the embedding tables of a parameter mapping (a state_dict with
    ``.``-joined names, or a nested dict) and unpack them to logical
    ``(vocab, width)`` arrays, by flax-form name (``"embedding/embedding"``).

    A packed ``(R, 128)`` table is unpacked at the lane-window width its row
    count implies, widths tried descending (the true width has the largest
    base that fits under the row count: models fuse extra lanes, deepfm's
    E+1, so the window may be wider than ``sparse_feature_dim``, and tables
    padded for a mesh have a few rows more than the base).  A plain table
    passes as its first ``vocab_size`` rows.  The ``embedding_delta`` leaf
    (the JAX package's gradient tap of a sparse run) is no table, although
    it lives under a module named ``embedding``."""
    tables = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + tuple(str(k).split(".")))
            return
        if len(getattr(node, "shape", ())) != 2:
            return
        if path and path[-1] == DELTA_NAME:
            return
        if TABLE_NAME not in path:
            return
        arr = _host_array(node)
        dense = None
        if arr.shape[1] == 128 and vocab_size:
            for w in (128, 64, 32, 16, 8):
                pack = 128 // w
                base = (vocab_size + pack - 1) // pack
                if base <= arr.shape[0] < 2 * base:
                    dense = unpack_table(arr[:base], vocab_size, w)
                    break
        if dense is None:
            dense = arr[:vocab_size] if arr.shape[0] >= vocab_size else arr
        tables["/".join(path)] = dense

    walk(params, ())
    return tables


def main(argv=None):
    parser = argparse.ArgumentParser(description="export tables to cube KV")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--shards", type=int, default=1)
    args = parser.parse_args(argv)

    config = load_config(args.config_yaml, parse_overrides(args.opt))
    from paddlerec_tpu_torch.native.cube import export_table
    from paddlerec_tpu_torch.train import checkpoint as ckpt_lib
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    init_path = resolve_path(config, "runner.model_init_path")
    if init_path:
        params = ckpt_lib.load_params_from_state(os.path.dirname(init_path),
                                                 os.path.basename(init_path))
    else:
        trainer = Trainer(config, device="cpu")
        params = trainer.init_state().module.state_dict()
    tables = collect_embedding_tables(
        params,
        int(config.hyper("sparse_feature_number", 0)),
        int(config.hyper("sparse_feature_dim", 0)),
    )
    if not tables:
        logger.warning("no embedding tables found in params")
        return 1
    for name, dense in tables.items():
        out_dir = os.path.join(args.out, name.replace("/", "_"))
        keys = np.arange(len(dense), dtype=np.int64)
        paths = export_table(out_dir, keys, dense.astype(np.float32), args.shards)
        logger.info(f"exported table {name} ({dense.shape[0]}x{dense.shape[1]}) "
                    f"to {len(paths)} cube shards under {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
