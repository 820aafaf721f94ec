"""Post-training compression of the port's inference artifacts.

The port of ``paddlerec_tpu/tools/compress.py``: the embedding tables of an
artifact (``tools/export.py``: ``params.npz`` and ``config.json``) are
quantized to int8 with one absmax scale a row (4× smaller than float32);
the dense leaves stay as they are.  ``load_exported`` dequantizes once at
load, so the served code is the same.

    <out_dir>/
      config.json     — the artifact's, with ``"compressed": true``
      params.npz      — the small leaves; a quantized leaf is a (0,) float32
                        placeholder
      quantized.npz   — ``<path>/q`` int8 (R, C), ``<path>/scale`` float32
                        (R,), ``<path>/dtype`` the leaf's dtype name

The rule is the JAX tool's, in the same numpy operations, so the same
parameters give bitwise the same ``q`` and ``scale``: a 2-D leaf of at
least ``MIN_ROWS`` rows whose dtype is a numpy float (float16/32/64) is
quantized.  The JAX tool reads a bfloat16 leaf as ml_dtypes' ``bfloat16``,
which numpy does not count as a float, so a bfloat16 table stays whole
there; the port's artifact widens bfloat16 to float32, and the leaf's
dtype in the model decides here, so both packages keep the same leaves.

    python -m paddlerec_tpu_torch.tools.compress --export_dir exported_model \
        --out compressed_model
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np

from paddlerec_tpu_torch.convert import flatten_tree

QUANT_FILE = "quantized.npz"
PARAMS_FILE = "params.npz"
MIN_ROWS = 1024  # only quantize real tables, not small dense parameters
_NUMPY_FLOATS = ("float16", "float32", "float64")


def quantize_params(params, min_rows: int = MIN_ROWS,
                    dtypes: Optional[Mapping[str, str]] = None):
    """Split a params tree (nested, or flat with ``/`` keys, of numpy
    arrays) into (small, quant): ``small`` the flat tree with a (0,) float32
    placeholder for each quantized leaf, ``quant`` maps ``a/b/c`` → (q int8
    (R, C), scale float32 (R,), dtype name).  ``dtypes`` names a leaf's
    dtype where the array's is not its own (a widened bfloat16)."""
    quant = {}
    small = {}
    for path, value in flatten_tree(params).items():
        arr = np.asarray(value)
        dtype = (dtypes or {}).get(path, str(arr.dtype))
        if arr.ndim == 2 and arr.shape[0] >= min_rows and dtype in _NUMPY_FLOATS:
            f32 = arr.astype(np.float32)
            scale = np.abs(f32).max(axis=1) / 127.0
            scale = np.maximum(scale, 1e-12)
            q = np.clip(np.rint(f32 / scale[:, None]), -127, 127).astype(np.int8)
            quant[path] = (q, scale.astype(np.float32), dtype)
            small[path] = np.zeros((0,), np.float32)
        else:
            small[path] = value
    return small, quant


def dequantize_into(params: Mapping[str, np.ndarray], quant_npz) -> Dict[str, np.ndarray]:
    """The flat params with every placeholder replaced by its dequantized
    leaf, ``q · scale`` in float32 cast to the leaf's dtype."""
    out = dict(params)
    names = {k[:-len("/q")] for k in quant_npz.files if k.endswith("/q")}
    for name in names:
        q = quant_npz[f"{name}/q"]
        scale = quant_npz[f"{name}/scale"]
        dtype = str(quant_npz[f"{name}/dtype"])
        out[name] = (q.astype(np.float32) * scale[:, None]).astype(dtype)
    return out


def _module_dtypes(config: Mapping) -> Dict[str, str]:
    """Each parameter's dtype name in the model, by its flax name (read off
    a module on the ``meta`` device: nothing is allocated)."""
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.core.registry import load_model_def

    module = load_model_def(Config(dict(config))).make_module(device="meta")
    out = {}
    for key, t in module.state_dict().items():
        *parents, leaf = key.split(".")
        leaf = "kernel" if leaf == "weight" else leaf
        out["/".join([*parents, leaf])] = str(t.dtype).replace("torch.", "")
    return out


def _tree_bytes(root: str) -> int:
    total = 0
    for r, _d, fs in os.walk(root):
        total += sum(os.path.getsize(os.path.join(r, x)) for x in fs)
    return total


def compress_artifact(export_dir: str, out_dir: str,
                      min_rows: int = MIN_ROWS) -> str:
    with open(os.path.join(export_dir, "config.json")) as f:
        cfg = json.load(f)
    with np.load(os.path.join(export_dir, PARAMS_FILE)) as z:
        params = {k: z[k] for k in z.files}
    small, quant = quantize_params(params, min_rows, _module_dtypes(cfg))
    os.makedirs(out_dir, exist_ok=True)
    payload = {}
    for name, (q, scale, dtype) in quant.items():
        payload[f"{name}/q"] = q
        payload[f"{name}/scale"] = scale
        payload[f"{name}/dtype"] = np.asarray(dtype)
    np.savez_compressed(os.path.join(out_dir, QUANT_FILE), **payload)
    np.savez(os.path.join(out_dir, PARAMS_FILE), **small)
    cfg["compressed"] = True
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    before, after = _tree_bytes(export_dir), _tree_bytes(out_dir)
    print(
        f"compressed {len(quant)} table(s): {before / 1e6:.1f} MB -> "
        f"{after / 1e6:.1f} MB ({before / max(after, 1):.1f}x)"
    )
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="artifact compression")
    p.add_argument("--export_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min_rows", type=int, default=MIN_ROWS)
    args = p.parse_args(argv)
    compress_artifact(args.export_dir, args.out, args.min_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
