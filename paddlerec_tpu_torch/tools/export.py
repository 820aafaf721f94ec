"""Inference artifact of the port: write and load.

The JAX package's artifact keeps its parameters in an orbax checkpoint,
which cannot be read without JAX.  The port's artifact is

    <export_dir>/
      config.json   — the flattened model config (as the JAX artifact's)
      params.npz    — the parameters under flat ``/``-joined flax names
                      (``tower/fc_0/kernel`` is ``(in, out)``), bfloat16
                      leaves widened to float32, which is exact

so parameters from either package load into the other through ``convert``.

Usage:
    python -m paddlerec_tpu_torch.tools.export -m config.yaml \
        --export_dir exported_model [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import Config, load_config, parse_overrides, resolve_path
from paddlerec_tpu_torch.core.device import full_float32_matmul, resolve_device
from paddlerec_tpu_torch.core.registry import load_model_def

logger = logging.getLogger("paddlerec_tpu_torch")


def export_model(config: Config, export_dir: str,
                 params: Optional[Mapping[str, Any]] = None,
                 seed: int = 0) -> str:
    """Write ``config.json`` and ``params.npz``.  ``params`` is a flax-named
    tree of numpy arrays (nested or flat); without it the parameters are a
    fresh init from ``torch.Generator().manual_seed(seed)``."""
    model_def = load_model_def(config)
    module = model_def.make_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    )
    if params is None:
        logger.warning(
            "no params given — exporting FRESHLY INITIALIZED (untrained) "
            "parameters (seed %d)", seed,
        )
    else:
        module.load_state_dict(from_jax_params(params))
    state = {k: v.float() if v.dtype == torch.bfloat16 else v
             for k, v in module.state_dict().items()}
    os.makedirs(export_dir, exist_ok=True)
    np.savez(os.path.join(export_dir, "params.npz"),
             **flatten_tree(to_jax_params(state)))
    cfg_out = {k: v for k, v in config.items() if _jsonable(v)}
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(cfg_out, f, indent=2)
    logger.info("exported inference artifact to %s", export_dir)
    return export_dir


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def load_exported(export_dir: str, device=None) -> Tuple[Any, nn.Module]:
    """Returns (model_def, module): the module holds the artifact's
    parameters on ``device`` (default ``cuda``) in eval mode."""
    device = resolve_device(device)
    full_float32_matmul()
    with open(os.path.join(export_dir, "config.json")) as f:
        config = Config(json.load(f))
    model_def = load_model_def(config)
    module = model_def.make_module(device="cpu")
    with np.load(os.path.join(export_dir, "params.npz")) as z:
        # the copy casts back to each parameter's dtype: bfloat16 tables
        # were widened exactly on export
        module.load_state_dict(from_jax_params({k: z[k] for k in z.files}))
    return model_def, module.to(device).eval()


def main(argv=None):
    parser = argparse.ArgumentParser(description="export inference artifact")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    export_dir = args.export_dir or resolve_path(
        config, "runner.export_dir", "exported_model"
    )
    export_model(config, export_dir, seed=args.seed)


if __name__ == "__main__":
    main()
