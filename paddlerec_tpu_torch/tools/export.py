"""Inference artifact of the port: write and load.

The JAX package's artifact keeps its parameters in an orbax checkpoint,
which cannot be read without JAX.  The port's artifact is

    <export_dir>/
      config.json   — the flattened model config (as the JAX artifact's)
      params.npz    — the parameters under flat ``/``-joined flax names
                      (``tower/fc_0/kernel`` is ``(in, out)``), bfloat16
                      leaves widened to float32, which is exact

so parameters from either package load into the other through ``convert``.
``tools/compress.py`` turns an artifact into a compressed one (int8 tables
in ``quantized.npz``), which ``load_exported`` reads as well.
The artifact of a sparse run (``hyper_parameters.sparse_update``) is flipped
to the plain lookup, as the JAX package's is: its config says ``sparse_update:
false``, so a bfloat16 table serves bfloat16 vectors where the training
module's external lookup gave float32 ones.

Usage:
    python -m paddlerec_tpu_torch.tools.export -m config.yaml \
        -o runner.model_init_path=output_model_deepfm/2 \
        --export_dir exported_model [--epoch N] [--seed 0]
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
from paddlerec_tpu_torch.tools.compress import QUANT_FILE, dequantize_into
from paddlerec_tpu_torch.train import checkpoint as ckpt_lib

logger = logging.getLogger("paddlerec_tpu_torch")


def export_model(config: Config, export_dir: str,
                 params: Optional[Mapping[str, Any]] = None,
                 seed: int = 0, epoch_tag=None) -> str:
    """Write ``config.json`` and ``params.npz``.  The parameters are, in this
    order: ``params``, a flax-named tree of numpy arrays (nested or flat);
    the checkpoint ``epoch_tag`` under ``runner.infer_load_path``; the
    checkpoint ``runner.model_init_path``; a fresh init from
    ``torch.Generator().manual_seed(seed)``."""
    model_def = load_model_def(config)
    init_path = resolve_path(config, "runner.model_init_path")
    state = None
    if params is not None:
        state = from_jax_params(params)
    elif epoch_tag is not None:
        load_root = resolve_path(config, "runner.infer_load_path")
        if not load_root:
            raise ValueError(
                "exporting a specific epoch requires "
                "runner.infer_load_path (the checkpoint root)"
            )
        state = ckpt_lib.load_params_from_state(load_root, epoch_tag)
    elif init_path:
        state = ckpt_lib.load_params_from_state(
            os.path.dirname(init_path), os.path.basename(init_path))
    if state is None:
        logger.warning(
            "no params, runner.model_init_path or epoch given — exporting "
            "FRESHLY INITIALIZED (untrained) parameters (seed %d)", seed,
        )
        state = model_def.make_module(
            device="cpu", generator=torch.Generator().manual_seed(seed)
        ).state_dict()
    else:
        _check_against_module(model_def, state)
    state = {k: v.float() if v.dtype == torch.bfloat16 else v
             for k, v in state.items()}
    os.makedirs(export_dir, exist_ok=True)
    np.savez(os.path.join(export_dir, "params.npz"),
             **flatten_tree(to_jax_params(state)))
    cfg_out = {k: v for k, v in config.items() if _jsonable(v)}
    if model_def.sparse_update_enabled():
        cfg_out["hyper_parameters.sparse_update"] = False
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(cfg_out, f, indent=2)
    logger.info("exported inference artifact to %s", export_dir)
    return export_dir


def _check_against_module(model_def, state: Mapping[str, torch.Tensor]) -> None:
    """Raise unless ``state`` has the names and shapes of the model's
    parameters (read off a module on the ``meta`` device: nothing of a
    table's size is allocated)."""
    want = model_def.make_module(device="meta").state_dict()
    if set(want) != set(state):
        raise ValueError(
            f"parameters {sorted(state)} do not match the model's {sorted(want)}")
    for k, v in want.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(
                f"{k}: shape {tuple(state[k].shape)}, the model has {tuple(v.shape)}")


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def load_exported(export_dir: str, device=None) -> Tuple[Any, nn.Module]:
    """Returns (model_def, module): the module holds the artifact's
    parameters on ``device`` (default ``cuda``) in eval mode.  A compressed
    artifact (``quantized.npz`` beside ``params.npz``) loads the same way,
    its int8 tables dequantized at load, as the JAX package's loader does."""
    device = resolve_device(device)
    full_float32_matmul()
    with open(os.path.join(export_dir, "config.json")) as f:
        config = Config(json.load(f))
    model_def = load_model_def(config)
    # built without storage and filled from the artifact: no random init of
    # a table that is overwritten next
    module = model_def.make_module(device="meta")
    with np.load(os.path.join(export_dir, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    quant_path = os.path.join(export_dir, QUANT_FILE)
    if os.path.exists(quant_path):
        # a compressed artifact (tools/compress.py): the quantized tables
        # fill their placeholders, dequantized once here
        with np.load(quant_path) as quant:
            params = dequantize_into(params, quant)
    state = from_jax_params(params)
    _check_against_module(model_def, state)
    # cast back to each parameter's dtype: bfloat16 tables were widened
    # exactly on export
    want = module.state_dict()
    state = {k: v.to(device=device, dtype=want[k].dtype) for k, v in state.items()}
    module.load_state_dict(state, assign=True)
    return model_def, module.eval()


def main(argv=None):
    parser = argparse.ArgumentParser(description="export inference artifact")
    parser.add_argument("-m", "--config_yaml", required=True)
    parser.add_argument("-o", "--opt", nargs="*", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--epoch", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config_yaml, parse_overrides(args.opt))
    export_dir = args.export_dir or resolve_path(
        config, "runner.export_dir", "exported_model"
    )
    export_model(config, export_dir, seed=args.seed, epoch_tag=args.epoch)


if __name__ == "__main__":
    main()
