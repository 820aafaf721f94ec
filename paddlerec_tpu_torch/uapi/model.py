"""``RankModel``: the facade of ``paddlerec_tpu/uapi/model.py`` over the
port's registry, ``Trainer``, ``tools/export``, ``tools/predict`` and
``tools/compress``.

The name resolves as in the JAX package (``"dnn"`` is ``"rank.dnn"``; a path
to a config.yaml is loaded), the error texts are the same, and ``infer``
writes ``predictions.txt`` with one ``%.6f`` value a line, every output
element in ``run_predict``'s order.  ``device`` is where every API runs:
``cuda`` unless ``"cpu"`` is asked for (without a card ``cuda`` raises).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from paddlerec_tpu_torch.core.config import Config, load_config
from paddlerec_tpu_torch.core.registry import get_model_class, list_models


class UnsupportedAPIError(RuntimeError):
    pass


class RankModel:
    """Facade over the rank-model zoo: train/evaluate/predict/export/infer/
    compression.

    ``model_name`` is either a registry name ("rank.dnn" / "dnn") or a path
    to a config.yaml.  Every API accepts ``config_overrides`` with the same
    dot-key semantics as the CLI's ``-o``.
    """

    SUPPORTED_APIS = ("train", "evaluate", "predict", "export", "infer")

    def __init__(self, model_name: str,
                 config: Optional[Dict[str, Any]] = None, device=None):
        self.device = device
        if os.path.exists(str(model_name)):
            self.config = load_config(model_name, config or {})
            self.model_name = str(self.config.runner("model"))
        else:
            name = model_name if "." in model_name else f"rank.{model_name}"
            try:
                get_model_class(name)  # imports and validates
            except KeyError as e:
                raise ValueError(
                    f"unknown model {model_name!r}; known: "
                    f"{sorted(list_models())}"
                ) from e
            self.model_name = name
            flat = {"runner.model": name}
            flat.update(config or {})
            self.config = Config(flat)

    # -- helpers --------------------------------------------------------------
    def _merged(self, overrides: Optional[Dict[str, Any]]) -> Config:
        cfg = self.config.copy()
        if overrides:
            cfg.update(overrides)
        return cfg

    def _precheck(self, cfg: Config, keys: List[str], api: str):
        missing = [k for k in keys if cfg.get(k) in (None, "")]
        if missing:
            raise UnsupportedAPIError(
                f"{api} requires config keys {missing} "
                f"(set them in the config or pass config_overrides)"
            )

    # -- APIs -----------------------------------------------------------------
    def train(self, dataset: Optional[str] = None,
              batch_size: Optional[int] = None,
              epochs_iters: Optional[int] = None,
              save_dir: Optional[str] = None,
              config_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        cfg = self._merged(config_overrides)
        if dataset:
            cfg["runner.train_data_dir"] = dataset
        if batch_size:
            cfg["runner.train_batch_size"] = int(batch_size)
        if epochs_iters:
            cfg["runner.epochs"] = int(epochs_iters)
        if save_dir:
            cfg["runner.model_save_path"] = save_dir
        self._precheck(cfg, ["runner.train_data_dir"], "train")
        from paddlerec_tpu_torch.train.trainer import Trainer

        return Trainer(cfg, device=self.device).train()

    def evaluate(self, weight_path: Optional[str] = None,
                 dataset: Optional[str] = None,
                 batch_size: Optional[int] = None,
                 config_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        cfg = self._merged(config_overrides)
        if dataset:
            cfg["runner.test_data_dir"] = dataset
        if batch_size:
            cfg["runner.infer_batch_size"] = int(batch_size)
        self._precheck(cfg, ["runner.test_data_dir"], "evaluate")
        from paddlerec_tpu_torch.train.trainer import Trainer

        trainer = Trainer(cfg, device=self.device)
        if weight_path:
            trainer.init_state()
            trainer.load_checkpoint(
                os.path.dirname(weight_path), os.path.basename(weight_path)
            )
        return trainer.evaluate()

    def export(self, weight_path: Optional[str], save_dir: str,
               config_overrides: Optional[Dict[str, Any]] = None) -> str:
        """Export a serving artifact.  ``weight_path``: a checkpoint directory
        of a training run (``.../<epoch>``), or None to export freshly
        initialized parameters."""
        cfg = self._merged(config_overrides)
        if weight_path:
            cfg["runner.model_init_path"] = weight_path
        from paddlerec_tpu_torch.tools.export import export_model

        return export_model(cfg, save_dir)

    def infer(self, model_dir: str, input_path: str,
              save_dir: Optional[str] = None, batch_size: int = 32,
              config_overrides: Optional[Dict[str, Any]] = None) -> str:
        """Inference from an EXPORTED artifact (compressed or not); writes
        ``save_dir/predictions.txt`` and returns its path."""
        from paddlerec_tpu_torch.tools.predict import run_predict

        overrides = dict(config_overrides or {})
        batch_size = int(overrides.get("runner.infer_batch_size", batch_size))
        outputs, _report = run_predict(model_dir, input_path, batch_size,
                                       device=self.device)
        save_dir = save_dir or "./uapi_infer_output"
        os.makedirs(save_dir, exist_ok=True)
        out_path = os.path.join(save_dir, "predictions.txt")
        with open(out_path, "w") as f:
            for arr in outputs:
                for v in np.asarray(arr).reshape(-1):
                    f.write(f"{float(v):.6f}\n")
        return out_path

    def predict(self, weight_path: str, input_path: str,
                save_dir: Optional[str] = None, batch_size: int = 32,
                config_overrides: Optional[Dict[str, Any]] = None) -> str:
        """Predict straight from a training checkpoint: export to a temporary
        artifact, then run the exported-inference path."""
        save_dir = save_dir or "./uapi_predict_output"
        with tempfile.TemporaryDirectory() as tmp:
            self.export(weight_path, tmp, config_overrides=config_overrides)
            return self.infer(tmp, input_path, save_dir, batch_size,
                              config_overrides)

    def compression(self, weight_path: str, save_dir: str,
                    config_overrides: Optional[Dict[str, Any]] = None) -> str:
        """Post-training compression: export the checkpoint and quantize its
        embedding tables to int8 with per-row scales (``tools/compress.py``;
        dequantized once at load)."""
        from paddlerec_tpu_torch.tools.compress import compress_artifact

        with tempfile.TemporaryDirectory() as tmp:
            self.export(weight_path, tmp, config_overrides=config_overrides)
            return compress_artifact(tmp, save_dir)
