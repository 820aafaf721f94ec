"""Model registry + loader.

Same contract as ``paddlerec_tpu/core/registry.py``: built-in models are
addressable by name (``runner.model: rank.deepfm``) and live at
``paddlerec_tpu_torch.models.<family>.<name>.model``; a config without a
name may ship a ``model.py`` (defining ``ModelDef``) next to it.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}
# names registered by another model's module (the JAX package finds these by
# importing its whole zoo)
_ALIASES = {"rank.logistic_regression": "rank.lr", "graph.lightgcn": "graph.gnn",
            "graph.transformer_conv": "graph.gnn", "graph.deepwalk_million": "graph.gnn",
            "demo.movie_recall": "demo.movie_recommand",
            "demo.movie_rank": "demo.movie_recommand"}


def register_model(name: str):
    """Class decorator: register a ModelDef under ``family.name``."""

    def deco(cls):
        _REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def get_model_class(name: str):
    """Look up a registered ModelDef class, importing builtins on demand."""
    if name not in _REGISTRY:
        owner = _ALIASES.get(name, name)
        module_name = f"paddlerec_tpu_torch.models.{owner}.model"
        try:
            importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            # only a missing model module (or package above it) means "not
            # ported"; a ported model whose own import fails says so itself
            if not (e.name and (module_name + ".").startswith(e.name + ".")):
                raise
            raise KeyError(
                f"model {name!r} is not ported and {module_name} could not "
                f"be imported: {e}"
            ) from e
    if name not in _REGISTRY:
        raise KeyError(f"importing {name!r} did not register a model")
    return _REGISTRY[name]


def list_models():
    """Every registered name, the aliases included (imports the whole zoo
    first: importing the package alone registers nothing)."""
    import pkgutil

    from paddlerec_tpu_torch import models

    for info in pkgutil.walk_packages(models.__path__, models.__name__ + "."):
        if info.name.endswith(".model"):
            importlib.import_module(info.name)
    return sorted(set(_REGISTRY) | set(_ALIASES))


def _load_module_from_path(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load module from {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def load_model_def(config) -> Any:
    """Instantiate the ModelDef for a config.

    Resolution order:
      1. ``runner.model`` registry name (``rank.deepfm``);
      2. a ``model.py`` file next to the config (defines ``ModelDef``).
    """
    name = config.runner("model")
    if name:
        return get_model_class(name)(config)
    config_dir = config.get("config_dir", ".")
    model_py = os.path.join(config_dir, "model.py")
    if os.path.exists(model_py):
        mod = _load_module_from_path(model_py, f"user_model_{abs(hash(model_py))}")
        if not hasattr(mod, "ModelDef"):
            raise AttributeError(f"{model_py} must define a ModelDef class")
        return mod.ModelDef(config)
    raise ValueError(
        "config must set runner.model (registry name) or ship a model.py "
        f"next to {config.get('config_path')}"
    )
