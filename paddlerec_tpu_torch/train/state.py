"""Train state: module (parameters) + optimizer state + row-wise side state + step."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from paddlerec_tpu_torch.train.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    """Counterpart of ``paddlerec_tpu/train/state.py``.  The JAX state is an
    immutable pytree that every step replaces; here the module's parameters
    and the optimizer state are updated in place and ``step`` counts on the
    host.  ``extra`` is the row-wise optimizer state of the tables in
    external-update mode (``ModelDef.init_sparse_state``), or None."""

    step: int
    module: nn.Module
    opt_state: Any
    tx: Optimizer
    extra: Optional[Dict[str, Any]] = None

    @classmethod
    def create(cls, module: nn.Module, tx: Optimizer,
               extra: Optional[Dict[str, Any]] = None) -> "TrainState":
        state = cls(step=0, module=module, opt_state=None, tx=tx, extra=extra)
        state.opt_state = tx.init(state.params)
        return state

    @functools.cached_property
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters the optimizer steps, by their ``state_dict`` names
        (the module keeps the same parameter objects for its lifetime, so
        this is read once).  A table in external-update mode takes no
        gradient and is not among them: the optimizer never sees it and
        allocates no moments for it."""
        return {k: p for k, p in self.module.named_parameters()
                if p.requires_grad}

    def apply_gradients(self, norm: Optional[torch.Tensor] = None) -> None:
        """One optimizer step from the parameters' ``.grad``; ``norm``, the
        gradients' global norm for the optimizer's clip where the trainer
        takes it over a mesh (an ``Optimizer`` with a clip only)."""
        params = self.params
        grads = {k: p.grad for k, p in params.items()}
        if norm is None:
            self.tx.apply(params, grads, self.opt_state)
        else:
            self.tx.apply(params, grads, self.opt_state, norm=norm)
        self.step += 1
