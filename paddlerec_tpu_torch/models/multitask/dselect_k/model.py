"""DSelect-K: differentiable top-k expert selection on MultiMNIST.

Counterpart of ``paddlerec_tpu/models/multitask/dselect_k/model.py``,
registered as ``multitask.dselect_k``:
  * ``ConvExperts`` (``experts``): E conv experts fused into one tower,
    ``conv1`` (10E channels, 5×5 ``VALID``) → relu → max-pool 2, ``conv2``
    grouped by expert (20E channels, ``groups=E``) → relu → max-pool 2, the
    per-expert flatten, then per-expert ``fc1`` (relu) and ``fc3`` as
    batched products over the expert axis;
  * ``DSelectKGate`` (``gate``): k single-expert selectors, each a product
    of ``ceil(log2 E)`` smooth-step bits matched against each expert's
    binary code, mixed by a softmax over ``w_logits``;
  * two 10-class towers (left and right digit); an ``AccuracyModelDef``
    with the accuracies ``acc_left`` and ``acc_right``.

Images arrive NHWC (B, 36, 36, 1) as in the JAX package and are permuted to
NCHW for ``conv2d``.  The JAX package flattens each expert's (6, 6, 20)
block in (h, w, c) order, so the port reorders its (c, h, w) block to
(h, w, c) before it flattens.  flax's ``lecun_normal`` on the ``(E, in,
out)`` parameters ``fc1_w`` and ``fc3_w`` counts the expert axis as a
receptive field: fan_in = E·in, which the port's init draws alike.

``MultiMNISTDataset`` is a copy of the JAX package's reader.
"""

from __future__ import annotations

import math
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import AccuracyModelDef, Aux
from paddlerec_tpu_torch.ops.layers import flax_conv2d, flax_dense, lecun_normal_


def smooth_step(x: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Cubic smooth step: 0 below -γ/2, 1 above γ/2 (net.py:121-137)."""
    a3 = -2.0 / gamma ** 3
    a1 = 3.0 / (2.0 * gamma)
    y = a3 * x ** 3 + a1 * x + 0.5
    return torch.where(x <= -gamma / 2, torch.zeros_like(x),
                       torch.where(x >= gamma / 2, torch.ones_like(x), y))


def _sym_uniform(shape, scale: float, device, generator) -> nn.Parameter:
    """Uniform(-scale, scale), paddle's symmetric Uniform init."""
    return nn.Parameter(
        (torch.rand(shape, device=device, generator=generator) * 2 - 1) * scale)


class DSelectKGate(nn.Module):
    """Static (input-independent) gate: experts (B, E, S) → (B, S)."""

    def __init__(self, expert_num: int, num_nonzeros: int, gamma: float = 1.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gamma = gamma
        num_binary = max(1, math.ceil(math.log2(expert_num)))
        self.z_logits = _sym_uniform((num_nonzeros, 1, num_binary), gamma / 100.0,
                                     device, generator)
        self.w_logits = _sym_uniform((num_nonzeros, 1), 1.0, device, generator)
        self.expert_num, self.num_binary = expert_num, num_binary

    def forward(self, experts: torch.Tensor) -> torch.Tensor:
        # the binary code of each expert id, most significant bit first:
        # (1, E, num_binary) in {0, 1}
        bits = torch.arange(self.num_binary - 1, -1, -1, device=experts.device)
        codes = (torch.arange(self.expert_num, device=experts.device)[:, None] >> bits) & 1
        acts = smooth_step(self.z_logits, self.gamma)  # (k, 1, nb)
        # selector i picks expert e with probability Π_b (code ? act : 1 - act)
        sel = torch.prod(torch.where(codes[None] > 0, acts, 1.0 - acts), dim=2)  # (k, E)
        sel_w = torch.softmax(self.w_logits, dim=0)  # (k, 1)
        expert_weights = torch.sum(sel_w * sel, dim=0)  # (E,)
        return torch.einsum("bes,e->bs", experts, expert_weights)


class ConvExperts(nn.Module):
    def __init__(self, expert_num: int, expert_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        e = self.expert_num = expert_num
        self.conv1 = flax_conv2d(1, 10 * e, 5, **kw)
        self.conv2 = flax_conv2d(10 * e, 20 * e, 5, groups=e, **kw)
        flat = 6 * 6 * 20
        self.fc1_w = nn.Parameter(lecun_normal_(torch.empty((e, flat, 50), device=device),
                                                e * flat, generator))
        self.fc1_b = nn.Parameter(torch.zeros((e, 50), device=device))
        self.fc3_w = nn.Parameter(lecun_normal_(
            torch.empty((e, 50, expert_size), device=device), e * 50, generator))
        self.fc3_b = nn.Parameter(torch.zeros((e, expert_size), device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # (B, 36, 36, 1)
        e = self.expert_num
        x = F.max_pool2d(torch.relu(self.conv1(images.permute(0, 3, 1, 2))), 2)
        x = F.max_pool2d(torch.relu(self.conv2(x)), 2)  # (B, 20E, 6, 6)
        b = x.shape[0]
        # expert g owns channels [20g, 20g + 20): its block in (h, w, c) order
        x = x.reshape(b, e, 20, 36).transpose(2, 3).reshape(b, e, -1)
        h = torch.relu(torch.einsum("bei,eio->beo", x, self.fc1_w) + self.fc1_b)
        return torch.einsum("bei,eio->beo", h, self.fc3_w) + self.fc3_b


class DSelectKNet(nn.Module):
    def __init__(self, expert_num: int, expert_size: int, tower_size: int, gate_num: int,
                 top_k: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.gate_num = gate_num
        self.experts = ConvExperts(expert_num, expert_size, **kw)
        self.gate = DSelectKGate(expert_num, top_k, **kw)
        for i in range(gate_num):
            self.add_module(f"tower_{i}_fc1", flax_dense(expert_size, 50, **kw))
            self.add_module(f"tower_{i}_fc2", flax_dense(50, 50, **kw))
            self.add_module(f"tower_{i}_out", flax_dense(50, 10, **kw))

    def forward(self, images):
        mixed = self.gate(torch.relu(self.experts(images)))
        outs = []
        for i in range(self.gate_num):
            h = torch.relu(getattr(self, f"tower_{i}_fc1")(mixed))
            h = torch.relu(getattr(self, f"tower_{i}_fc2")(h))
            outs.append(getattr(self, f"tower_{i}_out")(h))
        return tuple(outs)


@register_model("multitask.dselect_k")
class ModelDef(AccuracyModelDef):
    metric_names = ("left", "right")

    def __init__(self, config: Config):
        super().__init__(config)
        h = config.hyper
        self.hyper = (int(h("expert_num", 8)), int(h("expert_size", 50)),
                      int(h("tower_size", 8)), int(h("gate_num", 2)), int(h("top_k", 2)))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return DSelectKNet(*self.hyper, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["image"],)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {"image": rng.rand(batch_size, 36, 36, 1).astype(np.float32),
                "labels": rng.randint(0, 10, (batch_size, 2)).astype(np.int32),
                "mask": np.ones(batch_size, np.float32)}

    def train_forward(self, module, batch):
        logits_l, logits_r = module(*self.model_inputs(batch))
        labels = batch["labels"].long()
        mask = batch.get("mask")
        w = mask if mask is not None else torch.ones(labels.shape[0], device=labels.device)
        n = torch.clamp(w.sum(), min=1.0)

        def xent(logits, y):
            return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]

        loss = ((xent(logits_l, labels[:, 0]) + xent(logits_r, labels[:, 1])) * w).sum() / n
        aux: Aux = {
            # the confidence of the left digit: a per-row scalar for the
            # predict tooling to write
            "probs": torch.softmax(logits_l, dim=-1).max(-1).values,
            "correct_left": (logits_l.argmax(-1) == labels[:, 0]).to(torch.float32),
            "correct_right": (logits_r.argmax(-1) == labels[:, 1]).to(torch.float32),
        }
        if mask is not None:
            aux["mask"] = mask
        return loss, aux

    def metric_updates(self, aux):
        mask = aux.get("mask")
        return {"left": (aux["correct_left"], mask), "right": (aux["correct_right"], mask)}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return MultiMNISTDataset(list_data_files(data_dir), batch_size)


class MultiMNISTDataset:
    """Pickle files of ``(x: (N, 36·36) uint8, y: (N, 2) labels)``, the
    reference's MultiMNIST format (multiMNIST_reader.py:29-41); images
    scaled to [0, 1] as (B, 36, 36, 1); the tail batch padded with masked
    rows."""

    def __init__(self, files, batch_size):
        self.files = [f for f in files if f.endswith((".pickle", ".pkl"))]
        self.batch_size = batch_size

    def __iter__(self):
        bs = self.batch_size
        for path in self.files:
            with open(path, "rb") as f:
                x, y = pickle.load(f)
            x = np.asarray(x, np.float32).reshape(-1, 36, 36, 1) / 255.0
            y = np.asarray(y, np.int64).reshape(len(x), -1)[:, :2]
            for i in range(0, len(x), bs):
                xi, yi = x[i:i + bs], y[i:i + bs]
                valid = len(xi)
                if valid < bs:  # the masked partial tail: no row dropped
                    xi = np.concatenate([xi, np.zeros((bs - valid,) + xi.shape[1:], xi.dtype)])
                    yi = np.concatenate([yi, np.zeros((bs - valid,) + yi.shape[1:], yi.dtype)])
                m = np.zeros(bs, np.float32)
                m[:valid] = 1.0
                yield {"image": xi, "labels": yi.astype(np.int32), "mask": m}
