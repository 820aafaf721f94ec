"""MAML: a few-shot Omniglot classifier, meta-trained through its inner loop.

Counterpart of ``paddlerec_tpu/models/multitask/maml/model.py``, registered
as ``multitask.maml``: ``ConvNet``, four blocks of conv 3×3-64 (padding 1)
→ ``TransductiveBN`` → relu → max-pool 2, then ``head`` (64 → n_way).  A
step runs, for each task of the batch, ``update_step`` inner SGD steps at
``base_optimizer.learning_rate`` over every parameter on the support set,
then the query loss under the adapted (fast) weights; the step's loss is
the mean over tasks, and its gradient the second-order meta-gradient
through the inner steps (``torch.autograd.grad`` with ``create_graph=True``).
The metric is the query accuracy after adaptation.  The outer optimizer is
Adam at ``meta_optimizer.learning_rate`` whatever ``optimizer.class`` says,
as in the JAX package.

The JAX package runs the tasks one after another under ``lax.scan``, which
XLA compiles into one program.  Run eagerly, a task at a time, a step of 32
tasks is ~126,000 kernel launches (2.4 s on an H100, the host's).  So the
port runs every task of a batch at once (``conv_net_tasks``): each task has
its own copy of the fast weights (a leading task axis, the initial ones an
``expand`` of the module's parameters, so the meta-gradient sums over
tasks), the convolutions are grouped by task, the batch statistics are
taken per task, and the inner gradient of the sum of the tasks' losses is
each task's own.  The numbers are the scan's, up to the order of float32
sums.  ``ConvNet.forward`` is the one-task net, with the same parameters.

Evaluation and serving run the same inner loop, so they need gradients:
``infer_needs_grad`` makes the entry points enable them; the inner gradient
there is first order (nothing differentiates the result again).

Images arrive NHWC (T, N, S, S, 1) and are permuted to NCHW; the flatten
before the head follows the JAX package's (h, w, c) order.
``OmniglotTaskDataset`` is a copy of the JAX package's episode sampler, its
``RandomState(12345)`` included, so both packages draw the same episodes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import AccuracyModelDef, Aux
from paddlerec_tpu_torch.models.multitask.base import adapted
from paddlerec_tpu_torch.ops.layers import flax_conv2d, flax_dense


def transductive_bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    dims) -> torch.Tensor:
    """Normalise ``x`` by its statistics over ``dims`` (the population
    variance, eps 1e-5), then ``scale`` and shift; ``scale`` and ``bias``
    broadcast against ``x``."""
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


class TransductiveBN(nn.Module):
    """Normalise by the current batch's statistics with a learned ``scale``
    (ones) and ``bias`` (zeros); no running averages, as in the JAX
    package.  x (B, C, H, W)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return transductive_bn(x, self.scale[:, None, None], self.bias[:, None, None],
                               (0, 2, 3))


class ConvNet(nn.Module):
    def __init__(self, n_way: int = 5, imgsize: int = 28, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        side = imgsize
        for i in range(4):
            self.add_module(f"conv_{i}", flax_conv2d(1 if i == 0 else 64, 64, 3, padding=1,
                                                     **kw))
            self.add_module(f"bn_{i}", TransductiveBN(64, device=device))
            side //= 2
        self.head = flax_dense(64 * side * side, n_way, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # (B, S, S, 1)
        """One task's logits (B, n_way)."""
        params = {k: p[None] for k, p in self.named_parameters()}
        return conv_net_tasks(params, images[None])[0]


def conv_net_tasks(params: Dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
    """``ConvNet`` for T tasks at once: ``params`` are its parameters by
    name, each with a leading task axis; images (T, N, S, S, 1) → logits
    (T, N, n_way).  Task t's images meet only task t's weights (convolutions
    grouped by task) and task t's batch statistics."""
    t, n, side = images.shape[0], images.shape[1], images.shape[2]
    x = images.permute(1, 0, 4, 2, 3).reshape(n, -1, side, side)  # (N, T·C, S, S)
    for i in range(4):
        w, b = params[f"conv_{i}.weight"], params[f"conv_{i}.bias"]  # (T, C', C, 3, 3)
        x = F.conv2d(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1), padding=1, groups=t)
        x = x.view(n, t, w.shape[1], *x.shape[2:])
        x = transductive_bn(x, params[f"bn_{i}.scale"][:, :, None, None],
                            params[f"bn_{i}.bias"][:, :, None, None], (0, 3, 4))
        x = F.max_pool2d(torch.relu(x).reshape(n, -1, *x.shape[3:]), 2)
    feat = x.view(n, t, -1, *x.shape[2:]).permute(0, 1, 3, 4, 2).reshape(n, t, -1)
    logits = torch.einsum("ntf,tof->nto", feat, params["head.weight"]) + params["head.bias"]
    return logits.transpose(0, 1)


@register_model("multitask.maml")
class ModelDef(AccuracyModelDef):
    metric_names = ("acc",)
    infer_needs_grad = True

    def __init__(self, config: Config):
        super().__init__(config)
        h = config.hyper
        self.n_way = int(h("n_way", 5))
        self.k_spt = int(h("k_spt", 1))
        self.k_query = int(h("k_query", 15))
        self.imgsize = int(h("imgsize", 28))
        self.update_step = int(h("update_step", 5))
        self.inner_lr = float(h("base_optimizer.learning_rate", 0.1))

    def _base_optimizer(self):
        # the JAX package's override: optax.adam at the meta learning rate
        return {"name": "adam", "lr": float(self.config.hyper(
            "meta_optimizer.learning_rate", 0.001)), "mu_dtype": None}

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return ConvNet(self.n_way, self.imgsize, device=device, generator=generator)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t, s = batch_size, self.imgsize
        ns, nq = self.n_way * self.k_spt, self.n_way * self.k_query
        return {"x_spt": rng.randn(t, ns, s, s, 1).astype(np.float32),
                "y_spt": rng.randint(0, self.n_way, (t, ns)).astype(np.int32),
                "x_qry": rng.randn(t, nq, s, s, 1).astype(np.float32),
                "y_qry": rng.randint(0, self.n_way, (t, nq)).astype(np.int32)}

    @staticmethod
    def _losses(params, x, y):
        """Each task's mean cross-entropy (T,) and the logits (T, N, n_way)."""
        logits = conv_net_tasks(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(2, y.long()[..., None])[..., 0].mean(1), logits

    def _meta(self, module, batch, create_graph: bool):
        tasks = batch["x_spt"].shape[0]
        params = {k: p.expand(tasks, *p.shape) for k, p in module.named_parameters()}
        # the inner gradient of the tasks' summed losses is each task's own
        fast = adapted(lambda p: self._losses(p, batch["x_spt"], batch["y_spt"])[0].sum(),
                       params, self.inner_lr, self.update_step, create_graph)
        losses, logits = self._losses(fast, batch["x_qry"], batch["y_qry"])
        correct = (logits.argmax(-1) == batch["y_qry"].long()).to(torch.float32)
        aux: Aux = {"correct": correct.reshape(-1)}
        return losses.mean(), aux

    def train_forward(self, module, batch):
        return self._meta(module, batch, create_graph=True)

    def infer_forward(self, module, batch):
        return {k: v.detach() for k, v in self._meta(module, batch, False)[1].items()}

    def metric_updates(self, aux):
        return {"acc": (aux["correct"], None)}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return OmniglotTaskDataset(data_dir, self, batch_size, episodes=int(
            self.config.runner("episodes_per_epoch", 200)))


class OmniglotTaskDataset:
    """N-way K-shot episodes over a directory of per-character
    subdirectories of grayscale images stored as ``.npy`` arrays (the
    reference loads pngs, omniglot_reader.py:22-52).  Each batch holds
    ``batch_size`` tasks; images scaled to [-1, 1] as (T, N, S, S, 1)."""

    def __init__(self, data_dir, model_def, batch_size, episodes=200):
        self.md = model_def
        self.batch_size = batch_size
        self.episodes = episodes
        chars = []
        for root, _dirs, files in os.walk(data_dir):
            imgs = [f for f in files if f.endswith(".npy")]
            if imgs:
                arrs = [np.load(os.path.join(root, f)) for f in sorted(imgs)]
                chars.append(np.stack(arrs).astype(np.float32))
        self.chars = chars
        self.rng = np.random.RandomState(12345)

    def __iter__(self):
        md, bs = self.md, self.batch_size
        if not self.chars:
            return
        for _ in range(self.episodes):
            xs, ys, xq, yq = [], [], [], []
            for _t in range(bs):
                cls = self.rng.choice(len(self.chars), md.n_way, replace=False)
                sx, sy, qx, qy = [], [], [], []
                for j, c in enumerate(cls):
                    imgs = self.chars[c]
                    pick = self.rng.choice(len(imgs), md.k_spt + md.k_query, replace=False)
                    sx.append(imgs[pick[:md.k_spt]])
                    qx.append(imgs[pick[md.k_spt:]])
                    sy += [j] * md.k_spt
                    qy += [j] * md.k_query
                sx = np.concatenate(sx)[..., None]
                qx = np.concatenate(qx)[..., None]
                sy, qy = np.asarray(sy, np.int32), np.asarray(qy, np.int32)
                p = self.rng.permutation(len(sy))
                q = self.rng.permutation(len(qy))
                xs.append(sx[p])
                ys.append(sy[p])
                xq.append(qx[q])
                yq.append(qy[q])
            yield {"x_spt": np.stack(xs) * 2.0 - 1.0, "y_spt": np.stack(ys),
                   "x_qry": np.stack(xq) * 2.0 - 1.0, "y_qry": np.stack(yq)}
