"""DeepRec: a deep autoencoder over a user's item-rating vector.

Counterpart of ``paddlerec_tpu/models/rank/deeprec/model.py``, registered as
``rank.deeprec``: SELU encoder layers ``encoder_i`` down ``layer_sizes``
(default ``[17769, 512, 512, 1024]``) and decoder layers ``decoder_i`` back
up, trained with the MSE over the observed (non-zero) ratings.  It has no
table, so neither K1 nor K1b runs in its step.  Its metric is the RMSE of
the loss, carried in the aux as ``rmse`` beside the reconstruction
``outputs`` (what ``run_predict`` writes); no streaming metric runs
(``metrics = "none"``).

``RatingVectorDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.layers import flax_dense


class DeepRecNet(nn.Module):
    """Parameters ``encoder_i`` and ``decoder_i``, flax ``Dense`` each."""

    def __init__(self, layer_sizes: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_sizes = list(layer_sizes)
        sizes = self.layer_sizes
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"encoder_{i}", flax_dense(a, b, device, generator))
        back = sizes[::-1]
        for i, (a, b) in enumerate(zip(back[:-1], back[1:])):
            self.add_module(f"decoder_{i}", flax_dense(a, b, device, generator))

    def forward(self, ratings: torch.Tensor) -> torch.Tensor:
        x = ratings
        n = len(self.layer_sizes) - 1
        for name in [f"encoder_{i}" for i in range(n)] + [f"decoder_{i}" for i in range(n)]:
            x = F.selu(getattr(self, name)(x))
        return x


@register_model("rank.deeprec")
class ModelDef(BaseModelDef):
    metrics = "none"  # RMSE is reported from the loss, not a streaming AUC
    metric_names = ()

    def __init__(self, config):
        super().__init__(config)
        self.layer_sizes = [
            int(v) for v in config.hyper("layer_sizes", [17769, 512, 512, 1024])
        ]

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DeepRecNet(self.layer_sizes, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["ratings"],)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        n = self.layer_sizes[0]
        ratings = rng.randint(0, 6, (batch_size, n)).astype(np.float32)
        ratings *= rng.rand(batch_size, n) < 0.01  # sparse observations
        return {"ratings": ratings}

    def train_forward(self, module, batch):
        ratings = batch["ratings"]
        out = module(ratings)
        mask = (ratings != 0).to(torch.float32)
        num = torch.clamp(mask.sum(), min=1.0)
        loss = (torch.square(out - ratings) * mask).sum() / num
        return loss, {"outputs": out, "rmse": torch.sqrt(loss)}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return RatingVectorDataset(list_data_files(data_dir), self.layer_sizes[0],
                                   batch_size)


class RatingVectorDataset:
    """Lines of ``item_idx:rating`` pairs per user (Netflix-style sparse
    rows), or the reference's Netflix TSV ``user item rating`` triples,
    aggregated into per-user rows after the pair lines.  The tail is padded
    to the batch with zero rows (which the loss ignores) and a ``mask``."""

    def __init__(self, files, n_items, batch_size):
        self.files = files
        self.n_items = n_items
        self.batch_size = batch_size

    def __iter__(self):
        bs = self.batch_size
        rows = np.zeros((bs, self.n_items), np.float32)
        i = 0
        triples = {}
        for path in self.files:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    if ":" not in toks[0]:
                        if len(toks) >= 3:  # reference TSV triple
                            u, it, r = int(toks[0]), int(toks[1]), float(toks[2])
                            if 0 <= it < self.n_items:
                                triples.setdefault(u, []).append((it, r))
                        continue
                    for t in toks:
                        idx, _, r = t.partition(":")
                        j = int(idx)
                        if 0 <= j < self.n_items:
                            rows[i, j] = float(r)
                    i += 1
                    if i == bs:
                        yield {"ratings": rows.copy(), "mask": np.ones(bs, np.float32)}
                        rows[:] = 0
                        i = 0
        for u in sorted(triples):
            for it, r in triples[u]:
                rows[i, it] = r
            i += 1
            if i == bs:
                yield {"ratings": rows.copy(), "mask": np.ones(bs, np.float32)}
                rows[:] = 0
                i = 0
        if i:
            yield {"ratings": rows.copy(),
                   "mask": (np.arange(bs) < i).astype(np.float32)}
