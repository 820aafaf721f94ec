"""Match-Pyramid: text matching by a CNN over the interaction matrix.

Counterpart of ``paddlerec_tpu/models/match/match_pyramid/model.py``,
registered as ``match.match_pyramid``: the left (20) and right (500) token
ids are looked up in one table (``vocab_size`` 193,368 × 50) in ONE K1
launch (``Embed(left, right)``); their dot products form a (B, L, R, 1)
image; a ``SAME`` conv of kernel (2, 10) to ``kernel_num`` channels with a
ReLU, a max-pool of window and stride (L // 6, R // 50), then ``hidden``
(ReLU) and ``head`` give one logit, trained with the sigmoid log-loss on
``label``.

flax pads the even kernel (2, 10) with (0, 1) rows and (4, 5) columns
(``SameConv2d``), and flattens the pooled (B, 6, 50, C) map in H, W, C
order before ``hidden``: the port keeps that NHWC layout around its conv.
``MatchPyramidDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import LogitModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import SameConv2d, flax_dense

CONV_SIZE = (2, 10)
POOL_SIZE = (6, 50)


class MatchPyramidNet(nn.Module):
    """Parameters ``embedding``, ``conv``, ``hidden``, ``head``; left (B, L),
    right (B, R) → logits (B,)."""

    def __init__(self, vocab_size: int, emb_size: int, kernel_num: int, left_size: int,
                 right_size: int, hidden_size: int, out_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.embedding = Embed(vocab_size, emb_size, **kw)
        self.conv = SameConv2d(1, kernel_num, CONV_SIZE, **kw)
        self.window = (max(left_size // POOL_SIZE[0], 1), max(right_size // POOL_SIZE[1], 1))
        pooled = (left_size // self.window[0]) * (right_size // self.window[1]) * kernel_num
        self.hidden = flax_dense(pooled, hidden_size, **kw)
        self.head = flax_dense(hidden_size, out_size, **kw)

    def forward(self, left, right):
        le, re_ = self.embedding(left, right)
        image = torch.einsum("ble,bre->blr", le, re_)[..., None]  # (B, L, R, 1)
        x = torch.relu(self.conv(image))  # (B, L, R, C)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), self.window, self.window)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # H, W, C order
        return self.head(torch.relu(self.hidden(x)))[:, 0]


@register_model("match.match_pyramid")
class ModelDef(LogitModelDef):
    metric_names = ("pnr",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.vocab_size = int(h("vocab_size", 193368))
        self.left_size = int(h("sentence_left_size", 20))
        self.right_size = int(h("sentence_right_size", 500))
        self.emb_size = int(h("emb_size", 50))
        self.kernel_num = int(h("kernel_num", 8))
        self.hidden_size = int(h("hidden_size", 20))
        self.out_size = int(h("out_size", 1))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return MatchPyramidNet(self.vocab_size, self.emb_size, self.kernel_num,
                               self.left_size, self.right_size, self.hidden_size,
                               self.out_size, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["left"], batch["right"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "left": rng.randint(0, self.vocab_size, (batch_size, self.left_size)).astype(np.int32),
            "right": rng.randint(0, self.vocab_size,
                                 (batch_size, self.right_size)).astype(np.int32),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return MatchPyramidDataset(list_data_files(data_dir), self.left_size,
                                   self.right_size, batch_size)


class MatchPyramidDataset:
    """Tab-separated comma-joined id lists ``left<TAB>right[<TAB>label]``
    (label 1.0 when absent), each cut to its size; the tail batch is padded
    with zero rows and ``mask`` 0."""

    def __init__(self, files, left_size, right_size, batch_size):
        self.files = files
        self.left_size = left_size
        self.right_size = right_size
        self.batch_size = batch_size

    def __iter__(self):
        bs = self.batch_size
        left = np.zeros((bs, self.left_size), np.int32)
        right = np.zeros((bs, self.right_size), np.int32)
        label = np.zeros((bs,), np.float32)
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 2:
                        continue
                    lt = [int(x) for x in cols[0].split(",")][: self.left_size]
                    rt = [int(x) for x in cols[1].split(",")][: self.right_size]
                    left[row, : len(lt)] = lt
                    right[row, : len(rt)] = rt
                    label[row] = float(cols[2]) if len(cols) > 2 else 1.0
                    row += 1
                    if row == bs:
                        yield {
                            "left": left.copy(),
                            "right": right.copy(),
                            "label": label.copy(),
                            "mask": np.ones(bs, np.float32),
                        }
                        left[:] = 0
                        label[:] = 0
                        right[:] = 0
                        row = 0
        if row:
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            yield {
                "left": left.copy(),
                "right": right.copy(),
                "label": label.copy(),
                "mask": mask,
            }
