"""TextCNN: the sentence classifier.

Counterpart of ``paddlerec_tpu/models/contentunderstanding/textcnn/model.py``,
registered as ``contentunderstanding.textcnn``: token embeddings
(``dict_dim`` 33,257 × 128, one K1 launch a forward) masked by ``seq_mask``,
``SAME`` convs of widths 1, 2 and 3 to ``cnn_dim`` channels (``conv_1``,
``conv_2``, ``conv_3``) with tanh, a max over time where the mask is set
(-1e9 elsewhere: a row with no token gets -1e9 features, not NaN), a tanh
``hidden`` layer and ``head`` over ``class_dim`` classes, trained with the
softmax cross-entropy; with two classes the AUC of the second class's
probability is logged as ``auc``.

flax pads the width-2 conv with 0 before and 1 after (``SameConv1d``).
``TextCNNDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef, masked_mean
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import SameConv1d, flax_dense, masked_max


class TextCNNNet(nn.Module):
    """Parameters ``embedding``, ``conv_<fs>`` per filter size, ``hidden``,
    ``head``; tokens (B, T), seq_mask (B, T) → logits (B, class_dim)."""

    def __init__(self, dict_dim: int, emb_dim: int, cnn_dim: int,
                 filter_sizes: Sequence[int], hid_dim: int, class_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.embedding = Embed(dict_dim, emb_dim, **kw)
        self.filter_sizes = tuple(filter_sizes)
        for fs in self.filter_sizes:
            self.add_module(f"conv_{fs}", SameConv1d(emb_dim, cnn_dim, fs, **kw))
        self.hidden = flax_dense(cnn_dim * len(self.filter_sizes), hid_dim, **kw)
        self.head = flax_dense(hid_dim, class_dim, **kw)

    def forward(self, tokens, seq_mask):
        emb = self.embedding(tokens) * seq_mask[..., None]
        feat = torch.cat([masked_max(torch.tanh(getattr(self, f"conv_{fs}")(emb)), seq_mask)
                          for fs in self.filter_sizes], dim=-1)
        return self.head(torch.tanh(self.hidden(feat)))


@register_model("contentunderstanding.textcnn")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.dict_dim = int(h("dict_dim", 33257))
        self.max_len = int(h("max_len", 100))
        self.class_dim = int(h("class_dim", 2))
        self.filter_sizes = tuple(int(h(f"cnn_filter_size{i}", d))
                                  for i, d in ((1, 1), (2, 2), (3, 3)))
        self.emb_dim = int(h("emb_dim", 128))
        self.cnn_dim = int(h("cnn_dim", 128))
        self.hid_dim = int(h("hid_dim", 96))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return TextCNNNet(self.dict_dim, self.emb_dim, self.cnn_dim, self.filter_sizes,
                          self.hid_dim, self.class_dim, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["tokens"], batch["seq_mask"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.max_len
        lens = rng.randint(1, t + 1, batch_size)
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        return {
            "tokens": (rng.randint(0, self.dict_dim, (batch_size, t)) * seq_mask).astype(np.int32),
            "seq_mask": seq_mask,
            "label": rng.randint(0, self.class_dim, batch_size).astype(np.int32),
            "mask": np.ones(batch_size, np.float32),
        }

    def _aux(self, logits, batch) -> Aux:
        aux: Aux = {"labels": batch["label"].to(torch.float32)}
        if self.class_dim == 2:
            aux["predictions"] = torch.softmax(logits, dim=-1)[:, 1]
        if "mask" in batch:
            aux["mask"] = batch["mask"]
        return aux

    def train_forward(self, module, batch):
        logits = module(*self.model_inputs(batch))
        labels = batch["label"].long()
        per = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        return masked_mean(per, batch.get("mask")), self._aux(logits, batch)

    def infer_forward(self, module, batch):
        # the loss is left out, as XLA drops it from the JAX package's
        return self._aux(module(*self.model_inputs(batch)), batch)

    def metric_updates(self, aux):
        if "predictions" not in aux:
            return {}
        return super().metric_updates(aux)

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return TextCNNDataset(list_data_files(data_dir), self.max_len, batch_size)


class TextCNNDataset:
    """Lines ``tok tok ... tok seq_len label`` (the senta format); tokens
    cut to ``max_len``, the mask set over the first ``min(seq_len,
    max_len)``; lines of fewer than three fields skipped; the tail batch is
    padded with ``mask`` 0 (its labels keep the last full batch's)."""

    def __init__(self, files, max_len, batch_size):
        self.files = files
        self.max_len = max_len
        self.batch_size = batch_size

    def __iter__(self):
        bs, t = self.batch_size, self.max_len
        tokens = np.zeros((bs, t), np.int32)
        seq_mask = np.zeros((bs, t), np.float32)
        labels = np.zeros((bs,), np.int32)
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 3:
                        continue
                    label = int(parts[-1])
                    seq_len = min(int(parts[-2]), t)
                    toks = [int(x) for x in parts[:-2]][:t]
                    tokens[row, : len(toks)] = toks
                    seq_mask[row, :seq_len] = 1.0
                    labels[row] = label
                    row += 1
                    if row == bs:
                        yield {
                            "tokens": tokens.copy(),
                            "seq_mask": seq_mask.copy(),
                            "label": labels.copy(),
                            "mask": np.ones(bs, np.float32),
                        }
                        tokens[:] = 0
                        seq_mask[:] = 0
                        row = 0
        if row:
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            yield {
                "tokens": tokens.copy(),
                "seq_mask": seq_mask.copy(),
                "label": labels.copy(),
                "mask": mask,
            }
