"""DSSM: the two-tower semantic match over trigram vectors.

Counterpart of ``paddlerec_tpu/models/match/dssm/model.py``, registered as
``match.dssm``: a query tower and a doc tower (``MLP`` with a ReLU output,
``fc_sizes`` [300, 300, 128] over ``trigram_d`` 2,900 inputs), the cosine of
the query against the positive and each of ``neg_num`` negatives, and
``-log p(pos)`` under a softmax over them, averaged over the rows the
batch's ``mask`` keeps.  The model has no table: its step runs no K1 and no
K1b.

The metric is logged as ``pnr`` and is the AUC state of the similarities
mapped to [0, 1], positives labelled 1 and negatives 0: that AUC is the
positive-order ratio (``tools/cal_pos_neg.py`` counts the same pairs
offline).

``cosine`` takes its norms as ``sqrt(sum(x·x))``, as ``jnp.linalg.norm``
does, so that a zero vector's gradient is what JAX gives it.
``DSSMDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import (
    Aux, ModelDef as BaseModelDef, masked_mean, pair_metric,
)
from paddlerec_tpu_torch.ops.layers import MLP


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = (a * b).sum(-1)
    den = torch.sqrt((a * a).sum(-1)) * torch.sqrt((b * b).sum(-1))
    return num / torch.clamp(den, min=eps)


class DSSMNet(nn.Module):
    """Parameters ``query_tower`` and ``doc_tower``; returns (sim_pos (B,),
    sim_neg (B, N))."""

    def __init__(self, trigram_d: int, fc_sizes: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"output_activation": "relu", "device": device, "generator": generator}
        self.query_tower = MLP(trigram_d, list(fc_sizes), **kw)
        self.doc_tower = MLP(trigram_d, list(fc_sizes), **kw)

    def forward(self, query, doc_pos, doc_negs):
        q = self.query_tower(query)
        sim_pos = cosine(q, self.doc_tower(doc_pos))
        sim_neg = cosine(q[:, None, :], self.doc_tower(doc_negs))
        return sim_pos, sim_neg


@register_model("match.dssm")
class ModelDef(BaseModelDef):
    metric_names = ("pnr",)  # the positive-order ratio, through the AUC

    def __init__(self, config):
        super().__init__(config)
        self.trigram_d = int(config.hyper("trigram_d", 2900))
        self.neg_num = int(config.hyper("neg_num", 1))
        self.fc_sizes = list(config.hyper("fc_sizes", [300, 300, 128]))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return DSSMNet(self.trigram_d, self.fc_sizes, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["query"], batch["doc_pos"], batch["doc_negs"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        d = self.trigram_d

        def trig(*shape):
            return (rng.rand(*shape) < 0.01).astype(np.float32)

        return {
            "query": trig(batch_size, d),
            "doc_pos": trig(batch_size, d),
            "doc_negs": trig(batch_size, self.neg_num, d),
            "mask": np.ones(batch_size, np.float32),
        }

    def train_forward(self, module, batch):
        sim_pos, sim_neg = module(*self.model_inputs(batch))
        logits = torch.cat([sim_pos[:, None], sim_neg], dim=1)
        per = -torch.log_softmax(logits, dim=1)[:, 0]
        mask = batch.get("mask")
        aux: Aux = {"sim_pos": sim_pos, "sim_neg": sim_neg}
        if mask is not None:
            aux["mask"] = mask
        return masked_mean(per, mask), aux

    def metric_updates(self, aux):
        return {"pnr": pair_metric((aux["sim_pos"] + 1.0) / 2.0,
                                   (aux["sim_neg"] + 1.0) / 2.0, aux.get("mask"))}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return DSSMDataset(list_data_files(data_dir), self.trigram_d, self.neg_num,
                           batch_size)


class DSSMDataset:
    """Tab-separated ``query<TAB>pos<TAB>neg...`` lines, each column a
    comma-separated trigram vector of ``trigram_d`` values (the BQ format of
    the reference); a short vector is zero-padded, a line with fewer than
    2 + ``neg_num`` columns skipped; the tail batch is padded with zero rows
    and ``mask`` 0."""

    def __init__(self, files, trigram_d, neg_num, batch_size):
        self.files = files
        self.trigram_d = trigram_d
        self.neg_num = neg_num
        self.batch_size = batch_size

    def __iter__(self):
        bs, d, n = self.batch_size, self.trigram_d, self.neg_num
        q = np.zeros((bs, d), np.float32)
        pos = np.zeros((bs, d), np.float32)
        negs = np.zeros((bs, n, d), np.float32)
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 2 + n:
                        continue

                    def put(dst, col):
                        arr = np.array(col.split(","), dtype=np.float32)[:d]
                        dst[: len(arr)] = arr
                        dst[len(arr):] = 0.0

                    put(q[row], cols[0])
                    put(pos[row], cols[1])
                    for j in range(n):
                        put(negs[row, j], cols[2 + j])
                    row += 1
                    if row == bs:
                        yield {
                            "query": q.copy(),
                            "doc_pos": pos.copy(),
                            "doc_negs": negs.copy(),
                            "mask": np.ones(bs, np.float32),
                        }
                        q[:] = 0
                        pos[:] = 0
                        negs[:] = 0
                        row = 0
        if row:
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            yield {
                "query": q.copy(),
                "doc_pos": pos.copy(),
                "doc_negs": negs.copy(),
                "mask": mask,
            }
