"""Multitask model bases and their two readers.

Counterpart of ``paddlerec_tpu/models/multitask/base.py``, for the two data
regimes of the family's first six models:
  * Census-income CSV (share_bottom, mmoe, ple): two binary labels and 499
    dense features a row, ``DenseMultitaskModelDef`` and ``CensusDataset``;
  * Ali-CCP slot lines (esmm, aitm, escm2): 23 multi-hot categorical
    fields, click and conversion labels, ``AliCCPModelDef`` and
    ``AliCCPDataset``;
and ``adapted``, the inner loop that maml and metaheac share.
The readers are copies of the JAX package's (numpy only).  The port runs
one process, so each reads every file of its directory: the JAX package's
``shard_files`` at rank 0 of 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, Batch, ModelDef

PROB_EPS = 1e-7  # probabilities are clipped to [eps, 1 - eps] before a log


def bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy of probabilities ``p`` (already
    clipped) against labels ``y``."""
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))


def masked_mean(per: torch.Tensor, mask) -> torch.Tensor:
    """``per`` averaged over the rows ``mask`` keeps (sum over max(mask
    sum, 1)), or over every row without a mask."""
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def clip_prob(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, PROB_EPS, 1 - PROB_EPS)


def adapted(loss_fn, params: Dict[str, torch.Tensor], lr: float, steps: int,
            create_graph: bool) -> Dict[str, torch.Tensor]:
    """The inner loop of maml and metaheac: ``steps`` SGD steps of
    ``loss_fn(params)`` on every parameter, ``p - lr·∇p``; with
    ``create_graph`` the result stays differentiable to second order."""
    for _ in range(steps):
        grads = torch.autograd.grad(loss_fn(params), list(params.values()),
                                    create_graph=create_graph)
        params = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
    return params


class DenseMultitaskModelDef(ModelDef):
    """Census style: dense features → T binary heads.  The module maps
    (B, feature_size) → (B, T) probabilities; the loss is the BCE summed
    over the tasks and averaged over the rows the mask keeps, with one AUC
    per task (``income`` first)."""

    task_names: Tuple[str, ...] = ("income", "marital")

    def __init__(self, config: Config):
        super().__init__(config)
        self.feature_size = int(config.hyper("feature_size", 499))
        self.metric_names = self.task_names

    def model_inputs(self, batch: Batch):
        return (batch["dense"],)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        dense = rng.rand(batch_size, self.feature_size).astype(np.float32)
        labels = (rng.rand(batch_size, len(self.task_names)) < 0.3).astype(np.float32)
        return {"dense": dense, "labels": labels,
                "mask": np.ones(batch_size, np.float32)}

    def train_forward(self, module, batch):
        probs = clip_prob(module(*self.model_inputs(batch)))
        labels = batch["labels"].to(torch.float32)
        mask = batch.get("mask")
        loss = masked_mean(bce(probs, labels).sum(-1), mask)
        aux: Aux = {"probs": probs, "labels": labels}
        if mask is not None:
            aux["mask"] = mask
        return loss, aux

    def metric_updates(self, aux):
        mask = aux.get("mask")
        return {name: (aux["probs"][:, i], aux["labels"][:, i], mask)
                for i, name in enumerate(self.task_names)}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return CensusDataset(list_data_files(data_dir), self.feature_size,
                             len(self.task_names), batch_size)


class CensusDataset:
    """CSV of floats: column 0 the marital label, column 1 the income label,
    the rest dense features (short rows zero-padded to ``feature_size``).
    Labels come out ordered (income, marital), the reference's fetch order
    (census_reader.py:17-27); the tail batch is padded, its pad rows masked."""

    def __init__(self, files, feature_size, num_tasks, batch_size):
        self.files = files
        self.feature_size = feature_size
        self.batch_size = batch_size

    def __iter__(self):
        rows, labels = [], []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    vals = line.strip().split(",")
                    if len(vals) < 3:
                        continue
                    marital, income = float(vals[0]), float(vals[1])
                    feats = [float(v) for v in vals[2:2 + self.feature_size]]
                    feats += [0.0] * (self.feature_size - len(feats))
                    rows.append(feats)
                    labels.append([income, marital])
                    if len(rows) == self.batch_size:
                        yield {"dense": np.asarray(rows, np.float32),
                               "labels": np.asarray(labels, np.float32),
                               "mask": np.ones(self.batch_size, np.float32)}
                        rows, labels = [], []
        if rows:
            n = len(rows)
            pad = self.batch_size - n
            yield {
                "dense": np.concatenate([np.asarray(rows, np.float32),
                                         np.zeros((pad, self.feature_size), np.float32)]),
                "labels": np.concatenate([np.asarray(labels, np.float32),
                                          np.zeros((pad, 2), np.float32)]),
                "mask": np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32),
            }


class AliCCPModelDef(ModelDef):
    """Ali-CCP style: multi-hot sparse fields → (ctr, cvr) probabilities;
    the loss is BCE(ctr, click) + BCE(ctr·cvr, conversion) on the entire
    space, with the AUCs ``ctr`` and ``ctcvr``."""

    metric_names = ("ctr", "ctcvr")

    def __init__(self, config: Config):
        super().__init__(config)
        self.vocab_size = int(config.hyper("sparse_feature_number", 737946))
        self.embedding_dim = int(config.hyper("sparse_feature_dim", 12))
        self.num_field = int(config.hyper("num_field", 23))
        self.max_len = int(config.hyper("max_len", 3))

    def model_inputs(self, batch: Batch):
        return (batch["sparse"], batch.get("sparse_mask"))

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        shape = (batch_size, self.num_field, self.max_len)
        sparse = rng.randint(1, self.vocab_size, size=shape).astype(np.int64)
        sparse_mask = (rng.rand(*shape) < 0.7).astype(np.float32)
        sparse_mask[:, :, 0] = 1.0
        click = (rng.rand(batch_size) < 0.5).astype(np.float32)
        conversion = click * (rng.rand(batch_size) < 0.5)
        return {"sparse": sparse, "sparse_mask": sparse_mask,
                "labels": np.stack([click, conversion], -1).astype(np.float32),
                "mask": np.ones(batch_size, np.float32)}

    @staticmethod
    def _aux(ctr_prob, ctcvr_prob, batch) -> Aux:
        aux: Aux = {"ctr": ctr_prob, "ctcvr": ctcvr_prob,
                    "click": batch["labels"][:, 0], "conversion": batch["labels"][:, 1]}
        if "mask" in batch:
            aux["mask"] = batch["mask"]
        return aux

    def train_forward(self, module, batch):
        ctr_prob, cvr_prob = module(*self.model_inputs(batch))
        ctr_prob = clip_prob(ctr_prob)
        ctcvr_prob = clip_prob(ctr_prob * cvr_prob)
        aux = self._aux(ctr_prob, ctcvr_prob, batch)
        mask = batch.get("mask")
        loss = (masked_mean(bce(ctr_prob, aux["click"]), mask)
                + masked_mean(bce(ctcvr_prob, aux["conversion"]), mask))
        return loss, aux

    def metric_updates(self, aux):
        mask = aux.get("mask")
        return {"ctr": (aux["ctr"], aux["click"], mask),
                "ctcvr": (aux["ctcvr"], aux["conversion"], mask)}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return AliCCPDataset(list_data_files(data_dir), self.num_field, self.max_len,
                             batch_size)


# the 23 field ids of the Ali-CCP release, in the reference's order
# (models/multitask/esmm/esmm_reader.py:14-19)
ALI_CCP_FIELDS = [
    "101", "109_14", "110_14", "127_14", "150_14", "121", "122", "124",
    "125", "126", "127", "128", "129", "205", "206", "207", "210",
    "216", "508", "509", "702", "853", "301",
]


class AliCCPDataset:
    """Ali-CCP lines: ``sample_id,click,conversion,common_feature_index,
    field:feat_id ...`` → (B, F, L) padded multi-hot ids and their (B, F, L)
    mask; ids of a field beyond ``max_len`` are dropped, fields not in
    ``ALI_CCP_FIELDS`` ignored, and the tail batch padded with masked rows."""

    def __init__(self, files, num_field, max_len, batch_size):
        self.files = files
        self.num_field = num_field
        self.max_len = max_len
        self.batch_size = batch_size
        self.field_index = {f: i for i, f in enumerate(ALI_CCP_FIELDS)}

    def __iter__(self):
        bs, nf, ml = self.batch_size, self.num_field, self.max_len
        sparse = np.zeros((bs, nf, ml), np.int64)
        smask = np.zeros((bs, nf, ml), np.float32)
        labels = np.zeros((bs, 2), np.float32)
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 5:
                        continue
                    labels[row, 0] = float(parts[1])
                    labels[row, 1] = float(parts[2])
                    counts = [0] * nf
                    for tok in parts[4:]:
                        fid, _, feat = tok.partition(":")
                        i = self.field_index.get(fid)
                        if i is None or counts[i] >= ml:
                            continue
                        sparse[row, i, counts[i]] = int(feat)
                        smask[row, i, counts[i]] = 1.0
                        counts[i] += 1
                    row += 1
                    if row == bs:
                        yield {"sparse": sparse.copy(), "sparse_mask": smask.copy(),
                               "labels": labels.copy(), "mask": np.ones(bs, np.float32)}
                        sparse[:] = 0
                        smask[:] = 0
                        labels[:] = 0
                        row = 0
        if row:
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            yield {"sparse": sparse.copy(), "sparse_mask": smask.copy(),
                   "labels": labels.copy(), "mask": mask}
