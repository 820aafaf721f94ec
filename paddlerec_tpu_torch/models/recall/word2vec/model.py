"""word2vec: skip-gram with negative sampling.

Counterpart of ``paddlerec_tpu/models/recall/word2vec/model.py``, registered
as ``recall.word2vec``: an input table ``in_emb`` drawn uniform on [0, 2b)
and read shifted by -b (b = 0.5 / ``sparse_feature_dim``), an output table
``out_emb`` and an output bias ``out_bias`` (``sparse_feature_number`` × 1),
both zero at the start; the logit of a (center, context) pair is
``c·o + bias``, trained with ``-log σ(pos) - Σ log σ(-neg)`` over the
positive and ``neg_num`` negatives.  The AUC of the sigmoid logits,
positives against negatives, is logged as ``auc``.

One K1 launch per table a forward (the positive and the negatives of the
output tables looked up together: ``Embed(pos, negs)``), three in all, and
three K1b a step.  ``embedding_table`` hands the input table to
``tools/analogy_eval.py``.

``SkipGramDataset`` is a copy of the JAX package's reader (numpy only): the
window of each center from ``RandomState(seed)``, the negatives from the
unigram^0.75 ``AliasSampler`` (``data/alias.py``, seeded with
``runner.seed``), or uniform with ``hyper_parameters.neg_sampling:
uniform``; the same draws as the JAX reader's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.config import resolve_path
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.alias import (
    AliasSampler, counts_from_corpus, counts_from_dict_file,
)
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import (
    Aux, ModelDef as BaseModelDef, masked_mean, pair_metric,
)
from paddlerec_tpu_torch.ops.embedding import Embed


class SkipGramNet(nn.Module):
    """center, pos (B,), negs (B, N) → (pos_logit (B,), neg_logit (B, N))."""

    def __init__(self, vocab_size: int, embedding_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bound = 0.5 / embedding_dim
        kw = {"device": device, "generator": generator}
        self.in_emb = Embed(vocab_size, embedding_dim, uniform=2 * self.bound, **kw)
        self.out_emb = Embed(vocab_size, embedding_dim, zeros=True, **kw)
        self.out_bias = Embed(vocab_size, 1, zeros=True, **kw)

    def forward(self, center, pos, negs):
        c = self.in_emb(center) - self.bound  # uniform(0, 2b) - b
        p, n = self.out_emb(pos, negs)
        pb, nb = self.out_bias(pos, negs)
        pos_logit = (c * p).sum(-1) + pb[..., 0]
        neg_logit = torch.einsum("be,bne->bn", c, n) + nb[..., 0]
        return pos_logit, neg_logit


@register_model("recall.word2vec")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        self.vocab_size = int(config.hyper("sparse_feature_number", 1000))
        self.embedding_dim = int(config.hyper("sparse_feature_dim", 300))
        self.neg_num = int(config.hyper("neg_num", 5))
        self.window_size = int(config.hyper("window_size", 5))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return SkipGramNet(self.vocab_size, self.embedding_dim, device=device,
                           generator=generator)

    def model_inputs(self, batch):
        return (batch["center"], batch["pos"], batch["negs"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "center": rng.randint(0, self.vocab_size, batch_size).astype(np.int32),
            "pos": rng.randint(0, self.vocab_size, batch_size).astype(np.int32),
            "negs": rng.randint(0, self.vocab_size,
                                (batch_size, self.neg_num)).astype(np.int32),
            "mask": np.ones(batch_size, np.float32),
        }

    def train_forward(self, module, batch):
        pos_logit, neg_logit = module(*self.model_inputs(batch))
        zero = pos_logit.new_zeros(())
        per = (torch.logaddexp(zero, -pos_logit)  # -log σ(pos)
               + torch.logaddexp(zero, neg_logit).sum(-1))  # -Σ log σ(-neg)
        mask = batch.get("mask")
        aux: Aux = {"pos_logit": pos_logit, "neg_logit": neg_logit}
        if mask is not None:
            aux["mask"] = mask
        return masked_mean(per, mask), aux

    def metric_updates(self, aux):
        return {"auc": pair_metric(torch.sigmoid(aux["pos_logit"]),
                                   torch.sigmoid(aux["neg_logit"]), aux.get("mask"))}

    def _neg_sampler(self, files):
        """The unigram^0.75 sampler (``neg_sampling_power``) over the counts
        of ``runner.word_count_dict_path``, or of one counting pass over the
        corpus; None (uniform draws) with ``neg_sampling: uniform`` or no
        count above 0."""
        mode = str(self.config.hyper("neg_sampling", "frequency")).lower()
        if mode == "uniform":
            return None
        if self.config.runner("word_count_dict_path"):
            counts = counts_from_dict_file(
                resolve_path(self.config, "runner.word_count_dict_path"), self.vocab_size)
        else:
            counts = counts_from_corpus(files, self.vocab_size)
        if counts.sum() <= 0:
            return None
        power = float(self.config.hyper("neg_sampling_power", 0.75))
        return AliasSampler(counts, power=power, seed=int(self.config.runner("seed", 2023)))

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        files = list_data_files(data_dir)
        return SkipGramDataset(files, self.vocab_size, self.window_size, self.neg_num,
                               batch_size, neg_sampler=self._neg_sampler(files))

    @staticmethod
    def embedding_table(state) -> torch.Tensor:
        """The input table of a state_dict, for analogy evaluation."""
        return state["in_emb.embedding"]


class SkipGramDataset:
    """Space-separated token-id lines → (center, context, negatives): for
    each center a window ``randint(1, window + 1)`` wide on either side;
    negatives from ``neg_sampler`` or uniform; the tail batch padded with
    id 0 and ``mask`` 0."""

    def __init__(self, files, vocab, window, neg_num, batch_size, seed=0,
                 neg_sampler=None):
        self.files = files
        self.vocab = vocab
        self.window = window
        self.neg_num = neg_num
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.neg_sampler = neg_sampler

    def __iter__(self):
        centers, positives = [], []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    ids = [int(t) for t in line.split()]
                    for i, c in enumerate(ids):
                        w = self.rng.randint(1, self.window + 1)
                        for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                            if j == i:
                                continue
                            centers.append(c)
                            positives.append(ids[j])
                            if len(centers) == self.batch_size:
                                yield self._emit(centers, positives)
                                centers, positives = [], []
        if centers:
            pad = self.batch_size - len(centers)
            mask = np.concatenate([np.ones(len(centers)), np.zeros(pad)]).astype(np.float32)
            centers += [0] * pad
            positives += [0] * pad
            yield {**self._emit(centers, positives), "mask": mask}

    def _emit(self, centers, positives):
        b = len(centers)
        if self.neg_sampler is not None:
            negs = self.neg_sampler.sample((b, self.neg_num))
        else:
            negs = self.rng.randint(0, self.vocab, (b, self.neg_num))
        return {
            "center": np.asarray(centers, np.int32),
            "pos": np.asarray(positives, np.int32),
            "negs": negs.astype(np.int32),
            "mask": np.ones(b, np.float32),
        }
