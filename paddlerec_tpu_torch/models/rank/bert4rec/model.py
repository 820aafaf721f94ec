"""BERT4Rec: a bidirectional transformer for sequential recommendation.

Counterpart of ``paddlerec_tpu/models/rank/bert4rec/model.py``, registered as
``rank.bert4rec``: word, position and sentence embeddings, the pre-encoder
LayerNorm, ``_n_layer`` post-norm ``TransformerBlock``s (gelu, ``_n_head``
heads), the masked positions gathered per example (``torch.gather``, the
counterpart of ``take_along_axis``) → ``mask_lm_trans_fc`` → gelu →
``mask_lm_trans_ln`` → logits tied to the word table (``Embed.attend``)
plus ``mask_lm_out_bias``; a weighted softmax cross-entropy over the
vocabulary on the masked positions.  It is an ``AccuracyModelDef``: the
streaming accuracy of ``argmax`` over the masked positions (ties go to the
first index in both packages).

The word table is drawn as flax's ``truncated_normal(0.02)``.  Each of the
three tables is read once a forward: three K1 launches, three K1b a step;
autograd adds the tied product's dense gradient to the word table's.

``Bert4RecDataset`` is a copy of the JAX package's reader, its cloze
masking from ``np.random.RandomState(2023)`` included, so both packages cut
the same batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import AccuracyModelDef, Aux
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import _ACTIVATIONS, LayerNorm, flax_dense
from paddlerec_tpu_torch.ops.sequence import TransformerBlock

_GELU = _ACTIVATIONS["gelu"]  # flax's nn.gelu: the tanh form


class Bert4RecNet(nn.Module):
    """Parameters ``word_embedding``, ``pos_embedding``, ``sent_embedding``,
    ``pre_encoder_ln``, ``encoder_layer_i``, ``mask_lm_trans_fc``,
    ``mask_lm_trans_ln``, ``mask_lm_out_bias`` (zeros).  src/pos/sent ids
    (B, T), input_mask (B, T), mask_pos (B, M) → logits (B, M, V)."""

    def __init__(self, voc_size: int, emb_size: int = 64, n_layer: int = 2,
                 n_head: int = 2, max_position: int = 50, sent_types: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.n_layer = n_layer
        self.word_embedding = Embed(voc_size, emb_size, stddev=0.02, truncated=True, **kw)
        self.pos_embedding = Embed(max_position, emb_size, **kw)
        self.sent_embedding = Embed(sent_types, emb_size, **kw)
        self.pre_encoder_ln = LayerNorm(emb_size, device=device)
        for i in range(n_layer):
            self.add_module(f"encoder_layer_{i}", TransformerBlock(
                emb_size, n_head, emb_size // n_head, 4 * emb_size, "gelu", **kw))
        self.mask_lm_trans_fc = flax_dense(emb_size, emb_size, **kw)
        self.mask_lm_trans_ln = LayerNorm(emb_size, device=device)
        self.mask_lm_out_bias = nn.Parameter(torch.zeros(voc_size, device=device))

    def forward(self, src_ids, pos_ids, sent_ids, input_mask, mask_pos):
        x = (self.word_embedding(src_ids) + self.pos_embedding(pos_ids)
             + self.sent_embedding(sent_ids))
        x = self.pre_encoder_ln(x)
        for i in range(self.n_layer):
            x = getattr(self, f"encoder_layer_{i}")(x, input_mask)
        index = mask_pos.long()[..., None].expand(-1, -1, x.shape[-1])
        feat = torch.gather(x, 1, index)  # (B, M, D)
        feat = self.mask_lm_trans_ln(_GELU(self.mask_lm_trans_fc(feat)))
        return self.word_embedding.attend(feat) + self.mask_lm_out_bias


@register_model("rank.bert4rec")
class ModelDef(AccuracyModelDef):
    metric_names = ("acc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.voc_size = int(h("_voc_size", 54546))
        self.max_position = int(h("_max_position_seq_len", 50))
        self.max_mask = int(h("max_mask_per_seq", 10))
        self.emb_size = int(h("_emb_size", 64))
        self.n_layer = int(h("_n_layer", 2))
        self.n_head = int(h("_n_head", 2))
        self.sent_types = int(h("_sent_types", 2))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return Bert4RecNet(self.voc_size, self.emb_size, self.n_layer, self.n_head,
                           self.max_position, self.sent_types, device=device,
                           generator=generator)

    def model_inputs(self, batch):
        return (batch["src_ids"], batch["pos_ids"], batch["sent_ids"],
                batch["input_mask"], batch["mask_pos"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t, m = self.max_position, self.max_mask
        return {
            "src_ids": rng.randint(0, self.voc_size, (batch_size, t)).astype(np.int32),
            "pos_ids": np.tile(np.arange(t, dtype=np.int32), (batch_size, 1)),
            "sent_ids": np.zeros((batch_size, t), np.int32),
            "input_mask": np.ones((batch_size, t), np.float32),
            "mask_pos": rng.randint(0, t, (batch_size, m)).astype(np.int32),
            "mask_label": rng.randint(0, self.voc_size, (batch_size, m)).astype(np.int32),
            "mask_weight": np.ones((batch_size, m), np.float32),
        }

    @staticmethod
    def _aux(logits: torch.Tensor, batch) -> Aux:
        correct = (logits.argmax(dim=-1) == batch["mask_label"]).to(torch.float32)
        return {"correct": correct.reshape(-1),
                "mask_weight": batch["mask_weight"].to(torch.float32).reshape(-1)}

    def train_forward(self, module, batch):
        logits = module(*self.model_inputs(batch))  # (B, M, V)
        w = batch["mask_weight"].to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["mask_label"].long()[..., None])[..., 0]
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        return loss, self._aux(logits, batch)

    def infer_forward(self, module, batch):
        # the loss is left out, as XLA drops it from the JAX package's
        return self._aux(module(*self.model_inputs(batch)), batch)

    def metric_updates(self, aux):
        return {"acc": (aux["correct"], aux["mask_weight"])}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return Bert4RecDataset(list_data_files(data_dir), batch_size, self.max_position,
                               self.max_mask, self.voc_size)


class Bert4RecDataset:
    """Item-sequence lines ``uid item1 item2 ...`` (the last ``max_len``
    items kept; sequences under two items skipped); cloze masking: ``k =
    max(1, min(max_mask, int(L·mask_prob)))`` positions drawn without
    replacement from ``RandomState(seed)`` become ``[MASK] = voc_size - 1``.
    The tail is padded to the batch with rows of zero ``mask_weight``."""

    def __init__(self, files, batch_size, max_len, max_mask, voc_size,
                 mask_prob=0.15, seed=2023):
        self.files = files
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_mask = max_mask
        self.voc_size = voc_size
        self.mask_prob = mask_prob
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        bs, t, m = self.batch_size, self.max_len, self.max_mask
        mask_id = self.voc_size - 1
        buf = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    items = [int(x) for x in line.split()[1:]][-t:]
                    if len(items) < 2:
                        continue
                    buf.append(items)
                    if len(buf) == bs:
                        yield self._batch(buf, t, m, mask_id)
                        buf = []
        if buf:
            yield self._batch(buf, t, m, mask_id, pad_to=self.batch_size)

    def _batch(self, seqs, t, m, mask_id, pad_to=None):
        n = pad_to or len(seqs)
        src = np.zeros((n, t), np.int32)
        imask = np.zeros((n, t), np.float32)
        mpos = np.zeros((n, m), np.int32)
        mlab = np.zeros((n, m), np.int32)
        mw = np.zeros((n, m), np.float32)
        for i, items in enumerate(seqs):
            length = len(items)
            src[i, :length] = items
            imask[i, :length] = 1.0
            k = max(1, min(m, int(length * self.mask_prob)))
            pos = self.rng.choice(length, k, replace=False)
            mlab[i, :k] = src[i, pos]
            src[i, pos] = mask_id
            mpos[i, :k] = pos
            mw[i, :k] = 1.0
        return {
            "src_ids": src,
            "pos_ids": np.tile(np.arange(t, dtype=np.int32), (n, 1)),
            "sent_ids": np.zeros((n, t), np.int32),
            "input_mask": imask,
            "mask_pos": mpos,
            "mask_label": mlab,
            "mask_weight": mw,
        }
