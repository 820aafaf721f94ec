"""MetaHEAC: a meta-learned hybrid expert and critic model for cold-start ads.

Counterpart of ``paddlerec_tpu/models/multitask/metaheac/model.py``,
registered as ``multitask.metaheac``.  ``HybridExpertNet``: 20 ``Embed``
tables (7 static fields, 7 dynamic multi-hot fields mean-pooled over their
lengths, 6 ad fields; ``max_idxs + 1`` rows of ``embed_dim`` each), expert
MLPs ``expert_<i>_fc<j>`` mixed by an ad-conditioned softmax attention
(``att_hidden`` → ``att_out``), ``num_output`` sigmoid heads mixed the same
way (``att2_hidden`` → ``att2_out``), the output clipped to [1e-7, 1−1e-7].

A step runs, for each of the batch's ``task_count`` tasks, one inner SGD
step at ``local_lr`` on the support half over every parameter, the tables
included, then the query loss under those fast weights; the step's loss is
the mean over tasks, its gradient the second-order meta-gradient.  On the
card each table's lookup is K1 (fill mode, as ``jnp.take``) and its inner
gradient K1b, so the outer gradient runs through the backward of K1b (K1
again, see ``ops/gather_pool.py``).  The outer optimizer is Adam at
``optimizer.global_learning_rate``, as in the JAX package.  Evaluation and
serving adapt too (``infer_needs_grad``), with a first-order inner step.

``_LookalikeDataset`` is a copy of the JAX package's reader: pickled rows
(a numpy array, or a DataFrame), each task's support and query half taken
from ``2·batch`` consecutive rows (task-major).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef
from paddlerec_tpu_torch.models.multitask.base import adapted
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense

# the Tencent Lookalike dataset's dynamic fields: (start, end) of each
# field's padded ids among the 50 dynamic columns (reader_train.py:30-57)
DYNAMIC_SPANS: Tuple[Tuple[int, int], ...] = (
    (0, 10), (10, 20), (20, 30), (30, 35), (35, 40), (40, 45), (45, 50),
)
_FIELDS = ("static", "dynamic_ids", "dynamic_lengths", "ad", "label")


class HybridExpertNet(nn.Module):
    def __init__(self, static_vocabs: Sequence[int], dynamic_vocabs: Sequence[int],
                 ad_vocabs: Sequence[int], embed_dim: int, mlp_dims: Sequence[int],
                 num_expert: int, num_output: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.counts = (len(static_vocabs), len(dynamic_vocabs), len(ad_vocabs))
        self.num_expert, self.num_output, self.depth = num_expert, num_output, len(mlp_dims)
        for group, vocabs in (("static", static_vocabs), ("dynamic", dynamic_vocabs),
                              ("ad", ad_vocabs)):
            for i, v in enumerate(vocabs):
                self.add_module(f"{group}_{i}", Embed(int(v) + 1, embed_dim, **kw))
        fields = len(static_vocabs) + len(dynamic_vocabs)
        hidden = mlp_dims[-1]
        for i in range(num_expert):
            fan_in = fields * embed_dim
            for j, d in enumerate(mlp_dims):
                self.add_module(f"expert_{i}_fc{j}", flax_dense(fan_in, d, **kw))
                fan_in = d
        ad_dim = (len(ad_vocabs) + 1) * embed_dim
        self.att_hidden = flax_dense(ad_dim, hidden, **kw)
        self.att_out = flax_dense(hidden, num_expert, **kw)
        for i in range(num_output):
            self.add_module(f"head_{i}", flax_dense(hidden, 1, **kw))
        self.att2_hidden = flax_dense(ad_dim, hidden, **kw)
        self.att2_out = flax_dense(hidden, num_output, **kw)

    def forward(self, static_ids, dynamic_ids, dynamic_lengths, ad_ids):
        n_static, n_dynamic, n_ad = self.counts
        b = static_ids.shape[0]
        static_emb = torch.stack([getattr(self, f"static_{i}")(static_ids[:, i])
                                  for i in range(n_static)], dim=1)  # (B, 7, E)
        dyn = []
        for i, (lo, hi) in enumerate(DYNAMIC_SPANS[:n_dynamic]):
            emb = getattr(self, f"dynamic_{i}")(dynamic_ids[:, lo:hi])  # (B, L, E)
            lens = dynamic_lengths[:, i].to(torch.float32)
            m = (torch.arange(hi - lo, device=lens.device)[None, :] < lens[:, None]).to(
                torch.float32)
            dyn.append((emb * m[..., None]).sum(1) / torch.clamp(lens[:, None], min=1.0))
        emb = torch.cat([static_emb, torch.stack(dyn, dim=1)], dim=1)  # (B, 14, E)
        ad_emb = torch.stack([getattr(self, f"ad_{i}")(ad_ids[:, i]) for i in range(n_ad)],
                             dim=1)  # (B, A, E)
        ad_feat = torch.cat([emb.mean(dim=1, keepdim=True), ad_emb], dim=1).reshape(b, -1)
        flat = emb.reshape(b, -1)
        expert_outs = []
        for i in range(self.num_expert):
            h = flat
            for j in range(self.depth):
                h = torch.relu(getattr(self, f"expert_{i}_fc{j}")(h))
            expert_outs.append(h)
        experts = torch.stack(expert_outs, dim=1)  # (B, N, H)
        att = torch.softmax(self.att_out(torch.relu(self.att_hidden(ad_feat))), dim=1)
        fea = torch.einsum("bnh,bn->bh", experts, att)
        heads = torch.cat([torch.sigmoid(getattr(self, f"head_{i}")(fea))
                           for i in range(self.num_output)], dim=1)  # (B, O)
        att2 = torch.softmax(self.att2_out(torch.relu(self.att2_hidden(ad_feat))), dim=1)
        return torch.clamp((heads * att2).sum(dim=1), 1e-7, 1 - 1e-7)


@register_model("multitask.metaheac")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)
    infer_needs_grad = True

    def __init__(self, config: Config):
        super().__init__(config)
        h = config.hyper
        max_idxs = h("max_idxs", [[3, 2, 855, 5, 7, 2, 1],
                                  [124, 82, 12, 263312, 49780, 10002, 9984],
                                  [78, 137, 14, 39, 32, 3]])
        self.static_vocabs = [int(v) for v in max_idxs[0]]
        self.dynamic_vocabs = [int(v) for v in max_idxs[1]]
        self.ad_vocabs = [int(v) for v in max_idxs[2]]
        self.task_count = int(h("task_count", 5))
        self.local_lr = float(h("local_lr", 0.0002))
        self.embed_dim = int(h("embed_dim", 64))
        self.mlp_dims = [int(d) for d in h("mlp_dims", [64, 64])]
        self.num_expert = int(h("num_expert", 8))
        self.num_output = int(h("num_output", 5))

    def _base_optimizer(self):
        # the JAX package's override: optax.adam at the global learning rate
        return {"name": "adam", "lr": float(self.config.hyper(
            "optimizer.global_learning_rate", 0.001)), "mu_dtype": None}

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return HybridExpertNet(self.static_vocabs, self.dynamic_vocabs, self.ad_vocabs,
                               self.embed_dim, self.mlp_dims, self.num_expert,
                               self.num_output, device=device, generator=generator)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.task_count

        def feats():
            return {
                "static": np.stack([rng.randint(0, v + 1, (t, batch_size))
                                    for v in self.static_vocabs], axis=-1).astype(np.int32),
                "dynamic_ids": rng.randint(0, min(self.dynamic_vocabs),
                                           (t, batch_size, 50)).astype(np.int32),
                "dynamic_lengths": np.stack([rng.randint(1, (hi - lo) + 1, (t, batch_size))
                                             for lo, hi in DYNAMIC_SPANS],
                                            axis=-1).astype(np.int32),
                "ad": np.stack([rng.randint(0, v + 1, (t, batch_size))
                                for v in self.ad_vocabs], axis=-1).astype(np.int32),
                "label": (rng.rand(t, batch_size) < 0.3).astype(np.float32),
            }

        spt, qry = feats(), feats()
        return {**{f"spt_{k}": v for k, v in spt.items()},
                **{f"qry_{k}": v for k, v in qry.items()}}

    @staticmethod
    def _task_loss(module, params, static, dyn, lens, ad, label):
        pred = functional_call(module, params, (static, dyn, lens, ad))
        loss = -(label * torch.log(pred) + (1 - label) * torch.log(1 - pred)).mean()
        return loss, pred

    def _meta(self, module, batch, create_graph: bool):
        params = dict(module.named_parameters())
        spt = [batch[f"spt_{k}"] for k in _FIELDS]
        qry = [batch[f"qry_{k}"] for k in _FIELDS]
        losses, preds = [], []
        for t in range(self.task_count):
            fast = adapted(lambda p: self._task_loss(module, p, *(x[t] for x in spt))[0],
                           params, self.local_lr, 1, create_graph)
            loss_q, pred_q = self._task_loss(module, fast, *(x[t] for x in qry))
            losses.append(loss_q)
            preds.append(pred_q)
        aux: Aux = {"predictions": torch.cat(preds), "labels": batch["qry_label"].reshape(-1)}
        return torch.stack(losses).mean(), aux

    def train_forward(self, module, batch):
        return self._meta(module, batch, create_graph=True)

    def infer_forward(self, module, batch):
        return {k: v.detach() for k, v in self._meta(module, batch, False)[1].items()}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                       if f.endswith((".pkl", ".pickle")))
        return _LookalikeDataset(files, self, batch_size)


class _LookalikeDataset:
    """Pickled rows, grouped into meta-tasks of support and query halves
    (reader_train.py:64-120's sampling, simplified to sequential packing).
    Columns (reader_train.py:58-61): label, aid, 7 static, 50 dynamic ids
    (padded to the spans), 7 lengths, 6 ad.  Rows beyond a whole number of
    ``2·batch·task_count`` are dropped."""

    def __init__(self, files, model_def, batch_size):
        self.files = files
        self.md = model_def
        self.batch_size = batch_size

    def __iter__(self):
        bs, t = self.batch_size, self.md.task_count
        for path in self.files:
            with open(path, "rb") as f:
                df = pickle.load(f)
            rows = np.asarray(df if isinstance(df, np.ndarray) else df.to_numpy())
            n = (len(rows) // (2 * bs * t)) * (2 * bs * t)
            if n == 0:
                continue
            # task-major pairing: each task's 2·bs consecutive rows stay
            # together, support then query from the same ad
            chunk = rows[:n].reshape(-1, t, 2, bs, rows.shape[-1])
            for grp in chunk:
                spt, qry = grp[:, 0], grp[:, 1]

                def unpack(g, prefix):
                    return {
                        f"{prefix}_label": g[..., 0].astype(np.float32),
                        f"{prefix}_static": g[..., 2:9].astype(np.int32),
                        f"{prefix}_dynamic_ids": g[..., 9:59].astype(np.int32),
                        f"{prefix}_dynamic_lengths": g[..., 59:66].astype(np.int32),
                        f"{prefix}_ad": g[..., 66:72].astype(np.int32),
                    }

                yield {**unpack(spt, "spt"), **unpack(qry, "qry")}
