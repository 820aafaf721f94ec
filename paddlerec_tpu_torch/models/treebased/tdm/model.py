"""TDM: tree-based deep match (layer-wise softmax over a tree of items).

Counterpart of ``paddlerec_tpu/models/treebased/tdm/model.py``, registered as
``treebased.tdm``:
  * ``node_emb``, one table indexed by tree code (``total_nodes`` ×
    ``node_emb_size``: internal nodes and leaves share it, as the
    reference's unit-id embedding);
  * the behaviour history's leaf codes looked up and mean-pooled per group of
    ``fea_groups`` (the mean over ``max(mask.sum, 1)``; an unknown item is
    code 0 under mask 0), the groups concatenated and projected by
    ``group_proj``;
  * per candidate node the features ``[u⊙n, u−n, u·n]`` → ``relu_fc`` (ReLU)
    → ``cos_sim_fc``, two logits;
  * training on the units of ``TreeIndex.sample`` (positives the ancestors
    of the clicked leaf at every level, negatives uniform on the same
    level): the masked mean of the 2-way NLL; the AUC over the flattened
    units is logged as ``auc``;
  * ``retrieve``, the layer-wise beam search, the family's serving path.

The history and the candidates read ``node_emb`` in one ``Embed`` call: one
K1 launch a forward (N = B·(S + T)), one K1b a step.  ``retrieve`` runs one
forward a level and a final rescore, each one K1 launch; its top-k is
``jax.lax.top_k``'s (the lower index first on ties: every invalid child
scores -1.0, so ties are the rule at ragged levels).  ``TDMDataset`` is a
copy of the JAX package's reader (numpy only); it reads every file (the
JAX package shards them by process, and the port runs one).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef
from paddlerec_tpu_torch.models.treebased.tree import TreeIndex
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense, top_k


class TDMNet(nn.Module):
    """hist_ids (B, S) leaf codes of the behaviour history, hist_mask (B, S),
    unit_codes (B, T) candidate node codes → logits (B, T, 2)."""

    def __init__(self, total_nodes: int, node_emb_size: int = 24,
                 fea_groups: Sequence[int] = (20, 20, 10, 10, 2, 2, 2, 1, 1, 1),
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        e = node_emb_size
        self.fea_groups = tuple(int(g) for g in fea_groups)
        self.node_emb = Embed(total_nodes, e, **kw)
        self.group_proj = flax_dense(e * len(self.fea_groups), e, **kw)
        self.relu_fc = flax_dense(2 * e + 1, e, **kw)
        self.cos_sim_fc = flax_dense(e, 2, **kw)

    def forward(self, hist_ids, hist_mask, unit_codes):
        hist, node = self.node_emb(hist_ids, unit_codes)
        hist = hist * hist_mask[..., None]
        groups, start = [], 0
        for g in self.fea_groups:
            seg_m = hist_mask[:, start:start + g]
            groups.append(hist[:, start:start + g].sum(1)
                          / torch.clamp(seg_m.sum(1, keepdim=True), min=1.0))
            start += g
        u = self.group_proj(torch.cat(groups, dim=-1))[:, None, :]  # (B, 1, E)
        feat = torch.cat([u * node, u - node, (u * node).sum(-1, keepdim=True)], dim=-1)
        return self.cos_sim_fc(torch.relu(self.relu_fc(feat)))


@register_model("treebased.tdm")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config: Config):
        super().__init__(config)
        h = config.hyper
        self.node_emb_size = int(h("node_emb_size", 24))
        self.neg_per_layer = int(h("neg_sampling_list", 4))
        fg = h("fea_groups", "20,20,10,10,2,2,2,1,1,1")
        if isinstance(fg, (list, tuple)):  # CLI -o coerces "3,3" to a tuple
            self.fea_groups = tuple(int(x) for x in fg)
        else:
            self.fea_groups = tuple(int(x) for x in str(fg).split(","))
        self.tree: Optional[TreeIndex] = None
        self._valid = None  # (tree, device, (total_nodes,) bool): ``_valid_codes``
        tree_path = config.get("hyper_parameters.tree_path")
        if tree_path:
            p = str(tree_path)
            if os.path.exists(p) or os.path.exists(p + ".npz"):
                self.tree = TreeIndex.load(p)
            # a missing artifact is fine at instantiation time (example
            # configs ship placeholder paths); training and retrieval assert
            # a tree with a pointed message
        self.total_nodes = int(
            h("total_nodes", self.tree.total_nodes if self.tree else 2047))

    def set_tree(self, tree: TreeIndex) -> None:
        """A new tree: ``make_module`` builds the table at its
        ``total_nodes`` from now on.  A module already built keeps its table,
        as the JAX trainer keeps its parameters: a re-learned tree of the
        same depth has the same node count."""
        self.tree = tree
        self.total_nodes = tree.total_nodes

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return TDMNet(self.total_nodes, self.node_emb_size, self.fea_groups,
                      device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["hist_ids"], batch["hist_mask"], batch["unit_codes"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        s = sum(self.fea_groups)
        layers = max(int(np.log2(max(self.total_nodes, 2))), 1)
        t = layers * (1 + self.neg_per_layer)
        labels = np.zeros((batch_size, t), np.float32)
        labels[:, :: (1 + self.neg_per_layer)] = 1.0
        return {
            "hist_ids": rng.randint(0, self.total_nodes, (batch_size, s)).astype(np.int64),
            "hist_mask": (rng.rand(batch_size, s) < 0.8).astype(np.float32),
            "unit_codes": rng.randint(0, self.total_nodes, (batch_size, t)).astype(np.int64),
            "labels": labels,
            "unit_mask": np.ones((batch_size, t), np.float32),
        }

    def train_forward(self, module, batch):
        logits = module(*self.model_inputs(batch))  # (B, T, 2)
        labels = batch["labels"].to(torch.int64)
        w = batch.get("unit_mask")
        w = w if w is not None else torch.ones(labels.shape, device=logits.device)
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        aux: Aux = {
            "predictions": torch.softmax(logits, -1)[..., 1].reshape(-1),
            "labels": labels.to(torch.float32).reshape(-1),
            "mask": w.reshape(-1),
        }
        return loss, aux

    def _valid_codes(self, device) -> torch.Tensor:
        """Whether each code of the tree has a leaf below it (is in its
        level's ``level_codes``), on ``device``; built once a tree and
        device.  Every code at a level lies in that level's range of the
        heap layout, so the one table answers every level."""
        tree = self.tree
        if self._valid is None or self._valid[0] is not tree or self._valid[1] != device:
            valid = np.zeros(tree.total_nodes, bool)
            for codes in tree.level_codes:
                valid[codes] = True
            self._valid = (tree, device, torch.from_numpy(valid).to(device))
        return self._valid[2]

    # -- layer-wise beam-search retrieval (tdm/infer.py:145-235) -------------
    @torch.no_grad()
    def retrieve(self, module, hist_ids, hist_mask, topk: int = 10,
                 beam: int = 20) -> List[List[int]]:
        """The top-``topk`` leaf item ids per example; ``hist_ids`` and
        ``hist_mask`` (B, S) on the module's device."""
        assert self.tree is not None, "set_tree() or hyper_parameters.tree_path"
        tree = self.tree
        device = hist_ids.device

        def score(codes):  # (B, N) → (B, N) p(positive)
            return torch.softmax(module(hist_ids, hist_mask, codes), -1)[..., 1]

        levels = tree.beam_layers(beam)
        is_valid = self._valid_codes(device)
        # first level: score all candidates, keep the beam
        cand = torch.from_numpy(levels[0]).to(device)[None].expand(
            hist_ids.shape[0], len(levels[0]))
        for depth in range(len(levels)):
            if depth > 0:
                # expand the previous beam into children, mask those absent
                # from this level's valid set
                cand = torch.cat([tree.branch * cand + k
                                  for k in range(1, tree.branch + 1)], dim=1)
                valid = is_valid[cand]
            else:
                valid = torch.ones(cand.shape, dtype=torch.bool, device=device)
            probs = torch.where(valid, score(cand), -1.0)
            _, idx = top_k(probs, min(beam, cand.shape[1]))
            cand = torch.gather(cand, 1, idx)
            last_valid = torch.gather(valid, 1, idx)
        # the final rescore keeps the validity mask: an invalid code with a
        # high raw score would displace real leaves in the top-k
        probs = torch.where(last_valid, score(cand), -1.0)
        _, idx = top_k(probs, min(topk, cand.shape[1]))
        top_codes = torch.gather(cand, 1, idx).cpu().numpy()
        return [tree.leaf_items(row)[:topk] for row in top_codes]

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return TDMDataset(list_data_files(data_dir), self, batch_size,
                          seed=int(self.config.runner("seed", 2023)))


class TDMDataset:
    """Lines: ``hist_item1 ... hist_itemS | target_item`` (item ids);
    layer-wise sampling happens here — the host-side analog of the
    engine's dataset.tdm_sample."""

    def __init__(self, files, md, batch_size, seed=2023):
        self.files = files
        self.md = md
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self):
        md = self.md
        assert md.tree is not None
        rng = np.random.RandomState(self.seed)
        s = sum(md.fea_groups)
        item_to_code = {
            int(i): int(c) for i, c in zip(md.tree.item_ids, md.tree.codes)
        }
        hist_buf, tgt_buf = [], []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    left, _, right = line.partition("|")
                    try:
                        hist = [int(x) for x in left.split()][:s]
                        tgt = int(right.split()[0])
                    except (ValueError, IndexError):
                        continue  # malformed lines are skipped, like the
                        # slot readers
                    hist_buf.append(hist)
                    tgt_buf.append(tgt)
                    if len(hist_buf) == self.batch_size:
                        yield self._batch(hist_buf, tgt_buf, item_to_code,
                                          rng, s)
                        hist_buf, tgt_buf = [], []
        if hist_buf:
            yield self._batch(hist_buf, tgt_buf, item_to_code, rng, s)

    def _batch(self, hists, targets, item_to_code, rng, s):
        md = self.md
        n = len(hists)
        hist_ids = np.zeros((n, s), np.int64)
        hist_mask = np.zeros((n, s), np.float32)
        for i, h in enumerate(hists):
            codes = [item_to_code.get(x, 0) for x in h]
            hist_ids[i, : len(codes)] = codes
            hist_mask[i, : len(codes)] = [1.0 if c else 0.0 for c in codes]
        units, labels = md.tree.sample(
            np.asarray(targets), md.neg_per_layer, rng
        )
        return {
            "hist_ids": hist_ids,
            "hist_mask": hist_mask,
            "unit_codes": units,
            "labels": labels,
            "unit_mask": np.ones(units.shape, np.float32),
            "mask": np.ones(n, np.float32),
            # target item per row: JTM's sample-set collector groups
            # user histories by clicked item (models/treebased/jtm.py)
            "item_id": np.asarray(targets, np.int64),
        }
