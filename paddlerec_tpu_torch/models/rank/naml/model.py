"""NAML: neural news recommendation with attentive multi-view learning, and
the news-recommendation base that fastformer shares.

Counterpart of ``paddlerec_tpu/models/rank/naml/model.py``, registered as
``rank.naml``:
  * news encoder: word embedding → one width-3 ``SAME`` 1-D conv (400
    channels, no bias) shared by title and content, each with its own bias
    vector, relu and additive-attention pooling; category and sub-category
    linear views; a mix additive attention over the four views;
  * user encoder: additive attention over the browsed news;
  * score: dot(user vector, candidate vectors) over 1 positive and
    ``neg_condidate_sample_size`` negatives.
``NewsRecModelDef`` holds the loss (a softmax cross-entropy with soft labels
over the candidates, masked per row) and the AUC over the flattened
candidates.  Candidates and browsed news go through ONE news-encoder call
over (B·(S+V)) news, and the word table is read once per forward, title and
content ids in one ``Embed`` call: three K1 launches a forward (words,
categories, sub-categories), three K1b a step.

flax's ``Conv`` kernel ``(3, in, out)`` over ``(N, T, C)`` is here
``conv1d`` with ``padding=1`` over ``(N, C, T)``, weight ``(out, in, 3)``
(``convert.py`` reverses the axes both ways).

``NewsDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense, lecun_normal_, normal_param


class AdditiveAttention(nn.Module):
    """``softmax(proj(x) @ vec)`` pooling over the group axis: ``proj`` (D →
    ``proj_dim``, weights normal(0.01), zero bias), ``vec`` (``proj_dim``,
    1) normal(0.1).  x (B, G, D) → (B, D)."""

    def __init__(self, dim: int, proj_dim: int = 100, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = nn.Linear(dim, proj_dim, device=device)
        with torch.no_grad():
            self.proj.weight.normal_(0.0, 0.01, generator=generator)
            self.proj.bias.zero_()
        self.vec = normal_param((proj_dim, 1), 0.1, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.softmax((self.proj(x) @ self.vec)[..., 0], dim=-1)  # (B, G)
        return torch.einsum("bg,bgd->bd", w, x)


def conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """flax's width-3 ``SAME`` conv over (N, T, C) → (N, T, out)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def news_conv(in_dim: int, out_dim: int, bias: bool, device=None,
              generator: Optional[torch.Generator] = None) -> nn.Conv1d:
    """A width-3 ``conv1d`` initialized as flax's ``Conv`` default: lecun
    normal over fan_in = 3·in (truncated at two deviations), zero bias."""
    conv = nn.Conv1d(in_dim, out_dim, 3, padding=1, bias=bias, device=device)
    lecun_normal_(conv.weight, 3 * in_dim, generator)
    if bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


class CategoryViews(nn.Module):
    """The category and sub-category views of a news encoder:
    ``cate_embedding`` → ``category_linear`` → relu, and the same for
    ``sub_cate_embedding`` / ``sub_category_linear``."""

    def __init__(self, category_size: int, sub_category_size: int, cate_dim: int,
                 conv_out: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.cate_embedding = Embed(category_size + 1, cate_dim, **kw)
        self.sub_cate_embedding = Embed(sub_category_size + 1, cate_dim, **kw)
        self.category_linear = flax_dense(cate_dim, conv_out, **kw)
        self.sub_category_linear = flax_dense(cate_dim, conv_out, **kw)

    def views(self, category, sub_category):
        cate_v = torch.relu(self.category_linear(self.cate_embedding(category)))
        sub_v = torch.relu(self.sub_category_linear(self.sub_cate_embedding(sub_category)))
        return cate_v, sub_v


class NewsEncoder(CategoryViews):
    """category/sub_category (N,), title (N, Tt), content (N, Tc) → (N,
    conv_out).  Parameters ``word2vec_embedding``, ``cate_embedding``,
    ``sub_cate_embedding``, ``category_linear``, ``sub_category_linear``,
    ``conv_title`` (no bias), ``conv_title_bias``, ``conv_content_bias``
    (normal(1/conv_out) each), ``title_attention``, ``content_attention``,
    ``mix_attention``."""

    def __init__(self, word_dict_size: int, word_dim: int, category_size: int,
                 sub_category_size: int, cate_dim: int, conv_out: int = 400,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(category_size, sub_category_size, cate_dim, conv_out,
                         device, generator)
        kw = {"device": device, "generator": generator}
        self.word2vec_embedding = Embed(word_dict_size + 1, word_dim, **kw)
        self.conv_title = news_conv(word_dim, conv_out, False, **kw)
        self.conv_title_bias = normal_param((conv_out,), 1.0 / conv_out, **kw)
        self.conv_content_bias = normal_param((conv_out,), 1.0 / conv_out, **kw)
        for name in ("title_attention", "content_attention", "mix_attention"):
            self.add_module(name, AdditiveAttention(conv_out, **kw))

    def forward(self, category, sub_category, title, content):
        cate_v, sub_v = self.views(category, sub_category)
        title_w, content_w = self.word2vec_embedding(title, content)
        # the reference reuses conv_title for content too
        title_v = self.title_attention(
            torch.relu(conv_same(self.conv_title, title_w) + self.conv_title_bias))
        content_v = self.content_attention(
            torch.relu(conv_same(self.conv_title, content_w) + self.conv_content_bias))
        views = torch.stack([title_v, content_v, cate_v, sub_v], dim=1)
        return self.mix_attention(views)


def concat_news(cate_sample, cate_visit, sub_cate_sample, sub_cate_visit,
                title_sample, title_visit, content_sample, content_visit):
    """Candidates then browsed news on one axis, flattened to (B·G) news:
    (category, sub_category, title, content, B, G)."""
    cate = torch.cat([cate_sample, cate_visit], dim=1)
    sub = torch.cat([sub_cate_sample, sub_cate_visit], dim=1)
    title = torch.cat([title_sample, title_visit], dim=1)
    content = torch.cat([content_sample, content_visit], dim=1)
    b, g = cate.shape
    return (cate.reshape(-1), sub.reshape(-1), title.reshape(b * g, -1),
            content.reshape(b * g, -1), b, g)


class NAMLNet(nn.Module):
    """Parameters ``news_encoder`` (``NewsEncoder``) and ``user_attention``;
    returns the (B, S) candidate logits."""

    def __init__(self, word_dict_size: int, word_dim: int, category_size: int,
                 sub_category_size: int, cate_dim: int, sample_size: int,
                 browse_size: int, conv_out: int = 400, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_size = sample_size
        self.conv_out = conv_out
        self.news_encoder = NewsEncoder(word_dict_size, word_dim, category_size,
                                        sub_category_size, cate_dim, conv_out,
                                        device, generator)
        self.user_attention = AdditiveAttention(conv_out, device=device,
                                                generator=generator)

    def forward(self, *news):
        cate, sub, title, content, b, g = concat_news(*news)
        vecs = self.news_encoder(cate, sub, title, content).reshape(b, g, self.conv_out)
        sample_emb = vecs[:, :self.sample_size]
        user = self.user_attention(vecs[:, self.sample_size:])
        return torch.einsum("bsd,bd->bs", sample_emb, user)  # (B, S) logits


class NewsRecModelDef(ModelDef):
    """Shared contract of NAML and Fastformer: softmax CE with soft labels
    over the candidates, averaged over the rows the batch's ``mask`` keeps;
    AUC over the flattened candidate scores."""

    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.title_size = int(h("article_title_size", 10))
        self.content_size = int(h("article_content_size", 30))
        self.browse_size = int(h("browse_size", 10))
        self.neg_size = int(h("neg_condidate_sample_size", 4))
        self.word_dim = int(h("word_dimension", 30))
        self.category_size = int(h("category_size", 4))
        self.sub_category_size = int(h("sub_category_size", 10))
        self.cate_dim = int(h("category_dimension", 32))
        self.word_dict_size = int(h("word_dict_size", 101))

    def model_inputs(self, batch):
        return (
            batch["cate_sample"], batch["cate_visit"],
            batch["sub_cate_sample"], batch["sub_cate_visit"],
            batch["title_sample"], batch["title_visit"],
            batch["content_sample"], batch["content_visit"],
        )

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        s, v = self.neg_size + 1, self.browse_size

        def ids(hi, *shape):
            return rng.randint(0, hi, shape).astype(np.int64)

        labels = np.zeros((batch_size, s), np.float32)
        labels[np.arange(batch_size), rng.randint(0, s, batch_size)] = 1.0
        return {
            "cate_sample": ids(self.category_size, batch_size, s),
            "cate_visit": ids(self.category_size, batch_size, v),
            "sub_cate_sample": ids(self.sub_category_size, batch_size, s),
            "sub_cate_visit": ids(self.sub_category_size, batch_size, v),
            "title_sample": ids(self.word_dict_size, batch_size, s, self.title_size),
            "title_visit": ids(self.word_dict_size, batch_size, v, self.title_size),
            "content_sample": ids(self.word_dict_size, batch_size, s, self.content_size),
            "content_visit": ids(self.word_dict_size, batch_size, v, self.content_size),
            "labels": labels,
        }

    def _aux(self, logits: torch.Tensor, batch) -> Aux:
        aux = {"predictions": torch.sigmoid(logits).reshape(-1),
               "labels": batch["labels"].to(torch.float32).reshape(-1)}
        if "mask" in batch:
            aux["mask"] = batch["mask"][:, None].expand(-1, logits.shape[1]).reshape(-1)
        return aux

    def train_forward(self, module, batch):
        logits = module(*self.model_inputs(batch))  # (B, S)
        labels = batch["labels"].to(torch.float32)
        per = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        mask = batch.get("mask")
        if mask is not None:
            loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = per.mean()
        return loss, self._aux(logits, batch)

    def infer_forward(self, module, batch):
        # the loss is left out, as XLA drops it from the JAX package's
        return self._aux(module(*self.model_inputs(batch)), batch)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return NewsDataset(self, list_data_files(data_dir), batch_size)


@register_model("rank.naml")
class ModelDef(NewsRecModelDef):
    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return NAMLNet(self.word_dict_size, self.word_dim, self.category_size,
                       self.sub_category_size, self.cate_dim, self.neg_size + 1,
                       self.browse_size, device=device, generator=generator)


class NewsDataset:
    """Semicolon-grouped line format: ``labels;cate_sample;cate_visit;
    sub_cate_sample;sub_cate_visit;title_sample;title_visit;
    content_sample;content_visit``, ids comma-separated, matrices row-major.
    Lines with another number of groups are skipped; the tail batch is
    padded to the batch with zero rows and ``mask`` 0."""

    def __init__(self, md, files, batch_size):
        self.md = md
        self.files = files
        self.batch_size = batch_size

    def __iter__(self):
        md, bs = self.md, self.batch_size
        s, v = md.neg_size + 1, md.browse_size
        shapes = {
            "labels": (s,), "cate_sample": (s,), "cate_visit": (v,),
            "sub_cate_sample": (s,), "sub_cate_visit": (v,),
            "title_sample": (s, md.title_size),
            "title_visit": (v, md.title_size),
            "content_sample": (s, md.content_size),
            "content_visit": (v, md.content_size),
        }
        keys = list(shapes)
        buf = {k: [] for k in keys}
        n = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(";")
                    if len(parts) != len(keys):
                        continue
                    for k, p in zip(keys, parts):
                        buf[k].append(np.asarray(
                            [float(x) for x in p.split(",")]).reshape(shapes[k]))
                    n += 1
                    if n == bs:
                        yield self._emit(buf)
                        buf = {k: [] for k in keys}
                        n = 0
        if n:
            yield self._emit(buf, pad_to=bs, valid=n)

    @staticmethod
    def _emit(buf, pad_to=None, valid=None):
        out = {}
        for k, vals in buf.items():
            arr = np.stack(vals)
            if pad_to is not None and len(arr) < pad_to:
                pad = np.zeros((pad_to - len(arr),) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            out[k] = arr.astype(np.float32) if k == "labels" else arr.astype(np.int64)
        n_rows = len(next(iter(out.values())))
        out["mask"] = (np.arange(n_rows) < (valid if valid is not None else n_rows)
                       ).astype(np.float32)
        return out
