"""Movie-recommend demo: the two-stage recall → rank pipeline.

Counterpart of ``paddlerec_tpu/models/demo/movie_recommand/model.py``, one
file for the two registrations ``demo.movie_recall`` and ``demo.movie_rank``
(``core/registry.py`` aliases both to it).  Parity target of the original:
reference models/demo/movie_recommand/ —
  * recall (recall/net.py:22-102): one shared 9-d table
    ``SparseFeatFactors`` over the user fields (uid, gender, age,
    occupation) and the movie fields (mid, title tokens sum-pooled, genres
    sum-pooled); two [512, 256, 128, 32] ReLU towers (``user_fc{i}``,
    ``movie_fc{i}``); score = 5 · cosine(user, movie), the norm
    ``rsqrt(Σx² + 1e-12)``; MSE against the 1-5 rating;
  * rank (rank/net.py): the same features through one DNN (``fc{i}``,
    ``out``, + 2.5);
  * pipeline (README): export user/movie vectors → exact top-k
    (``ann_topk``, ``serving/vector_index.py``) → rank → final order
    (``serving/movie_recommender.py``).

Three K1 launches a forward, three K1b a step: the four user fields and the
movie id unpooled in one ``Embed`` call (N = 5·B), the title's masked bag of
``TITLE_LEN`` ids and the genres' of ``GENRE_LEN`` each through
``Embed.pool``.  ``ann_topk``'s product is a plain ``torch.matmul`` (the JAX
package leaves it to XLA) and its top-k is ``jax.lax.top_k``'s, the lower
index first on ties.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import resolve_device
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense, top_k

USER_FIELDS = 4  # uid, gender, age, occupation
TITLE_LEN = 8
GENRE_LEN = 4


def unit_norm(x: torch.Tensor) -> torch.Tensor:
    """``x · rsqrt(Σx² + 1e-12)`` over the last axis, the reference's form
    (not ``F.normalize``: a zero row stays zero, with its own gradient)."""
    return x * torch.rsqrt((x**2).sum(-1, keepdim=True) + 1e-12)


class _MovieFeatures(nn.Module):
    """The shared table and the three lookups of both models."""

    def __init__(self, vocab: int, dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.SparseFeatFactors = Embed(vocab, dim, device=device, generator=generator)

    def features(self, user_sparse, movie_id, title, genres, title_mask, genre_mask):
        """(user (B, 4·dim), mid (B, dim), title bag (B, dim), genre bag
        (B, dim))."""
        emb = self.SparseFeatFactors
        user, mid = emb(user_sparse, movie_id)
        return (user.reshape(user_sparse.shape[0], -1), mid,
                emb.pool(title, title_mask), emb.pool(genres, genre_mask))


class TwoTower(_MovieFeatures):
    def __init__(self, vocab: int, dim: int = 9,
                 fc_sizes: Sequence[int] = (512, 256, 128, 32), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vocab, dim, device, generator)
        kw = {"device": device, "generator": generator}
        self.num_fcs = len(fc_sizes)
        for tower, fan_in in (("user", USER_FIELDS * dim), ("movie", 3 * dim)):
            for i, d in enumerate(fc_sizes):
                self.add_module(f"{tower}_fc{i}", flax_dense(fan_in, d, **kw))
                fan_in = d

    def towers(self, user_sparse, movie_id, title, genres, title_mask, genre_mask):
        user, mid, ttl, gnr = self.features(user_sparse, movie_id, title, genres,
                                            title_mask, genre_mask)
        movie = torch.cat([mid, ttl, gnr], -1)  # (B, 27)
        for i in range(self.num_fcs):
            user = torch.relu(getattr(self, f"user_fc{i}")(user))
            movie = torch.relu(getattr(self, f"movie_fc{i}")(movie))
        return user, movie

    def forward(self, *inputs):
        user, movie = self.towers(*inputs)
        return 5.0 * (unit_norm(user) * unit_norm(movie)).sum(-1)  # rating prediction


class RankDNN(_MovieFeatures):
    def __init__(self, vocab: int, dim: int = 9,
                 fc_sizes: Sequence[int] = (512, 256, 128, 32), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(vocab, dim, device, generator)
        kw = {"device": device, "generator": generator}
        self.num_fcs = len(fc_sizes)
        fan_in = (USER_FIELDS + 3) * dim
        for i, d in enumerate(fc_sizes):
            self.add_module(f"fc{i}", flax_dense(fan_in, d, **kw))
            fan_in = d
        self.out = flax_dense(fan_in, 1, **kw)

    def forward(self, *inputs):
        h = torch.cat(self.features(*inputs), -1)
        for i in range(self.num_fcs):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        return self.out(h)[:, 0] + 2.5  # centered rating


class _MovieModelDef(BaseModelDef):
    metrics = "none"
    metric_names = ()
    module_class = None

    def __init__(self, config: Config):
        super().__init__(config)
        self.vocab = int(config.hyper("sparse_feature_number", 600000))
        self.dim = int(config.hyper("sparse_feature_dim", 9))
        self.fc_sizes = tuple(
            int(x) for x in config.hyper("fc_sizes", [512, 256, 128, 32])
        )

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return self.module_class(self.vocab, self.dim, self.fc_sizes, device=device,
                                 generator=generator)

    def model_inputs(self, batch):
        return (
            batch["user_sparse"], batch["movie_id"], batch["title"],
            batch["genres"], batch["title_mask"], batch["genre_mask"],
        )

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "user_sparse": rng.randint(
                1, self.vocab, (batch_size, USER_FIELDS)
            ).astype(np.int64),
            "movie_id": rng.randint(1, self.vocab, batch_size).astype(np.int64),
            "title": rng.randint(1, self.vocab, (batch_size, TITLE_LEN)
                                 ).astype(np.int64),
            "genres": rng.randint(1, self.vocab, (batch_size, GENRE_LEN)
                                  ).astype(np.int64),
            "title_mask": np.ones((batch_size, TITLE_LEN), np.float32),
            "genre_mask": np.ones((batch_size, GENRE_LEN), np.float32),
            "label": rng.randint(1, 6, batch_size).astype(np.float32),
        }

    def train_forward(self, module, batch):
        pred = module(*self.model_inputs(batch))
        label = batch["label"].to(torch.float32)
        loss = torch.mean(torch.square(pred - label))
        return loss, {"predictions": pred, "labels": label}


@register_model("demo.movie_recall")
class RecallModelDef(_MovieModelDef):
    module_class = TwoTower

    def user_vector(self, module, batch) -> torch.Tensor:
        return module.towers(*self.model_inputs(batch))[0]

    def movie_vector(self, module, batch) -> torch.Tensor:
        return module.towers(*self.model_inputs(batch))[1]


@register_model("demo.movie_rank")
class RankModelDef(_MovieModelDef):
    module_class = RankDNN


@torch.no_grad()
def ann_topk(user_vecs: np.ndarray, movie_vecs: np.ndarray, k: int,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k — the Milvus-recall analog (one product), on
    ``device`` (the card by default).  Returns (scores (U, k), indices (U, k))
    as numpy."""
    device = resolve_device(device)
    u = unit_norm(torch.as_tensor(np.asarray(user_vecs, np.float32), device=device))
    m = unit_norm(torch.as_tensor(np.asarray(movie_vecs, np.float32), device=device))
    # clamp like VectorIndex.search: k beyond the catalog crashes top_k
    vals, idx = top_k(u @ m.T, min(k, m.shape[0]))
    return vals.cpu().numpy(), idx.cpu().numpy()
