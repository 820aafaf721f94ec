"""IPRec: package recommendation (item + business + friends bundles).

Counterpart of ``paddlerec_tpu/models/rank/iprec/model.py``, registered as
``rank.iprec``: the user from three attention pools (friends, items,
businesses) mixed by a type attention and fused with the id embedding
(``w_self``); every package (the target, the user's ``u_max_pack``
historical packages, the target's business- and friend-side neighbours) in
one batched pass over a (B·N_pk) axis: K social-influence heads pool a
package's friends against its item, a user-conditioned attention mixes the
heads, and the package vector attends over the seven products of (friends,
item, business); sigmoid gates aggregate neighbour packages into the target
and historical packages into the user; an MLP [3D → 64 → 32 → 1] on
``[user, pack, user·pack]``.

As in the JAX model, attention pads where the mask is 0 (the published
model's intent; the reference's own ``Attention`` inverts its mask), with
the fill ``NEG = -2^31``, so a row with no valid key gets uniform weights.

Each table is read once per forward, all of its id tensors in one ``Embed``
call (the JAX model reads ``user_emb`` three times and the other two tables
twice): three K1 launches a forward, three K1b a step, three zero fills.

``IPRECDataset`` is a copy of the JAX package's JSON-lines reader.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import LogitModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import LayerNorm, flax_dense, normal_param

NEG = -(2.0 ** 31)


def _masked_softmax(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.where(mask > 0, v, torch.full_like(v, NEG)), dim=-1)


class UserAttention(nn.Module):
    """Attention of the reference's ``net.py:48-76``: a score per key from
    ``w`` (2D → hidden, no bias) over ``[query ‖ key]``, ``norm``, relu,
    ``w_omega`` (→ 1), tanh, times the scalar ``u_omega``; a masked softmax
    over the keys.  query (B, D), keys (B, N, D), mask (B, N) → (pooled (B,
    D), weights (B, N))."""

    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = flax_dense(2 * dim, hidden, device, generator, bias=False)
        self.norm = LayerNorm(hidden, device=device)
        self.u_omega = normal_param((1,), 0.1, device, generator)
        self.w_omega = flax_dense(hidden, 1, device, generator)

    def forward(self, query, keys, mask):
        q = query[:, None, :].expand_as(keys)
        x = torch.relu(self.norm(self.w(torch.cat([q, keys], dim=-1))))
        v = torch.tanh(self.w_omega(x))[..., 0] * self.u_omega[0]
        att = _masked_softmax(v, mask)
        return torch.einsum("bn,bnd->bd", att, keys), att


class GateAttention(nn.Module):
    """Sigmoid gate aggregation (the reference's ``net.py:25-45``):
    ``Σ_n sigmoid(w1(anchor) + w2(others_n))·mask_n·others_n``.  anchor (B,
    D), others (B, N, D), mask (B, N) → (B, D)."""

    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = flax_dense(dim, hidden, device, generator, bias=False)
        self.w2 = flax_dense(dim, hidden, device, generator)

    def forward(self, anchor, others, mask):
        attn = torch.sigmoid(self.w1(anchor)[:, None, :] + self.w2(others)) * mask[..., None]
        return (attn * others).sum(dim=1)


def _nonzero(ids: torch.Tensor) -> torch.Tensor:
    return (ids != 0).to(torch.float32)


def _pack_mask(packs: torch.Tensor) -> torch.Tensor:
    return (packs.abs().sum(dim=-1) != 0).to(torch.float32)


class IPRecNet(nn.Module):
    """Parameters named as the flax tree names them: ``user_emb``,
    ``item_emb``, ``biz_emb``; ``friend_attn``, ``item_attn``,
    ``biz_attn``, ``type_attn``, ``pack_attn`` (``UserAttention``);
    ``w_self``; per head k ``intra_k_wk``, ``intra_k_wi``, ``intra_k_u``,
    ``intra_k_w``; ``w_a``, ``u_omega``, ``w_omega``; ``biz_gate``,
    ``friend_gate``, ``user_gate`` (``GateAttention``); ``dnn_0``,
    ``dnn_1``, ``dnn_out``."""

    def __init__(self, num_users: int, num_items: int, num_bizs: int,
                 hidden: int = 64, f_max_len: int = 20, K: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = hidden
        kw = {"device": device, "generator": generator}
        self.K = K
        self.user_emb = Embed(num_users + 1, d, **kw)
        self.item_emb = Embed(num_items + 1, d, **kw)
        self.biz_emb = Embed(num_bizs + 1, d, **kw)
        for name in ("friend_attn", "item_attn", "biz_attn", "type_attn"):
            self.add_module(name, UserAttention(d, d, **kw))
        self.w_self = flax_dense(2 * d, d, bias=False, **kw)
        for k in range(K):
            self.add_module(f"intra_{k}_wk", flax_dense(d, d, bias=False, **kw))
            self.add_module(f"intra_{k}_wi", flax_dense(d, d, bias=False, **kw))
            setattr(self, f"intra_{k}_u", normal_param((1,), 0.1, **kw))
            self.add_module(f"intra_{k}_w", flax_dense(2 * d, 1, **kw))
        self.w_a = flax_dense(2 * d, d, bias=False, **kw)
        self.u_omega = normal_param((1,), 0.1, **kw)
        self.w_omega = flax_dense(d, 1, **kw)
        self.pack_attn = UserAttention(d, d, **kw)
        for name in ("biz_gate", "friend_gate", "user_gate"):
            self.add_module(name, GateAttention(d, d, **kw))
        self.dnn_0 = flax_dense(3 * d, 64, **kw)
        self.dnn_1 = flax_dense(64, 32, **kw)
        self.dnn_out = flax_dense(32, 1, **kw)

    def forward(self, user, item, biz, friends, user_items, user_bizs, user_friends,
                user_packages, pack_neighbors_b, pack_neighbors_f):
        b = user.shape[0]
        # ---- package tensor: target + historical + neighbours ----
        target_pack = torch.cat(
            [item[:, None, None], biz[:, None, None], friends[:, None, :]], dim=-1)
        packs = torch.cat([target_pack, user_packages, pack_neighbors_b, pack_neighbors_f],
                          dim=1)  # (B, N_pk, 2+F)
        n_pk = packs.shape[1]
        # one lookup per table: every id tensor of a table in one call
        u0, u_friends, p_friends = self.user_emb(user, user_friends, packs[..., 2:])
        u_items, p_item = self.item_emb(user_items, packs[..., 0])
        u_bizs, p_biz = self.biz_emb(user_bizs, packs[..., 1])

        # ---- dual aggregate (user modeling) ----
        f_vec, _ = self.friend_attn(u0, u_friends, _nonzero(user_friends))
        i_vec, _ = self.item_attn(u0, u_items, _nonzero(user_items))
        b_vec, _ = self.biz_attn(u0, u_bizs, _nonzero(user_bizs))
        types = torch.stack([f_vec, i_vec, b_vec], dim=1)
        t_vec, _ = self.type_attn(u0, types, types.new_ones(b, 3))
        u_emb = torch.relu(self.w_self(torch.cat([t_vec, u0], dim=-1)))

        # ---- K social-influence heads ----
        f_mask = _nonzero(packs[..., 2:])  # (B, N, F)
        heads = []
        for k in range(self.K):
            fk = getattr(self, f"intra_{k}_wk")(p_friends)  # (B, N, F, D)
            it = getattr(self, f"intra_{k}_wi")(p_item)
            score_in = torch.cat([it[:, :, None, :].expand_as(fk), fk], dim=-1)
            v = (torch.tanh(getattr(self, f"intra_{k}_w")(score_in))[..., 0]
                 * getattr(self, f"intra_{k}_u")[0])
            att = _masked_softmax(v, f_mask)
            heads.append(torch.einsum("bnf,bnfd->bnd", att, fk))
        f_k = torch.stack(heads, dim=2)  # (B, N, K, D)

        # ---- user-conditioned mix of the K heads ----
        uq = u_emb[:, None, None, :].expand_as(f_k)
        mix_in = torch.relu(self.w_a(torch.cat([uq, f_k], dim=-1)))
        v = torch.tanh(self.w_omega(mix_in))[..., 0] * self.u_omega[0]
        att = torch.softmax(v, dim=-1)  # (B, N, K)
        f_emb = torch.einsum("bnk,bnkd->bnd", att, f_k)

        # ---- 7-way interaction attention ----
        combos = torch.stack([f_emb, p_item, p_biz, f_emb * p_item, f_emb * p_biz,
                              p_item * p_biz, f_emb * p_item * p_biz], dim=2)
        d = combos.shape[-1]
        flat = combos.reshape(b * n_pk, 7, d)
        uq2 = u_emb[:, None, :].expand(b, n_pk, d).reshape(b * n_pk, d)
        pack_vec, _ = self.pack_attn(uq2, flat, flat.new_ones(b * n_pk, 7))
        pack_vec = pack_vec.reshape(b, n_pk, d)

        u_max_pack = user_packages.shape[1]
        nb = pack_neighbors_b.shape[1]
        tar = pack_vec[:, 0]
        u_packs = pack_vec[:, 1:1 + u_max_pack]
        pb_packs = pack_vec[:, 1 + u_max_pack:1 + u_max_pack + nb]
        pf_packs = pack_vec[:, 1 + u_max_pack + nb:]
        pack_emb = (tar + self.biz_gate(tar, pb_packs, _pack_mask(pack_neighbors_b))
                    + self.friend_gate(tar, pf_packs, _pack_mask(pack_neighbors_f)))
        u_final = u_emb + self.user_gate(u_emb, u_packs, _pack_mask(user_packages))

        h = torch.cat([u_final, pack_emb, u_final * pack_emb], dim=-1)
        h = torch.relu(self.dnn_1(torch.relu(self.dnn_0(h))))
        return self.dnn_out(h)[:, 0]


@register_model("rank.iprec")
class ModelDef(LogitModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.num_users = int(h("num_users", 554237))
        self.num_items = int(h("num_items", 344087))
        self.num_bizs = int(h("num_bizs", 166465))
        self.f_max_len = int(h("f_max_len", 20))
        self.u_max_i = int(h("u_max_i", 99))
        self.u_max_f = int(h("u_max_f", 220))
        self.u_max_pack = int(h("u_max_pack", 50))
        self.pack_max_nei_b = int(h("pack_max_nei_b", 20))
        self.pack_max_nei_f = int(h("pack_max_nei_f", 20))
        self.hidden = int(h("hidden_units", 64))
        self.k = int(h("k", 4))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return IPRecNet(self.num_users, self.num_items, self.num_bizs, self.hidden,
                        self.f_max_len, self.k, device=device, generator=generator)

    def model_inputs(self, batch):
        return (
            batch["user"], batch["item"], batch["biz"], batch["friends"],
            batch["user_items"], batch["user_bizs"], batch["user_friends"],
            batch["user_packages"], batch["pack_neighbors_b"],
            batch["pack_neighbors_f"],
        )

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)

        def ids(hi, *shape):
            return rng.randint(0, hi, shape).astype(np.int64)

        def packages(n):
            # package layout: [item_id, biz_id, friend ids...]
            return np.concatenate([
                ids(self.num_items, batch_size, n, 1),
                ids(self.num_bizs, batch_size, n, 1),
                ids(self.num_users, batch_size, n, self.f_max_len),
            ], axis=-1)

        return {
            "user": ids(self.num_users, batch_size),
            "item": ids(self.num_items, batch_size),
            "biz": ids(self.num_bizs, batch_size),
            "friends": ids(self.num_users, batch_size, self.f_max_len),
            "user_items": ids(self.num_items, batch_size, self.u_max_i),
            "user_bizs": ids(self.num_bizs, batch_size, self.u_max_i),
            "user_friends": ids(self.num_users, batch_size, self.u_max_f),
            "user_packages": packages(self.u_max_pack),
            "pack_neighbors_b": packages(self.pack_max_nei_b),
            "pack_neighbors_f": packages(self.pack_max_nei_f),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return IPRECDataset(self, list_data_files(data_dir), batch_size)


class IPRECDataset:
    """JSON-lines reader: each line is an object whose values, in order, are
    user, item, biz, friends, user_items, user_bizs, user_friends,
    user_packages, pack_neighbors_b, pack_neighbors_f, label1, label2.
    Ragged lists are padded/truncated to the config maxima; package lists
    flatten to rows of ``[item, biz, friends...]`` (f_max_len + 2 wide).
    Lines that do not parse are skipped; the tail batch keeps its size."""

    def __init__(self, md, files, batch_size):
        self.md = md
        self.files = list(files)
        self.batch_size = batch_size

    @staticmethod
    def _pad1(x, length):
        x = list(x)[:length]
        return x + [0] * (length - len(x))

    def _packs(self, flat, length):
        w = self.md.f_max_len + 2
        arr = np.asarray(list(flat) + [0] * (-len(flat) % w),
                         np.int64).reshape(-1, w)[:length]
        out = np.zeros((length, w), np.int64)
        out[: len(arr)] = arr
        return out

    def _row(self, data):
        md = self.md
        (user, item, biz, friends, u_items, u_bizs, u_friends, u_packs,
         nei_b, nei_f, label1, *_rest) = list(data.values())
        return {
            "user": np.int64(user % md.num_users),
            "item": np.int64(item % md.num_items),
            "biz": np.int64(biz % md.num_bizs),
            "friends": np.asarray(self._pad1(friends, md.f_max_len), np.int64),
            "user_items": np.asarray(self._pad1(u_items, md.u_max_i), np.int64),
            "user_bizs": np.asarray(self._pad1(u_bizs, md.u_max_i), np.int64),
            "user_friends": np.asarray(self._pad1(u_friends, md.u_max_f), np.int64),
            "user_packages": self._packs(u_packs, md.u_max_pack),
            "pack_neighbors_b": self._packs(nei_b, md.pack_max_nei_b),
            "pack_neighbors_f": self._packs(nei_f, md.pack_max_nei_f),
            "label": np.float32(label1),
        }

    def __iter__(self):
        buf = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        buf.append(self._row(json.loads(line)))
                    except (ValueError, TypeError):
                        continue
                    if len(buf) == self.batch_size:
                        yield self._batch(buf)
                        buf = []
        if buf:
            yield self._batch(buf)

    @staticmethod
    def _batch(rows):
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        out["mask"] = np.ones(len(rows), np.float32)
        return out
