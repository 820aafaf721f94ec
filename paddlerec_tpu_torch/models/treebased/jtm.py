"""JTM: joint tree-model learning (the TDM successor).

Counterpart of ``paddlerec_tpu/models/treebased/jtm.py``.  Parity target of
the original: reference models/treebased/jtm/{tree_learning.py,
user_preference.py} — alternating optimization:

  1. train the TDM preference model under the CURRENT tree;
  2. re-learn the tree (Algorithm 2): items descend the tree ``gap``
     levels at a time; at each stage every item is assigned to the
     candidate descendant maximizing its user-preference weight
     (sum of the model's path probabilities over the item's user-sample
     histories, user_preference.py:36-50), subject to the subtree
     capacity (its leaf-slot count: 2^(l_max - l) when the tree is
     complete, fewer on the ragged last level) with the rebalance rule
     (tree_learning.py:175-217: keep originally-assigned, then highest
     weight; displaced items fall to their next-best candidate);
  3. repeat.

The assignment (``descendants_at`` … ``collect_sample_sets``) is a copy of
the JAX package's numpy code: given one weight function both give the same
tree.  ``model_weight_fn`` scores on the module's device under
``torch.no_grad`` in chunks of a fixed shape, as the JAX scorer does (one
K1 launch a chunk at N = item_chunk·max_samples·(S + code_chunk));
``jtm_train`` runs over the port's ``Trainer``.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddlerec_tpu_torch.models.treebased.tree import TreeIndex

WeightFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def _ancestor_at(code: int, level: int, branch: int, code_level: int) -> int:
    for _ in range(code_level - level):
        code = (code - 1) // branch
    return code


def _level_of(code: int, branch: int) -> int:
    lv = 0
    while code > 0:
        code = (code - 1) // branch
        lv += 1
    return lv


def descendants_at(tree: TreeIndex, ni: int, level: int) -> np.ndarray:
    """Codes at ``level`` whose ancestor at level(ni) is ni (only nodes
    that exist in the tree's level set)."""
    ni_level = _level_of(ni, tree.branch)
    cands = tree.level_codes[level]
    anc = cands.copy()
    for _ in range(level - ni_level):
        anc = (anc - 1) // tree.branch
    return cands[anc == ni]


def path_codes(code: int, ni: int, branch: int) -> List[int]:
    """Codes from ``code`` up to (excluding) ``ni`` — the reference's
    get_travel_path used for the path-sum weight."""
    out = []
    while code != ni and code > 0:
        out.append(code)
        code = (code - 1) // branch
    return out


def stage_capacities(tree: TreeIndex, l: int) -> Dict[int, int]:
    """Per-node capacity at level ``l``: the number of leaf codes in the
    node's subtree.  Equals the reference's 2^(l_max - l) exactly when
    the tree is complete; for item counts that are not a power of
    ``branch`` the last level is ragged and the flat formula overfills
    subtrees that physically have fewer leaf slots."""
    leaves = tree.level_codes[tree.max_level]
    anc = leaves.copy()
    for _ in range(tree.max_level - l):
        anc = (anc - 1) // tree.branch
    uniq, cnt = np.unique(anc, return_counts=True)
    return {int(c): int(k) for c, k in zip(uniq, cnt)}


def assign_parent(
    tree: TreeIndex,
    l_max: int,
    l: int,
    ni: int,
    items: Sequence[int],
    weight_fn: WeightFn,
    origin_level_codes: Dict[int, int],
    caps: Optional[Dict[int, int]] = None,
) -> Dict[int, int]:
    """One (ni, level-l) assignment round with capacity rebalancing
    (reference assign_parent, tree_learning.py:125-227)."""
    cands = descendants_at(tree, ni, l)
    if len(cands) == 0:
        return {}
    if caps is None:
        caps = stage_capacities(tree, l)
    items = list(items)
    # path-sum weights: W[i, c] = sum over path(c→ni) of the item's
    # preference for the path node
    paths = [path_codes(int(c), ni, tree.branch) for c in cands]
    plen = max(len(p) for p in paths)
    flat_nodes = []
    for p in paths:
        flat_nodes.extend(p + [0] * (plen - len(p)))
    node_mat = np.asarray(flat_nodes, np.int64).reshape(len(cands), plen)
    raw = weight_fn(np.asarray(items, np.int64), node_mat.reshape(-1))
    raw = raw.reshape(len(items), len(cands), plen)
    pad_mask = np.asarray(
        [[1.0] * len(p) + [0.0] * (plen - len(p)) for p in paths],
        np.float32,
    )
    W = (raw * pad_mask[None]).sum(-1)  # (items, cands)

    order = np.argsort(-W, axis=1)  # per item: candidate ranks
    cap_of = {int(c): caps.get(int(c), 0) for c in cands}
    # greedy first choice
    assign: Dict[int, list] = defaultdict(list)
    for i, it in enumerate(items):
        assign[int(cands[order[i, 0]])].append((it, 0, i))
    processed = set()
    while True:
        over_node, over_amt = None, 0
        for node, members in assign.items():
            if node in processed:
                continue
            amt = len(members) - cap_of[node]
            if amt > over_amt:
                over_node, over_amt = node, amt
        if over_node is None:
            break
        processed.add(over_node)
        members = assign[over_node]
        cap = cap_of[over_node]
        # keep originally-assigned items first, then highest weight
        members.sort(key=lambda e: (
            int(over_node != origin_level_codes.get(e[0], -1)),
            -W[e[2], order[e[2], e[1]]],
        ))
        for it, rank, i in members[cap:]:
            r = rank + 1
            placed = False
            while r < len(cands):
                nxt = int(cands[order[i, r]])
                if nxt in processed or cap_of[nxt] == 0:
                    r += 1
                    continue
                assign[nxt].append((it, r, i))
                placed = True
                break
            if not placed:
                # impossible when |items| <= sum of the candidates'
                # leaf capacities (the old tree's leaves guarantee it);
                # a custom pi that overfills the subtree would
                # otherwise surface later as an opaque KeyError
                raise ValueError(
                    f"JTM rebalance cannot place item {it}: all "
                    f"{len(cands)} level-{l} descendants of node {ni} "
                    f"are at capacity"
                )
        del members[cap:]
    out = {}
    for node, members in assign.items():
        assert len(members) <= cap_of[node]
        for it, _, _ in members:
            assert it not in out
            out[it] = node
    return out


def tree_learning(
    tree: TreeIndex,
    weight_fn: WeightFn,
    gap: int = 7,
) -> TreeIndex:
    """Algorithm 2 (tree_learning.py:230-247): re-assign every item to a
    leaf, descending ``gap`` levels per stage; returns the NEW tree."""
    l_max = tree.max_level
    branch = tree.branch
    d = min(gap, l_max)
    l = d
    items = [int(i) for i in tree.item_ids]
    pi: Dict[int, int] = {it: 0 for it in items}  # all under the root
    leaf_code = {int(i): int(c)
                 for i, c in zip(tree.item_ids, tree.codes)}
    while True:
        groups: Dict[int, list] = defaultdict(list)
        for it, code in pi.items():
            groups[code].append(it)
        origin = {
            it: _ancestor_at(leaf_code[it], l, branch, l_max)
            for it in items
        }
        caps = stage_capacities(tree, l)
        new_pi: Dict[int, int] = {}
        for ni, C_ni in groups.items():
            new_pi.update(
                assign_parent(tree, l_max, l, ni, C_ni, weight_fn, origin,
                              caps=caps)
            )
        pi = new_pi
        if l >= l_max:
            break
        d = min(d, l_max - l)
        l = l + d
    codes = np.asarray([pi[it] for it in items], np.int64)
    return TreeIndex(np.asarray(items, np.int64), codes, branch)


# ---------------------------------------------------------------------------
# Model-driven weights + the alternating JTM loop
# ---------------------------------------------------------------------------

def collect_sample_sets(
    dataset, max_samples: int
) -> Dict[int, np.ndarray]:
    """item → up to ``max_samples`` user histories (hist_ids, padded) —
    the reference's samples_<item>.json directory (get_sample_set)."""
    sets: Dict[int, list] = defaultdict(list)
    for batch in dataset:
        hist = np.asarray(batch["hist_ids"])
        items = np.asarray(batch["item_id"]).reshape(-1)
        for r in range(len(items)):
            bucket = sets[int(items[r])]
            if len(bucket) < max_samples:
                bucket.append(hist[r])
    return {
        k: np.asarray(v)[:max_samples] for k, v in sets.items() if v
    }


def model_weight_fn(
    module,
    sample_sets: Dict[int, np.ndarray],
    max_samples: int = 4,
    code_chunk: int = 256,
    item_chunk: int = 256,
) -> WeightFn:
    """Preference weight via the trained TDM net ``module`` (on its own
    device): w(item, node) = Σ_samples p(positive | user history, node)
    (user_preference.py calc_prediction_weight).

    Items and codes are padded to fixed chunks, as the JAX scorer pads them
    (there to keep one compiled shape): every chunk is one forward of one
    shape (item_chunk·max_samples histories against code_chunk codes), one
    K1 launch, and one copy of its (item_chunk, code_chunk) weights to the
    host.  Padded items have no sample and padded codes are cut off, so the
    weights are those of the real rows alone.  Eager PyTorch needs no fixed
    shape; it is kept so that every scorer launch is the one K1 shape that
    ``chip_smoke.py`` checks, times and counts launches at.  The price is
    scoring the padding: a late stage's group of 8 items fills 8 of a
    chunk's 256 rows."""
    device = next(module.parameters()).device
    seq_len = next(iter(sample_sets.values())).shape[1] if sample_sets else 1

    def scores(hist, mask, codes):
        # hist (I, S, L); codes (M,) → (I, S, M) positive probabilities
        i, s, l = hist.shape
        logits = module(hist.reshape(i * s, l), mask.reshape(i * s, l),
                        codes[None].expand(i * s, -1))
        return torch.softmax(logits, -1)[..., 1].reshape(i, s, -1)

    @torch.no_grad()
    def fn(items: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        items = np.asarray(items, np.int64).reshape(-1)
        out = np.zeros((len(items), len(nodes)), np.float32)
        m_pad = -(-len(nodes) // code_chunk) * code_chunk
        codes_p = np.zeros(m_pad, np.int64)
        codes_p[: len(nodes)] = nodes
        codes_p = torch.from_numpy(codes_p).to(device)
        for i0 in range(0, len(items), item_chunk):
            sel = items[i0 : i0 + item_chunk]
            hist = np.zeros((item_chunk, max_samples, seq_len), np.int64)
            mask = np.zeros((item_chunk, max_samples, seq_len), np.float32)
            smask = np.zeros((item_chunk, max_samples), np.float32)
            for j, it in enumerate(sel):
                hists = sample_sets.get(int(it))
                if hists is None:
                    continue
                hist[j, : len(hists)] = hists
                mask[j, : len(hists)] = (hists > 0).astype(np.float32)
                smask[j, : len(hists)] = 1.0
            hist, mask, smask = (torch.from_numpy(a).to(device) for a in (hist, mask, smask))
            for c0 in range(0, m_pad, code_chunk):
                s = scores(hist, mask, codes_p[c0 : c0 + code_chunk])
                w = (s * smask[:, :, None]).sum(1).cpu().numpy()
                take = min(code_chunk, len(nodes) - c0)
                out[i0 : i0 + len(sel), c0 : c0 + take] = w[: len(sel), :take]
        return out

    return fn


def jtm_train(config, rounds: Optional[int] = None, device=None):
    """The alternating JTM loop: train TDM under the current tree →
    re-learn the tree from the trained model → repeat.  ``device`` as the
    port's trainer takes it (``None``: the card).

    Config: a treebased.tdm config plus
        runner.jtm_rounds (default 2)
        hyper_parameters.jtm_gap (default 7)
        hyper_parameters.jtm_sample_nums (default 4)

    Returns (the last round's training metrics, the last re-learned tree).
    """
    from paddlerec_tpu_torch.core.config import resolve_path
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    rounds = int(rounds if rounds is not None
                 else config.runner("jtm_rounds", 2))
    gap = int(config.hyper("jtm_gap", 7))
    sample_nums = int(config.hyper("jtm_sample_nums", 4))
    trainer = Trainer(config, device=device)
    md = trainer.model_def
    assert md.tree is not None, "JTM needs hyper_parameters.tree_path"
    metrics = {}
    for r in range(rounds):
        metrics = trainer.train()
        logger.info(f"[jtm round {r}] model trained: {metrics}")
        data_dir = resolve_path(config, "runner.train_data_dir")
        dataset = md.make_dataset(
            data_dir, int(config.runner("train_batch_size", 32))
        )
        samples = collect_sample_sets(dataset, sample_nums)
        wfn = model_weight_fn(trainer.state.module, samples, sample_nums)
        new_tree = tree_learning(md.tree, wfn, gap=gap)
        md.set_tree(new_tree)
        save_path = resolve_path(config, "runner.model_save_path")
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            new_tree.save(os.path.join(save_path, f"jtm_tree_round{r}"))
        logger.info(
            f"[jtm round {r}] tree re-learned: depth {new_tree.max_level}, "
            f"{len(new_tree.item_ids)} items"
        )
        # the node-id table keeps its size (total_nodes is unchanged for
        # a same-depth tree), so training continues with updated codes
    return metrics, md.tree
