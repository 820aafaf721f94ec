"""Streaming metrics: histogram-bucket AUC + the full CTR bundle, and the
streaming accuracy of the classification models.

Counterpart of ``paddlerec_tpu/core/metrics.py`` (the AUC and accuracy
families, and the ranking metrics of the match and recall models):

  * AUC from 2^12 threshold buckets of positive/negative counts (reverse
    trapezoid sweep over buckets).  Buckets are plain int32 tensors, so a
    distributed reduction is one all-reduce and gives the exact global AUC.
  * CTR bundle — bucket_error / MAE / RMSE / actual CTR / predicted CTR /
    COPC / mean Q.

``update_auc_state`` runs on the device inside the train step, in eager mode
and without a host synchronisation; it updates the state's tensors in place
and returns the state.  The float sums carry Kahan compensation terms
("*_c"), kept exactly as the reference's ``_kahan_add``: do not compile this
function, a compiler may simplify the compensation away.  The host-side
functions (``auc_from_buckets``, ``bucket_error``, ``compute_metrics``,
``metrics_str``) are numpy copies of the reference's.

The accuracy state (``init_acc_state``, ``update_acc_state``,
``compute_acc``) is two float32 scalars, ``correct`` and ``total``, as the
reference keeps them: sums of 0/1 flags, exact up to 2^24 examples.

The ranking metrics (``positive_order_ratio``, ``hit_ratio_at_k``,
``ndcg_at_k``, ``recall_at_k``) are host-side numpy copies of the
reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

NUM_BUCKETS = 2 ** 12

MetricState = Dict[str, torch.Tensor]

_KAHAN_SUMS = ("sqrerr", "abserr", "prob", "q", "pos_ins", "total_ins")


def init_auc_state(num_buckets: int = NUM_BUCKETS, device=None) -> MetricState:
    # counts are int32 (exact to 2^31; float32 counters stop incrementing
    # at 2^24); the float sums and the instance counters are Kahan-
    # compensated float32 pairs (total, comp)
    state = {
        "stat_pos": torch.zeros((num_buckets,), dtype=torch.int32, device=device),
        "stat_neg": torch.zeros((num_buckets,), dtype=torch.int32, device=device),
    }
    for name in _KAHAN_SUMS:
        state[name] = torch.zeros((), dtype=torch.float32, device=device)
        state[name + "_c"] = torch.zeros((), dtype=torch.float32, device=device)
    return state


def _kahan_add(state: MetricState, name: str, x: torch.Tensor) -> None:
    """Compensated add of ``x`` into the pair (name, name + "_c")."""
    total, comp = state[name], state[name + "_c"]
    y = x - comp
    t = total + y
    state[name + "_c"] = (t - total) - y
    state[name] = t


@torch.no_grad()
def update_auc_state(
    state: MetricState,
    preds: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> MetricState:
    """Accumulate a batch of (pred, label) pairs into the bucket histograms.

    preds: (B,) probabilities in [0, 1]; labels: (B,) in {0, 1};
    mask: optional (B,) {0,1} validity mask for padded batches.
    """
    num_buckets = state["stat_pos"].shape[0]
    preds = preds.reshape(-1).to(torch.float32)
    labels = labels.reshape(-1).to(torch.float32)
    if mask is None:
        mask = torch.ones_like(preds)
    else:
        mask = mask.reshape(-1).to(torch.float32)

    bucket = (preds * num_buckets).to(torch.int32).clamp_(0, num_buckets - 1).long()
    pos_w = labels * mask
    neg_w = (1.0 - labels) * mask
    pos_i = torch.round(pos_w).to(torch.int32)  # half to even, as jnp.round
    neg_i = torch.round(neg_w).to(torch.int32)
    state["stat_pos"].index_add_(0, bucket, pos_i)
    state["stat_neg"].index_add_(0, bucket, neg_i)

    err = preds - labels
    q = torch.where(labels > 0.5, preds, 1.0 - preds)  # per-ins q value
    _kahan_add(state, "sqrerr", torch.sum(err * err * mask))
    _kahan_add(state, "abserr", torch.sum(torch.abs(err) * mask))
    _kahan_add(state, "prob", torch.sum(preds * mask))
    _kahan_add(state, "q", torch.sum(q * mask))
    _kahan_add(state, "pos_ins", torch.sum(pos_i).to(torch.float32))
    _kahan_add(state, "total_ins",
               torch.sum(torch.round(mask)).to(torch.float32))
    return state


def auc_from_buckets(stat_pos: np.ndarray, stat_neg: np.ndarray) -> float:
    """Exact reference AUC sweep (metric_helper.py:76-99), vectorized.

    Walk buckets from the highest threshold down; each bucket contributes a
    trapezoid of area (Δneg) * (pos_before + pos_after) / 2.
    """
    pos = np.asarray(stat_pos, dtype=np.float64).reshape(-1)[::-1]
    neg = np.asarray(stat_neg, dtype=np.float64).reshape(-1)[::-1]
    cum_pos = np.cumsum(pos)
    new_neg = np.cumsum(neg)
    old_pos = cum_pos - pos
    area = float(np.sum(neg * (old_pos + cum_pos) / 2.0))
    total_pos = float(cum_pos[-1]) if len(cum_pos) else 0.0
    total_neg = float(new_neg[-1]) if len(new_neg) else 0.0
    if total_pos * total_neg == 0 or (total_pos + total_neg) == 0:
        return 0.5
    return area / (total_pos * total_neg)


def bucket_error(stat_pos: np.ndarray, stat_neg: np.ndarray) -> float:
    """Calibration bucket error, matching metric_helper.py:193-235."""
    pos = np.asarray(stat_pos, dtype=np.float64).reshape(-1)
    neg = np.asarray(stat_neg, dtype=np.float64).reshape(-1)
    num_buckets = len(pos)
    k_max_span = 0.01
    k_relative_error_bound = 0.05
    last_ctr = -1.0
    impression_sum = ctr_sum = click_sum = 0.0
    error_sum = error_count = 0.0
    for i in range(num_buckets):
        click = pos[i]
        show = pos[i] + neg[i]
        ctr = float(i) / num_buckets
        if abs(ctr - last_ctr) > k_max_span:
            last_ctr = ctr
            impression_sum = ctr_sum = click_sum = 0.0
        impression_sum += show
        ctr_sum += ctr * show
        click_sum += click
        if impression_sum == 0:
            continue
        adjust_ctr = ctr_sum / impression_sum
        if adjust_ctr == 0:
            continue
        relative_error = math.sqrt((1 - adjust_ctr) / (adjust_ctr * impression_sum))
        if relative_error < k_relative_error_bound:
            actual_ctr = click_sum / impression_sum
            error_sum += abs(actual_ctr / adjust_ctr - 1) * impression_sum
            error_count += impression_sum
            last_ctr = -1
    return error_sum / error_count if error_count > 0 else 0.0


def compute_metrics(state: MetricState) -> Dict[str, float]:
    """Host-side metric bundle from an (already-reduced) state.

    Returns auc, bucket_error, mae, rmse, actual_ctr, predicted_ctr, copc,
    mean_q, total_ins — the reference's `get_global_metrics` output list.
    """
    host = {k: np.asarray(v.detach().cpu()) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in state.items()}
    # Kahan pairs: comp holds the rounding excess, true sum = total - comp
    total = float(host["total_ins"]) - float(host.get("total_ins_c", 0.0))
    pos_ins = float(host["pos_ins"]) - float(host.get("pos_ins_c", 0.0))
    out = {
        "auc": auc_from_buckets(host["stat_pos"], host["stat_neg"]),
        "bucket_error": bucket_error(host["stat_pos"], host["stat_neg"]),
        "total_ins": total,
    }
    if total > 0:
        out["mae"] = float(host["abserr"]) / total
        out["rmse"] = math.sqrt(float(host["sqrerr"]) / total)
        out["actual_ctr"] = pos_ins / total
        out["predicted_ctr"] = float(host["prob"]) / total
        out["mean_q"] = float(host["q"]) / total
        out["copc"] = (
            out["actual_ctr"] / out["predicted_ctr"]
            if abs(out["predicted_ctr"]) > 1e-6
            else 0.0
        )
    else:
        out.update(mae=0.0, rmse=0.0, actual_ctr=0.0, predicted_ctr=0.0,
                   mean_q=0.0, copc=0.0)
    return out


def metrics_str(metrics: Dict[str, float], prefix: str = "") -> str:
    """Format like metric_helper.get_global_metrics_str."""
    return (
        f"{prefix} AUC={metrics['auc']:.6f} "
        f"BUCKET_ERROR={metrics.get('bucket_error', 0.0):.6f} "
        f"MAE={metrics.get('mae', 0.0):.6f} RMSE={metrics.get('rmse', 0.0):.6f} "
        f"Actual_CTR={metrics.get('actual_ctr', 0.0):.6f} "
        f"Predicted_CTR={metrics.get('predicted_ctr', 0.0):.6f} "
        f"COPC={metrics.get('copc', 0.0):.6f} "
        f"MEAN Q_VALUE={metrics.get('mean_q', 0.0):.6f} "
        f"Ins number={int(metrics.get('total_ins', 0))}"
    )


# ---------------------------------------------------------------------------
# Streaming accuracy (classification models: bert4rec; dselect_k and maml in
# the JAX package)
# ---------------------------------------------------------------------------

def init_acc_state(device=None) -> MetricState:
    return {
        "correct": torch.zeros((), dtype=torch.float32, device=device),
        "total": torch.zeros((), dtype=torch.float32, device=device),
    }


@torch.no_grad()
def update_acc_state(state: MetricState, correct: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> MetricState:
    """Accumulate per-example correctness flags (floats in {0,1}), in place."""
    correct = correct.reshape(-1).to(torch.float32)
    mask = (torch.ones_like(correct) if mask is None
            else mask.reshape(-1).to(torch.float32))
    state["correct"] = state["correct"] + torch.sum(correct * mask)
    state["total"] = state["total"] + torch.sum(mask)
    return state


def compute_acc(state: MetricState) -> float:
    total = float(state["total"])
    return float(state["correct"]) / total if total > 0 else 0.0


# ---------------------------------------------------------------------------
# Ranking / recall metrics (the match and recall families), on the host
# ---------------------------------------------------------------------------

def positive_order_ratio(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """The positive-order ratio: the share of (pos, neg) pairs ranked
    correctly, ties counted as half (``tools/cal_pos_neg.py`` counts the
    same pairs per query)."""
    pos = np.asarray(pos_scores, dtype=np.float64).reshape(-1, 1)
    neg = np.asarray(neg_scores, dtype=np.float64).reshape(1, -1)
    if pos.size == 0 or neg.size == 0:
        return 0.0
    wins = np.sum(pos > neg) + 0.5 * np.sum(pos == neg)
    return float(wins) / (pos.size * neg.size)


def hit_ratio_at_k(ranks: np.ndarray, k: int) -> float:
    """HR@K given 1-based ranks of the true item (NCF's evaluation)."""
    ranks = np.asarray(ranks)
    return float(np.mean(ranks <= k)) if ranks.size else 0.0


def ndcg_at_k(ranks: np.ndarray, k: int) -> float:
    """NDCG@K with a single relevant item per list (NCF's evaluation)."""
    ranks = np.asarray(ranks, dtype=np.float64)
    if ranks.size == 0:
        return 0.0
    gains = np.where(ranks <= k, 1.0 / np.log2(ranks + 1.0), 0.0)
    return float(np.mean(gains))


def recall_at_k(hits: int, num_relevant: int) -> float:
    return hits / num_relevant if num_relevant else 0.0
