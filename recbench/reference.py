"""The plain reference: the training steps and the scores that the timed
path has to reproduce, in float32 with TF32 off, from the benchmark's own
inputs and weights (``traffic.py``, ``weights.py``) and nothing the program
made.  It imports nothing of the port.

The table is the packed layout the configuration states: logical row ``i``
(``i = id % vocab``) is lanes ``[(i % pack)·w, (i % pack)·w + E')`` of
physical row ``i // pack``, ``w`` the smallest of 8…128 lanes holding the
model's ``E'`` lanes and ``pack = 128 / w``.  The reference holds only the
physical rows its batches touch, in float32.

A training step (``recipe``: the one recipe implemented here; any other
optimizer or row rule the configuration names raises): the model's forward
on the looked-up vectors, the mean binary cross-entropy, its gradients;
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on the dense leaves;
row-wise adagrad on the table: the gradient summed per physical row ``G``,
``acc += mean over 128 lanes of G²``, ``row -= lr·G / sqrt(acc + 1e-8)``.
A bfloat16 table's rows stay in float32 here; the program's stochastic
rounding is held to keeping steps under half a place alive
(``small_step_gap``), from the program's rows before and after one step and
this step in float32.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from recbench import weights

TABLE = "embedding.embedding"
TABLE_STDDEV = 0.01


def dtype_of(hp) -> torch.dtype:
    return torch.bfloat16 if str(hp["sparse_feature_dtype"]).lower() in (
        "bfloat16", "bf16") else torch.float32


def layout(vocab: int, logical: int):
    """(physical rows, lanes a logical row, logical rows a physical row)."""
    width = next(w for w in (8, 16, 32, 64, 128) if logical <= w)
    pack = 128 // width
    return -(-vocab // pack), width, pack


def table_leaf(model, hp):
    rows, _, _ = layout(int(hp["sparse_feature_number"]), model.logical_dim(hp))
    return (TABLE, (rows, 128), dtype_of(hp), ("normal", TABLE_STDDEV))


def all_leaves(model, hp):
    return [table_leaf(model, hp)] + list(model.leaves(hp))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _Rows:
    """The physical rows a set of batches touches, and each batch's map
    onto them."""

    def __init__(self, model, hp, batches, device):
        vocab = int(hp["sparse_feature_number"])
        self.logical = model.logical_dim(hp)
        _, self.width, self.pack = layout(vocab, self.logical)
        hashed = [torch.as_tensor(b["sparse"], device=device).long() % vocab for b in batches]
        self.uniq = torch.unique(torch.cat([h.reshape(-1) for h in hashed]) // self.pack)
        self.pos = [torch.searchsorted(self.uniq, h // self.pack) for h in hashed]
        self.sub = [h % self.pack for h in hashed]

    def lookup(self, table: torch.Tensor, k: int) -> torch.Tensor:
        view = table.view(-1, self.pack, self.width)
        return view[self.pos[k], self.sub[k], :self.logical]

    def row_grad(self, gvec: torch.Tensor, k: int) -> torch.Tensor:
        """(U, 128) per-row sums of the (B, S, E') vector gradients."""
        g = torch.zeros((self.uniq.shape[0] * self.pack, self.width),
                        dtype=torch.float32, device=gvec.device)
        flat = F.pad(gvec.reshape(-1, self.logical), (0, self.width - self.logical))
        g.index_add_(0, (self.pos[k] * self.pack + self.sub[k]).reshape(-1), flat)
        return g.view(-1, 128)


ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}
ROW_EPS = 1e-8


def recipe(hp) -> Dict[str, float]:
    """The training recipe the reference implements, read from the
    configuration; anything else it names raises."""
    opt = dict(hp.get("optimizer") or {})
    if str(opt.pop("class", "")).lower() != "adam" or set(opt) != {"learning_rate"}:
        raise ValueError(f"the reference implements Adam with a learning_rate only, "
                         f"not {hp.get('optimizer')!r}")
    if not hp.get("sparse_update") or str(hp.get("sparse_update_rule")).lower() != "adagrad":
        raise ValueError("the reference implements the row-wise adagrad sparse update only, "
                         f"not sparse_update={hp.get('sparse_update')!r} "
                         f"rule={hp.get('sparse_update_rule')!r}")
    stochastic = bool(hp.get("sparse_update_stochastic_round", False))
    if stochastic != (dtype_of(hp) == torch.bfloat16):
        raise ValueError("the reference implements a bfloat16 table with stochastic rounding "
                         "or a float32 table without it")
    return {"lr": float(opt["learning_rate"]), **ADAM, "stochastic": stochastic}


def _tensors(batch, device, half: bool):
    n = len(batch["label"])
    rows = slice(0, n // 2 if half else n)
    return {k: torch.as_tensor(np.asarray(v)[rows], device=device) for k, v in batch.items()}


def train_readings(model, config, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                   checked: int, device, start: Optional[Dict] = None, tf32: bool = False,
                   half: bool = False, end_state: bool = False) -> Dict:
    """Follow training steps on ``batches`` (in the order the program took
    them) from the benchmark's weights, or from ``start``: a state before
    the first of them in the form ``end_state`` returns (the dense leaves,
    their Adam moments and step count; the table's physical rows the steps
    touch, ascending, their float32 values and accumulator).  Returns every
    step's loss; every leaf's gradient norm at the first step; every leaf's
    change norm over the first ``checked`` steps; the first step's table
    update, ``row_step``: its physical rows (ascending) and their float32
    step; the table's change itself, ``table_change`` (rows, change).
    ``tf32`` (the control) runs the products in TF32; ``half`` (a
    fault) steps on the first half of each batch."""
    hp = config["hyper_parameters"]
    rc = recipe(hp)
    lr, b1, b2, eps = rc["lr"], rc["b1"], rc["b2"], rc["eps"]
    with matmul_precision(tf32):
        batches = [_tensors(b, device, half) for b in batches]
        rows = _Rows(model, hp, batches, device)
        if start is None:
            name, shape, dtype, init = table_leaf(model, hp)
            table = weights.table_rows(name, shape, dtype, init, seed, rows.uniq)
            acc = torch.zeros(table.shape[0], dtype=torch.float32, device=device)
            p_start = {n: weights.make(n, s, d, i, seed, device) for n, s, d, i in model.leaves(hp)}
            m = {n: torch.zeros_like(v) for n, v in p_start.items()}
            v2 = {n: torch.zeros_like(v) for n, v in p_start.items()}
            count = 0
        else:
            at = torch.searchsorted(start["rows"].to(device), rows.uniq)
            if not torch.equal(start["rows"].to(device)[at.clamp(max=len(start["rows"]) - 1)],
                               rows.uniq):
                raise ValueError("the start state lacks rows the steps touch")
            table = start["table"].to(device)[at].float()
            acc = start["acc"].to(device)[at].float()
            p_start = {n: t.to(device).float() for n, t in start["params"].items()}
            m = {n: t.to(device).float().clone() for n, t in start["m"].items()}
            v2 = {n: t.to(device).float().clone() for n, t in start["v"].items()}
            count = int(start["count"])
        params = {n: v.clone().requires_grad_() for n, v in p_start.items()}
        table0 = table.clone()
        losses, grad, change, row_step = [], {}, {}, None
        for k, t in enumerate(batches):
            vecs = rows.lookup(table, k).detach().requires_grad_()
            logits = model.forward(params, vecs, t["dense"], hp)
            loss = F.binary_cross_entropy_with_logits(logits, t["label"])
            gs = torch.autograd.grad(loss, list(params.values()) + [vecs])
            losses.append(float(loss.detach()))
            g_rows = rows.row_grad(gs[-1], k)
            if k == 0:
                grad = {n: float(torch.linalg.vector_norm(g.double()))
                        for n, g in zip(params, gs)}
                grad[TABLE] = float(torch.linalg.vector_norm(g_rows.double()))
            with torch.no_grad():
                c1, c2 = 1.0 - b1 ** (count + k + 1), 1.0 - b2 ** (count + k + 1)
                for (n, p), g in zip(params.items(), gs):
                    m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    v2[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    p.sub_(lr * (m[n] / c1) / (torch.sqrt(v2[n] / c2) + eps))
                touched = torch.unique(rows.pos[k])
                g_t = g_rows[touched]
                acc[touched] += (g_t * g_t).mean(dim=1)
                step = -lr * g_t * torch.rsqrt(acc[touched] + ROW_EPS)[:, None]
                table[touched] += step
                if k == 0:
                    row_step = (rows.uniq[touched], step)
            if k == checked - 1:
                change = {n: float(torch.linalg.vector_norm((p.detach() - p_start[n]).double()))
                          for n, p in params.items()}
                change[TABLE] = float(torch.linalg.vector_norm((table - table0).double()))
                table_change = (rows.uniq, table - table0)
        out = {"losses": losses, "grad": grad, "change": change, "row_step": row_step,
               "table_change": table_change}
        if end_state:
            out["state"] = {"count": count + len(batches), "rows": rows.uniq, "table": table,
                            "acc": acc, "params": {n: p.detach() for n, p in params.items()},
                            "m": m, "v": v2}
    return out


def small_step_gap(before: torch.Tensor, after: torch.Tensor, step: torch.Tensor) -> float:
    """Whether the program's bfloat16 rounding keeps the steps under half a
    place alive, as unbiased stochastic rounding does.  Over the lanes whose
    reference step (float32) is under half the spacing of bfloat16 at the
    program's row value before the step: a lane moves to the next value
    with the probability |step| / spacing, so the lanes seen to move are,
    in expectation, Σ |step| / spacing.  The number is |1 − moved ÷
    expected|: about 0 for stochastic rounding, 1 for rounding to nearest
    (no such step moves) and for truncation (every step toward zero moves,
    none away from it).  Values at a power of two, whose spacing differs
    below and above, are left out."""
    b = before.float()
    mantissa, exponent = torch.frexp(b)
    spacing = torch.ldexp(torch.ones_like(b), exponent - 8)
    small = (step != 0) & (mantissa.abs() != 0.5) & (step.abs() < 0.5 * spacing)
    expected = float(torch.sum((step.abs() / spacing)[small].double()))
    moved = float(torch.sum((after.float() != b)[small].double()))
    return abs(1.0 - moved / expected) if expected > 0 else math.inf


def projection_gap(prog_change, ref_change) -> float:
    """|1 − ⟨Δp, Δr⟩ / ‖Δr‖²|: the program's change of the table's rows
    against the reference's, along the reference's.  Rounding that is
    unbiased adds noise across that direction, which a norm would count and
    this does not."""
    p_rows, p_d = prog_change
    r_rows, r_d = ref_change
    at = torch.searchsorted(r_rows.cpu(), p_rows.cpu()).clamp(max=len(r_rows) - 1)
    if not torch.equal(r_rows.cpu()[at], p_rows.cpu()):
        return math.inf
    r_d = r_d.double().cpu()
    denom = float(torch.sum(r_d * r_d))
    return abs(1.0 - float(torch.sum(p_d.double() * r_d[at])) / max(denom, 1e-300))


def compare_train(prog: Dict, ref: Dict, prefix: str = "", table_grad: bool = True,
                  table_projection: bool = False) -> Dict[str, float]:
    """The numbers of a span of training steps, each against the reference:
    the worst step's relative loss gap; the worst leaf's gap of gradient
    norms at the span's first step (without the table where ``table_grad``
    is false); the worst leaf's gap of change norms over its checked steps,
    each leaf's gap over the larger of its own reference norm and the
    median leaf's, the table's by ``projection_gap`` where
    ``table_projection``.  The change leaves out leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding: Adam moves them by noise).  Named with ``prefix``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    g_med = max(statistics.median(ref["grad"].values()), 1e-30)
    grad_gap = max(abs(prog["grad"][n] - r) / max(r, g_med) for n, r in ref["grad"].items()
                   if table_grad or n != TABLE)
    counted = [n for n, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = max(statistics.median(ref["change"][n] for n in counted), 1e-30)
    gaps = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
            for n in counted}
    if table_projection and TABLE in gaps:
        gaps[TABLE] = projection_gap(prog["table_change"], ref["table_change"])
    return {prefix + "loss_gap": loss_gap, prefix + "grad_gap": grad_gap,
            prefix + "change_gap": max(gaps.values())}


def predictions(model, config, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                device, tf32: bool = False) -> List[np.ndarray]:
    """The scores (sigmoid of the logits) of each batch under the
    benchmark's weights."""
    hp = config["hyper_parameters"]
    out = []
    with torch.no_grad(), matmul_precision(tf32):
        rows = _Rows(model, hp, batches, device)
        name, shape, dtype, init = table_leaf(model, hp)
        table = weights.table_rows(name, shape, dtype, init, seed, rows.uniq)
        params = {n: weights.make(n, s, d, i, seed, device) for n, s, d, i in model.leaves(hp)}
        for k, batch in enumerate(batches):
            dense = torch.as_tensor(batch["dense"], device=device)
            logits = model.forward(params, rows.lookup(table, k), dense, hp)
            out.append(torch.sigmoid(logits).cpu().numpy())
    return out


def compare_scores(prog: Sequence[np.ndarray], ref: Sequence[np.ndarray]) -> Dict[str, float]:
    """The widest gap of a score from the reference's, over every row kept."""
    gap = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape or not np.all(np.isfinite(p)):
            return {"score_gap": float("inf")}
        gap = max(gap, float(np.max(np.abs(p.astype(np.float64) - r))))
    if len(prog) != len(ref):
        gap = float("inf")
    return {"score_gap": gap}
