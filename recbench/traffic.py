"""The one traffic generator: rows of Criteo-shaped CTR data from a seed.

Keys: each slot draws a rank from a Zipf law over 1, 2, 3, ... and the rank
is hashed with its slot into ``[0, vocab)``: a skewed head, as in real click
logs, that a uniform draw (``data/synthetic.py``) would lose.  The traffic's
``zipf_alpha`` is one exponent for every slot, or ``"fit"``: each slot's
own exponent, the one under which a Zipf law over an unbounded vocabulary
shows, in the dataset's ``dataset_rows`` rows, the slot's published count
of distinct values (``slot_cardinalities``; where the dataset capped its
values modulo ``cardinality_cap``, the count of distinct residues).  That is
Heaps' law read backwards: the published counts fix each slot's skew.
Dense features: ``log(1 + count)`` of an exponential count of mean 20,
rounded to float16 resolution so that the compact wire format carries them
exactly.  Labels: a planted score (a per-id weight, as the repo's synthetic
data plants it, and the dense mean) through a logistic with the traffic's
``positive_share`` as its base rate, so the model has something to learn.

Every array is drawn on the given device from one ``torch.Generator`` seeded
from the run's seed and a stream name, in a few large calls: the same seed
gives the same rows.  ``write_slotbin`` writes the slotbin layout the
trainer's reader maps (magic ``SLOTBIN1``, a 64-byte header, then labels,
ids, dense features).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def mix64(*parts: int) -> int:
    """splitmix64 over the parts: a seed for a generator, below 2^63."""
    z = 0x6A09E667F3BCC909
    for p in parts:
        z = (z + (int(p) & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def stream_seed(seed: int, stream: str) -> int:
    return mix64(seed, *stream.encode())


_HEAD = 4096
_FAR = float(1 << 61)


def _zeta(alpha: float) -> float:
    """Σ_{r≥1} r^-alpha (Euler–Maclaurin after ``_HEAD`` terms), alpha > 1."""
    r = np.arange(1, _HEAD + 1, dtype=np.float64)
    return (float(np.sum(r ** -alpha)) + _HEAD ** (1.0 - alpha) / (alpha - 1.0)
            - 0.5 * _HEAD ** -alpha)


def distinct_values(alpha: float, rows: float) -> float:
    """The expected number of distinct ranks in ``rows`` draws of a Zipf
    law over 1, 2, 3, ...: Σ_r 1 − exp(−rows·p_r), exact over the first
    ``_HEAD`` ranks, the rest as an integral (in y = rows·p(x), on a log
    grid)."""
    z = _zeta(alpha)
    r = np.arange(1, _HEAD + 1, dtype=np.float64)
    head = float(np.sum(-np.expm1(-rows * r ** -alpha / z)))
    s = 1.0 / alpha
    top = math.log(rows * (_HEAD + 0.5) ** -alpha / z)
    t = np.linspace(top - 60.0, top, 2000)
    y = np.exp(t)
    f = -np.expm1(-y) * y ** -s
    integral = float(np.sum((f[1:] + f[:-1]) * np.diff(t))) / 2.0
    return head + s * (rows / z) ** s * integral


def fit_alpha(distinct: int, rows: int, cap: int = 0) -> float:
    """The Zipf exponent under which ``rows`` draws show ``distinct``
    values (distinct residues modulo ``cap``, when given), by bisection."""
    lo, hi = 1.0 + 1e-4, 40.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        v = distinct_values(mid, rows)
        if cap:
            v = cap * -math.expm1(-v / cap)
        lo, hi = (mid, hi) if v > distinct else (lo, mid)
    return 0.5 * (lo + hi)


def slot_alphas(config: Dict, traffic: Dict) -> List[float]:
    """Each slot's exponent: the traffic's one number, or each slot's fit."""
    cards = config["slot_cardinalities"]
    if traffic["zipf_alpha"] != "fit":
        return [float(traffic["zipf_alpha"])] * len(cards)
    rows, cap = int(config["dataset_rows"]), int(config.get("cardinality_cap", 0))
    return [fit_alpha(int(c), rows, cap) for c in cards]


def zipf_ranks(u: torch.Tensor, alphas: Sequence[float]) -> torch.Tensor:
    """Uniforms ``u`` (rows, S) in [0, 1) → int64 ranks ≥ 1 with
    P(r) ∝ r^-alpha_s: exact over the first ``_HEAD`` ranks (their own
    distribution function), the tail by inverting ∫ x^-alpha over
    ``[_HEAD + ½, ∞)`` and rounding (the midpoint rule, whose error
    vanishes with the rank); ranks stay below 2^62."""
    out = torch.empty(u.shape, dtype=torch.int64, device=u.device)
    w = torch.arange(1, _HEAD + 1, dtype=torch.float64, device=u.device)
    for s, alpha in enumerate(alphas):
        cdf = torch.cumsum(w ** -alpha, 0)
        a = alpha - 1.0
        lo = (_HEAD + 0.5) ** -a
        head_mass = float(cdf[-1])
        x = u[:, s] * (head_mass + lo / a)
        r = torch.searchsorted(cdf, x, right=True) + 1
        tail = x >= head_mass
        t = torch.clamp(lo - a * (x[tail] - head_mass), min=1e-300)
        big = torch.round(t ** (-1.0 / a))
        # past 2^61 every rank is as good as seen once: a distinct one
        # from the uniform's own bits rather than one shared cap
        far = _FAR + torch.floor(u[tail, s] * 2.0 ** 53)
        r[tail] = torch.where(big < _FAR, big, far).to(torch.int64)
        out[:, s] = r
    return out


def hash_ids(ranks: torch.Tensor, vocab: int) -> torch.Tensor:
    """(rows, S) ranks below 2^62 → int64 ids in [0, vocab): the rank's two
    31-bit halves and its slot mixed (no product leaves int64)."""
    slots = torch.arange(1, ranks.shape[1] + 1, dtype=torch.int64, device=ranks.device)
    lo, hi = ranks & 0x7FFFFFFF, ranks >> 31
    h = (lo * 2654435761) ^ (hi * 2246822519) ^ (slots * 0x9E3779B1)
    h = h ^ (h >> 29)
    return h % vocab


def generate(seed: int, stream: str, rows: int, config: Dict, traffic: Dict,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """``rows`` rows on ``device``: label (rows,) f32, sparse (rows, S)
    int32, dense (rows, D) f32."""
    hp = config["hyper_parameters"]
    cards = config["slot_cardinalities"]
    vocab = int(hp["sparse_feature_number"])
    dense_dim = int(hp["dense_input_dim"])
    if len(cards) != int(hp["sparse_inputs_slots"]) - 1:
        raise ValueError("slot_cardinalities must name every sparse slot")
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    u = torch.rand((rows, len(cards)), generator=gen, dtype=torch.float64, device=device)
    ids = hash_ids(zipf_ranks(u, slot_alphas(config, traffic)), vocab)
    del u
    v = 1.0 - torch.rand((rows, dense_dim), generator=gen, device=device)
    counts = torch.floor(-torch.log(v) * 20.0)
    dense = torch.log1p(counts).to(torch.float16).to(torch.float32)
    w = ((ids * 2654435761) % 1000).to(torch.float32) / 1000.0 - 0.5
    share = float(traffic["positive_share"])
    score = (8.0 * w.mean(dim=1) + 0.5 * (dense.mean(dim=1) - 2.7)
             + math.log(share / (1.0 - share)))
    label = (torch.rand((rows,), generator=gen, device=device)
             < torch.sigmoid(score)).to(torch.float32)
    return {"label": label, "sparse": ids.to(torch.int32), "dense": dense}


def write_slotbin(path: str, label: np.ndarray, sparse: np.ndarray,
                  dense: np.ndarray) -> None:
    """One slotbin file of int32 ids, one id a slot."""
    n, s = sparse.shape
    header = struct.pack("<8sIIIQII", b"SLOTBIN1", 64, s, dense.shape[1], n, 4, 1)
    with open(path, "wb") as f:
        f.write(header + b"\0" * (64 - len(header)))
        np.ascontiguousarray(label, np.float32).tofile(f)
        np.ascontiguousarray(sparse, np.int32).tofile(f)
        np.ascontiguousarray(dense, np.float32).tofile(f)
