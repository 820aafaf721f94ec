"""Plain reference of ``rank.deepfm`` and its operation counts.

DeepFM (Guo et al., arXiv:1703.04247) over one fused table whose logical row
holds the slot's E-wide vector and, in lane E, its first-order weight:
``logit = Σ_s w_s + dense·dense_w + FM₂(v) + head(tower([v, dense])) + b``,
``FM₂ = ½ Σ_e ((Σ_s v)² − Σ_s v²)``, the tower ReLU after every layer, the
last included, and a linear head of one unit.
"""

import math

import torch
from torch.nn import functional as F


def logical_dim(hp) -> int:
    return int(hp["sparse_feature_dim"]) + 1


def leaves(hp):
    """(state_dict name, shape, dtype, init) of every leaf but the table."""
    e, s, d = int(hp["sparse_feature_dim"]), int(hp["sparse_inputs_slots"]) - 1, int(
        hp["dense_input_dim"])
    out = [("dense_w", (d,), torch.float32, ("normal", 1e-4)),
           ("fm_bias", (), torch.float32, ("zeros",))]
    fan_in = s * e + d
    for i, size in enumerate(int(x) for x in hp["fc_sizes"]):
        out.append((f"tower.fc_{i}.weight", (size, fan_in), torch.float32,
                    ("normal", 1.0 / math.sqrt(fan_in))))
        out.append((f"tower.fc_{i}.bias", (size,), torch.float32, ("zeros",)))
        fan_in = size
    out.append(("head.weight", (1, fan_in), torch.float32, ("normal", 1.0 / math.sqrt(fan_in))))
    out.append(("head.bias", (1,), torch.float32, ("zeros",)))
    return out


def forward(p, vecs, dense, hp):
    """Logits (B,) from the looked-up vectors (B, S, E+1) and dense (B, D)."""
    e = int(hp["sparse_feature_dim"])
    emb = vecs[..., :e]
    first = vecs[..., e].sum(dim=1) + dense @ p["dense_w"]
    second = 0.5 * (emb.sum(dim=1) ** 2 - (emb * emb).sum(dim=1)).sum(dim=1)
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
    for i in range(len(hp["fc_sizes"])):
        x = F.relu(x @ p[f"tower.fc_{i}.weight"].T + p[f"tower.fc_{i}.bias"])
    deep = (x @ p["head.weight"].T + p["head.bias"])[:, 0]
    return first + second + deep + p["fm_bias"]


def flops(hp):
    """Model FLOPs an example: the tower, the head and dense·dense_w as
    products and sums; the FM's Σv, Σv² and the first-order sum.  Training:
    three times the forward, less the dense features' gradient."""
    e, s, d = int(hp["sparse_feature_dim"]), int(hp["sparse_inputs_slots"]) - 1, int(
        hp["dense_input_dim"])
    sizes = [int(x) for x in hp["fc_sizes"]]
    macs, fan_in = d, s * e + d
    for size in sizes + [1]:
        macs, fan_in = macs + fan_in * size, size
    forward = 2 * macs + 3 * s * e + 2 * e + s
    return {"forward": forward, "train": 3 * forward - 2 * d * (sizes[0] + 1)}
