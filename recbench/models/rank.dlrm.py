"""Plain reference of ``rank.dlrm`` and its operation counts.

DLRM (Naumov et al., arXiv:1906.00091): a bottom MLP maps the dense features
to the embedding width; the dot products of every pair of the 27 vectors
(the bottom output and 26 slot embeddings, i < j, row-major) join the bottom
output as the top MLP's input.  As the port's model and the JAX package's:
ReLU after every layer of both towers, the last included, and a 2-unit last
layer read as one logit ``top[:, 1] - top[:, 0]``.
"""

import math

import torch
from torch.nn import functional as F


def _sizes(hp):
    return [int(x) for x in hp["bot_layer_sizes"]], [int(x) for x in hp["top_layer_sizes"]]


def _pairs(hp) -> int:
    n = int(hp["sparse_inputs_slots"])  # 26 slots + the bottom output
    return n * (n + 1) // 2 if hp.get("self_interaction") else n * (n - 1) // 2


def logical_dim(hp) -> int:
    return int(hp["sparse_feature_dim"])


def leaves(hp):
    """(state_dict name, shape, dtype, init) of every leaf but the table."""
    bot, top = _sizes(hp)
    out = []
    for tower, fan_in, sizes in (("bot_mlp", int(hp["dense_input_dim"]), bot),
                                 ("top_mlp", bot[-1] + _pairs(hp), top)):
        for i, size in enumerate(sizes):
            out.append((f"{tower}.fc_{i}.weight", (size, fan_in), torch.float32,
                        ("normal", 1.0 / math.sqrt(fan_in))))
            # the last layer's units start alive under the port's ReLU
            last = tower == "top_mlp" and i == len(sizes) - 1
            out.append((f"{tower}.fc_{i}.bias", (size,), torch.float32,
                        ("const", 1.0) if last else ("zeros",)))
            fan_in = size
    return out


def _mlp(p, prefix, n, x):
    for i in range(n):
        x = F.relu(x @ p[f"{prefix}.fc_{i}.weight"].T + p[f"{prefix}.fc_{i}.bias"])
    return x


def forward(p, vecs, dense, hp):
    """Logits (B,) from the looked-up vectors (B, S, E) and dense (B, D)."""
    bot, top = _sizes(hp)
    x = _mlp(p, "bot_mlp", len(bot), dense)
    v = torch.cat([x[:, None, :], vecs], dim=1)
    n = v.shape[1]
    i, j = torch.triu_indices(n, n, 0 if hp.get("self_interaction") else 1,
                              device=v.device)
    dots = torch.bmm(v, v.transpose(1, 2))[:, i, j]
    out = _mlp(p, "top_mlp", len(top), torch.cat([x, dots], dim=1))
    return out[:, 1] - out[:, 0] if out.shape[1] == 2 else out[:, 0]


def flops(hp):
    """Model FLOPs an example: products and their sums, the interaction's
    pairs only (not the square the port computes).  Training: forward, the
    weights' gradient and the inputs' gradient, but for the dense features'
    gradient, which nothing needs."""
    bot, top = _sizes(hp)
    dense = int(hp["dense_input_dim"])
    macs, fan_in = 0, dense
    for size in bot:
        macs, fan_in = macs + fan_in * size, size
    macs += _pairs(hp) * int(hp["sparse_feature_dim"])
    fan_in = bot[-1] + _pairs(hp)
    for size in top:
        macs, fan_in = macs + fan_in * size, size
    forward = 2 * macs
    return {"forward": forward, "train": 3 * forward - 2 * dense * bot[0]}
