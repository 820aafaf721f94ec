"""Shared pieces of the tests of recall's deepwalk, mind, tisas, ensfm and
mhcn and of the graph family (graph.gnn, graph.lightgcn,
graph.transformer_conv, graph.deepwalk_million) in the port: small configs
(tables of tens of rows, widths of 4 to 8, two hops of fan-out 3 and 2),
numpy-seeded batches in each model's layout (a node without neighbours,
padded histories, pad tokens and time intervals past the span among them),
the JAX package's permutations for mhcn, and the checks of one port model
against the JAX ``ModelDef`` of the same name from the JAX package's initial
parameters.

Tolerances: outputs, losses and gradients within 1e-5, scaled by the size of
the reference where it is above 1 (``close``): float32 sums in another order
err in proportion to their terms, and GIN's sums over two hops and mhcn's
normalized propagation of 0.005-scale tables reach gradients of a few
hundred (a float32 rounding of 2e-5 there; the float64 tests hold both to
1e-7 relative)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODELS = ("recall.deepwalk", "graph.gnn", "graph.lightgcn", "graph.transformer_conv",
          "graph.deepwalk_million", "recall.mind", "recall.tisas", "recall.ensfm",
          "recall.mhcn")
CONVS = ("gin", "graphsage_mean", "graphsage_bow", "graphsage_max", "gat", "lightgcn",
         "transformer_conv")
LOSSES = ("nce", "hinge", "sigmoid")
BATCH = 6
GRAPH = {"num_nodes": 40, "emb_size": 8, "samples": "3,2", "neg_num": 3, "walk_len": 5,
         "win_size": 2, "walk_times": 2}

HYPER = {
    "recall.deepwalk": {"num_nodes": 50, "embed_size": 8, "neg_num": 3, "walk_len": 6,
                        "win_size": 2},
    "graph.gnn": dict(GRAPH, sage_layer_type="gat"),
    "graph.lightgcn": GRAPH,
    # four heads of two: the (..., h, hd) split is exercised
    "graph.transformer_conv": GRAPH,
    "graph.deepwalk_million": {k: v for k, v in GRAPH.items() if k != "samples"},
    "recall.mind": {"item_count": 60, "embedding_dim": 8, "maxlen": 7, "neg_samples": 5,
                    "interest_num": 3},
    "recall.tisas": {"item_num": 40, "maxlen": 8, "time_span": 16, "hidden_units": 8,
                     "num_heads": 2},
    "recall.ensfm": {"num_users": 30, "num_items": 20, "mf_dim": 4, "max_positives": 6},
    "recall.mhcn": {"demo_graph": True, "num_users": 20, "num_items": 15,
                    "num_factors": 8},
}
# the aux entry each model's outputs are compared on
OUTPUT_KEY = {"recall.mind": "pos_logit", "recall.ensfm": "scores", "recall.mhcn": "rec_loss"}


def flat_config(model, **extra):
    """The flat config of ``model`` at its small size (Adam, lr 1e-3)."""
    flat = {
        "runner.model": model, "runner.train_batch_size": BATCH,
        "runner.infer_batch_size": BATCH, "runner.epochs": 1,
        "runner.print_interval": 100, "runner.seed": 0,
        "hyper_parameters.optimizer.class": "Adam",
        "hyper_parameters.optimizer.learning_rate": 0.001,
        **{f"hyper_parameters.{k}": v for k, v in HYPER[model].items()},
    }
    flat.update(extra)
    return flat


def make_batch(model, seed, rows=BATCH, **extra):
    """A batch in ``model``'s layout at its small size."""
    h = dict(HYPER[model], **{k.split(".")[-1]: v for k, v in extra.items()})
    rng = np.random.RandomState(seed)
    if model == "recall.deepwalk":
        n = h["num_nodes"]
        return {"src": rng.randint(0, n, rows).astype(np.int64),
                "dsts": rng.randint(0, n, (rows, 1 + h["neg_num"])).astype(np.int64)}
    if model.startswith("graph."):
        n = h["num_nodes"]
        pairs = rng.randint(0, n, (rows, 2)).astype(np.int64)
        pairs[2, 1] = pairs[3, 1]  # a rolled negative equal to the positive
        out = {"pair_nodes": pairs}
        shape = (rows, 2)
        samples = str(h.get("samples", "")).split(",") if "samples" in h else []
        for i, k in enumerate(samples):
            shape = shape + (int(k),)
            out[f"neigh_{i}"] = rng.randint(0, n, shape).astype(np.int64)
            mask = (rng.rand(*shape) < 0.7).astype(np.float32)
            mask[0, 0] = 0.0  # nodes with no neighbour
            out[f"neigh_mask_{i}"] = mask
        return out
    if model == "recall.mind":
        t = h["maxlen"]
        lens = rng.randint(1, t + 1, rows)
        lens[1] = t
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        mask = np.ones(rows, np.float32)
        mask[-1] = 0.0
        v = h["item_count"]
        return {"hist_items": (rng.randint(0, v, (rows, t)) * seq_mask).astype(np.int32),
                "seq_mask": seq_mask, "target_items": rng.randint(0, v, rows).astype(np.int32),
                "neg_items": rng.randint(0, v, (rows, h["neg_samples"])).astype(np.int32),
                "mask": mask}
    if model == "recall.tisas":
        t, v = h["maxlen"], h["item_num"]
        lens = rng.randint(1, t + 1, rows)
        lens[0] = t
        valid = np.arange(t)[None, :] >= (t - lens)[:, None]  # left-padded
        log = rng.randint(1, v + 1, (rows, t)) * valid
        pos = rng.randint(1, v + 1, (rows, t)) * valid
        # intervals past time_span are clipped by the model
        times = rng.randint(0, h["time_span"] + 4, (rows, t, t))
        return {"log_seqs": log.astype(np.int64), "time_matrices": times.astype(np.int64),
                "pos_seqs": pos.astype(np.int64),
                "neg_seqs": (rng.randint(1, v + 1, (rows, t)) * valid).astype(np.int64)}
    if model == "recall.ensfm":
        items, p = h["num_items"], h["max_positives"]
        positives = rng.randint(0, items, (rows, p)).astype(np.int64)
        cut = rng.randint(1, p + 1, rows)
        positives[np.arange(p)[None, :] >= cut[:, None]] = items  # the pad token
        return {"user_features": rng.randint(0, h["num_users"], (rows, 1)).astype(np.int64),
                "item_attribute": np.arange(items, dtype=np.int64)[:, None],
                "positives": positives}
    return {"users": rng.randint(0, h["num_users"], rows).astype(np.int64),
            "pos_items": rng.randint(0, h["num_items"], rows).astype(np.int64),
            "neg_items": rng.randint(0, h["num_items"], rows).astype(np.int64)}


def _hashable(extra):
    return tuple(sorted(extra.items()))


@functools.lru_cache(maxsize=None)
def _reference(model, extra):
    jax_def = jax_model_class(model)(JaxConfig(flat_config(model, **dict(extra))))
    if model == "recall.mhcn":
        # its demo graph, built lazily, would leak the trace of a jitted init
        jax_def._graph()
    params = jax.tree.map(np.asarray, jax.device_get(
        jax.jit(jax_def.init_params)(jax.random.PRNGKey(0))))
    return jax_def, params


def reference(model, **extra):
    """(JAX ModelDef, its initial params from seed 0 as numpy), built once
    per test process."""
    return _reference(model, _hashable(extra))


def build(model, **extra):
    """(JAX ModelDef, its initial params, port ModelDef, the port's module
    holding those params)."""
    jax_def, params = reference(model, **extra)
    port_def = port_model_class(model)(Config(flat_config(model, **extra)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, params, port_def, module


@functools.lru_cache(maxsize=None)
def _value_and_grad(model, extra, wide):
    """The JAX ModelDef's ``train_forward`` loss and its gradient, jitted
    once per test process and configuration."""
    jax_def, _ = _reference(model, extra)

    def loss(p, batch, kw):
        return jax_def.train_forward(p, batch, **kw)

    with jax.enable_x64(wide):
        return jax.jit(jax.value_and_grad(loss, has_aux=True))


def jax_perms(rng, users, factors):
    """The permutations mhcn's ``_hierarchical_ss`` draws under ``rng``:
    channel i's (U, E, U) from ``split(fold_in(rng, i), 3)``."""
    out = []
    for i in range(3):
        keys = jax.random.split(jax.random.fold_in(rng, i), 3)
        out.append(tuple(torch.from_numpy(np.array(jax.random.permutation(k, n)))
                         for k, n in zip(keys, (users, factors, users))))
    return out


def forward_grad(model, seed=1, dtype=np.float32, **extra):
    """One batch through both packages: (port loss, JAX loss, port aux, JAX
    aux, port gradients by state_dict key (None where the port takes none),
    JAX gradients).  mhcn takes JAX's permutations of ``PRNGKey(seed)``;
    with ``dtype=np.float64`` both run in float64."""
    jax_def, params, port_def, module = build(model, **extra)
    batch = make_batch(model, seed, **extra)
    jkw, pkw = {}, {}
    if model == "recall.mhcn":
        h = HYPER[model]
        rng = jax.random.PRNGKey(seed)
        jkw["rng"] = rng
        pkw["perms"] = jax_perms(rng, h["num_users"], h["num_factors"])
    wide = dtype == np.float64
    if wide:
        batch = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in batch.items()}
        module = module.double()
        if model == "recall.mhcn":
            port_def._on_device = {CPU: tuple(t.double() for t in port_def.graph(CPU))}
    with jax.enable_x64(wide):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        (want_loss, ref_aux), grads = _value_and_grad(model, _hashable(extra), wide)(
            p, jax.tree.map(jnp.asarray, batch), jkw)
        want = from_jax_params(jax.tree.map(np.asarray, grads))
        ref_aux = {k: np.asarray(v) for k, v in ref_aux.items()}
        want_loss = float(want_loss)
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU) if not wide else
                                       {k: torch.from_numpy(v) for k, v in batch.items()},
                                       **pkw)
    loss.backward()
    got = {k: p.grad for k, p in module.named_parameters()}
    return (float(loss.detach()), want_loss, {k: v.detach().numpy() for k, v in aux.items()},
            ref_aux, got, want)


def close(got, want, atol=1e-5, err_msg=""):
    """``got`` within ``atol`` of ``want``, scaled by the largest entry of
    ``want`` where that is above 1."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol * scale,
                               err_msg=err_msg)
