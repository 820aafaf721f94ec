"""Shared pieces of the behaviour-sequence models' tests: small configs of the
six models (T <= 8, vocab <= 1,000, hidden <= 16, dpin with 2 blocks),
numpy-seeded batches in each model's layout (with a row whose history mask is
all zero), and the checks of one port model against the JAX ``ModelDef`` of
the same name, the JAX package's initial parameters carried across with
``from_jax_params``.  The parametrised tests live in ``test_torch_seq_*.py``."""

import functools

import jax
import numpy as np
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODELS = ("rank.din", "rank.dien", "rank.bst", "rank.dsin", "rank.dmr", "rank.dpin")
BATCH = 16

_DIN = {"item_count": 300, "cat_count": 40, "max_seq_len": 8, "item_emb_size": 6,
        "cat_emb_size": 5, "attention_sizes": [12, 6], "fc_sizes": [10, 6]}
_DSIN_VOCAB = {"user_size": 500, "adgroup_size": 900, "pid_size": 2, "cms_segid_size": 97,
               "cms_group_size": 13, "final_gender_size": 2, "age_level_size": 7,
               "pvalue_level_size": 4, "shopping_level_size": 3, "occupation_size": 2,
               "new_user_class_level_size": 5, "campaign_size": 300,
               "customer_size": 200, "cate_size": 120, "brand_size": 400}
_DMR_VOCAB = {"user_size": 700, "cms_segid_size": 97, "cms_group_id_size": 13,
              "final_gender_code_size": 3, "age_level_size": 7, "pvalue_level_size": 4,
              "shopping_level_size": 4, "occupation_size": 3,
              "new_user_class_level_size": 5, "adgroup_id_size": 900, "cate_size": 150,
              "campaign_id_size": 400, "customer_size": 300, "brand_size": 500,
              "btag_size": 5, "pid_size": 2}
HYPER = {
    "rank.din": _DIN,
    "rank.dien": {**_DIN, "gru_hidden": 7},
    "rank.bst": {**_DIN, "cat_emb_size": 6, "max_seq_len": 6, "position_size": 4,
                 "n_head": 2, "ffn_dim": 10},
    "rank.dsin": {**_DSIN_VOCAB, "sess_count": 3, "sess_max_length": 4},
    "rank.dmr": {**_DMR_VOCAB, "history_length": 6, "main_embedding_size": 8,
                 "other_embedding_size": 4},
    "rank.dpin": {"K": 3, "L": 4, "max_item": 200, "max_context": 100, "emb_dim": 4,
                  "d_model": 8, "h": 2, "num_blocks": 2},
}


def flat_config(model, tmp_path=None, **extra):
    """The flat config of ``model`` at its small size (Adam, lr 1e-3)."""
    flat = {
        "runner.model": model, "runner.train_batch_size": BATCH,
        "runner.infer_batch_size": BATCH, "runner.epochs": 1,
        "runner.print_interval": 100, "runner.seed": 0,
        "hyper_parameters.optimizer.class": "Adam",
        "hyper_parameters.optimizer.learning_rate": 0.001,
        **{f"hyper_parameters.{k}": v for k, v in HYPER[model].items()},
    }
    if tmp_path is not None:
        flat.update({"runner.train_data_dir": str(tmp_path / "train"),
                     "runner.test_data_dir": str(tmp_path / "train")})
    flat.update(extra)
    return flat


def _lengths(rng, rows, t):
    """Lengths in [0, t], row 0 empty (an all-zero mask) and row 1 full."""
    lens = rng.randint(0, t + 1, rows)
    lens[0], lens[1] = 0, t
    return lens


def make_batch(model, seed, rows=BATCH):
    """A batch in ``model``'s layout at its small size, ids in range."""
    h = HYPER[model]
    rng = np.random.RandomState(seed)
    label = (rng.rand(rows) < 0.4).astype(np.float32)
    mask = (rng.rand(rows) < 0.9).astype(np.float32)
    if model in ("rank.din", "rank.dien", "rank.bst"):
        t = h["max_seq_len"]
        seq_mask = (np.arange(t)[None, :] < _lengths(rng, rows, t)[:, None])
        return {
            "hist_item": (rng.randint(1, h["item_count"], (rows, t)) * seq_mask
                          ).astype(np.int32),
            "hist_cat": (rng.randint(1, h["cat_count"], (rows, t)) * seq_mask
                         ).astype(np.int32),
            "target_item": rng.randint(0, h["item_count"], rows).astype(np.int32),
            "target_cat": rng.randint(0, h["cat_count"], rows).astype(np.int32),
            "seq_mask": seq_mask.astype(np.float32), "label": label, "mask": mask,
        }
    if model == "rank.dsin":
        s, length = h["sess_count"], h["sess_max_length"]
        vocab = [h[k] for k in _DSIN_VOCAB]
        sess_len = _lengths(rng, rows, s)
        events = rng.randint(0, length + 1, (rows, s))
        events[2, 0] = 0  # a live session with no event
        live = np.arange(length)[None, None, :] < events[..., None]  # (B, S, L)
        cate = rng.randint(1, h["cate_size"], (rows, s, length)) * live
        brand = rng.randint(1, h["brand_size"], (rows, s, length)) * live
        sess = np.stack([cate, brand], axis=2).reshape(rows, 2 * s, length)
        return {
            "sparse": np.stack([rng.randint(0, v, rows) for v in vocab], 1).astype(np.int64),
            "price": rng.rand(rows).astype(np.float32),
            "sess_input": sess.astype(np.int64), "sess_length": sess_len.astype(np.int32),
            "label": label, "mask": mask,
        }
    if model == "rank.dmr":
        t = h["history_length"]
        v = {k[:-5]: n for k, n in _DMR_VOCAB.items()}
        hist_mask = (np.arange(t)[None, :] >= t - _lengths(rng, rows, t)[:, None])
        return {
            "hist_btag": rng.randint(0, v["btag"], (rows, t)).astype(np.int64),
            "hist_cate": rng.randint(0, v["cate"], (rows, t)).astype(np.int64),
            "hist_brand": rng.randint(0, v["brand"], (rows, t)).astype(np.int64),
            "hist_mask": hist_mask.astype(np.float32),
            "match_mask": hist_mask.astype(np.float32),
            "profile": np.stack([rng.randint(0, v[n], rows) for n in (
                "cms_segid", "cms_group_id", "final_gender_code", "age_level",
                "pvalue_level", "shopping_level", "occupation", "new_user_class_level")],
                1).astype(np.int64),
            "uid": rng.randint(0, v["user"], rows).astype(np.int64),
            "mid": rng.randint(0, v["adgroup_id"], rows).astype(np.int64),
            "cate_id": rng.randint(0, v["cate"], rows).astype(np.int64),
            "campaign": rng.randint(0, v["campaign_id"], rows).astype(np.int64),
            "customer": rng.randint(0, v["customer"], rows).astype(np.int64),
            "brand": rng.randint(0, v["brand"], rows).astype(np.int64),
            "pid": rng.randint(0, v["pid"], rows).astype(np.int64),
            "price": rng.rand(rows).astype(np.float32), "label": label, "mask": mask,
        }
    k, length = h["K"], h["L"]
    return {
        "hist_item": rng.randint(0, h["max_item"], (rows, k, length)).astype(np.int64),
        "hist_cat": rng.randint(0, h["max_context"], (rows, k, length)).astype(np.int64),
        "target_item": rng.randint(0, h["max_item"], rows).astype(np.int64),
        "target_cat": rng.randint(0, h["max_context"], rows).astype(np.int64),
        "position": np.tile(np.arange(k, dtype=np.int64), (rows, 1)),
        "label": (rng.rand(rows, k) < 0.3).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def reference(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params from
    seed 0 as numpy), built once per test process: the JAX side's compiles
    are most of these tests' time."""
    jax_def = jax_model_class(model)(JaxConfig(flat_config(model)))
    params = jax.jit(jax_def.init_params)(jax.random.PRNGKey(0))
    return (jax_def, jax.jit(jax_def.train_forward),
            jax.tree.map(np.asarray, jax.device_get(params)))


def build(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params, port
    ModelDef, the port's module holding those params)."""
    jax_def, forward, params = reference(model)
    port_def = port_model_class(model)(Config(flat_config(model)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, forward, params, port_def, module


def forward_and_loss(model):
    """(port predictions, JAX predictions, port loss, JAX loss) on one batch;
    the port's predictions from ``infer_forward``, which leaves the loss
    out."""
    _, forward, params, port_def, module = build(model)
    batch = make_batch(model, 1)
    want, ref_aux = forward(params, jax.tree.map(jax.numpy.asarray, batch))
    with torch.no_grad():
        out = port_def.infer_forward(module.eval(), to_tensors(batch, CPU))
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU))
    assert sorted(aux) == sorted(ref_aux)
    np.testing.assert_array_equal(aux["predictions"].detach().numpy(),
                                  out["predictions"].numpy())
    return (out["predictions"].numpy(), np.asarray(ref_aux["predictions"]),
            float(loss.detach()), float(want))


@functools.lru_cache(maxsize=None)
def _jax_grad(model):
    jax_def, _, _ = reference(model)
    return jax.jit(jax.grad(lambda p, b: jax_def.train_forward(p, b)[0]))


def gradients(model):
    """(port gradients, JAX gradients) of every leaf, as state_dict keys."""
    _, _, params, port_def, module = build(model)
    batch = make_batch(model, 2)
    grads = _jax_grad(model)(params, jax.tree.map(jax.numpy.asarray, batch))
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    loss, _ = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    return {k: p.grad for k, p in module.named_parameters()}, want


def names_round_trip(model):
    """The flat JAX tree and the port's tree after a round trip."""
    _, _, params, _, module = build(model)
    return flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))
