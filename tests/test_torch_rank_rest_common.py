"""Shared pieces of the tests of the last six rank models (deeprec, iprec,
naml, fastformer, sign, bert4rec): small configs (tables of a few hundred
rows, deeprec's layers cut to [257, 32, 16], naml's and fastformer's news
cut to a few words), numpy-seeded batches in each model's layout (padding,
empty masks and masked rows among them), and the checks of one port model
against the JAX ``ModelDef`` of the same name from the JAX package's initial
parameters.  sign's gates take the same noise in both packages: JAX's
``jax.random.uniform`` of the key its ``train_forward`` is given, handed to
the port through ``ModelDef.draw_noise``."""

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
MODELS = ("rank.deeprec", "rank.iprec", "rank.naml", "rank.fastformer", "rank.sign",
          "rank.bert4rec")
BATCH = 6
NOISE_KEY = 7  # the PRNGKey of sign's gates in the single-forward checks

_NEWS = {"article_title_size": 5, "article_content_size": 7, "browse_size": 4,
         "neg_condidate_sample_size": 2, "word_dimension": 6, "category_size": 4,
         "sub_category_size": 6, "category_dimension": 5, "word_dict_size": 60}
HYPER = {
    "rank.deeprec": {"layer_sizes": [257, 32, 16]},
    "rank.iprec": {"num_users": 300, "num_items": 200, "num_bizs": 100, "f_max_len": 4,
                   "u_max_i": 6, "u_max_f": 7, "u_max_pack": 3, "pack_max_nei_b": 2,
                   "pack_max_nei_f": 2, "hidden_units": 8, "k": 2},
    "rank.naml": _NEWS,
    "rank.fastformer": {**_NEWS, "num_attention_heads": 4, "num_hidden_layers": 2,
                        "intermediate_size": 32},
    "rank.sign": {"n_feature": 200, "num_nodes": 5, "dim": 4, "hidden_layer": 8},
    "rank.bert4rec": {"_voc_size": 300, "_max_position_seq_len": 12, "max_mask_per_seq": 3,
                      "_emb_size": 16, "_n_layer": 2, "_n_head": 2},
}
# the aux entry each model's outputs are compared on
OUTPUT_KEY = {"rank.deeprec": "outputs", "rank.bert4rec": "correct"}


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


def make_batch(model, seed, rows=BATCH):
    """A batch in ``model``'s layout at its small size."""
    h = HYPER[model]
    rng = np.random.RandomState(seed)
    mask = np.ones(rows, np.float32)
    mask[-1] = 0.0  # a padded row
    if model == "rank.deeprec":
        n = h["layer_sizes"][0]
        ratings = rng.randint(1, 6, (rows, n)) * (rng.rand(rows, n) < 0.05)
        ratings[0] = 0  # a user with no rating
        return {"ratings": ratings.astype(np.float32), "mask": mask}
    if model == "rank.iprec":
        f = h["f_max_len"]

        def ids(hi, *shape, fill=0.7):  # 0 is padding, about 30% of the slots
            return (rng.randint(1, hi, shape) * (rng.rand(*shape) < fill)).astype(np.int64)

        def packs(n):
            out = np.concatenate([ids(h["num_items"], rows, n, 1, fill=1.0),
                                  ids(h["num_bizs"], rows, n, 1, fill=1.0),
                                  ids(h["num_users"], rows, n, f)], axis=-1)
            out[rng.rand(rows, n) < 0.3] = 0  # missing packages
            return out

        batch = {
            "user": rng.randint(0, h["num_users"], rows).astype(np.int64),
            "item": rng.randint(0, h["num_items"], rows).astype(np.int64),
            "biz": rng.randint(0, h["num_bizs"], rows).astype(np.int64),
            "friends": ids(h["num_users"], rows, f),
            "user_items": ids(h["num_items"], rows, h["u_max_i"]),
            "user_bizs": ids(h["num_bizs"], rows, h["u_max_i"]),
            "user_friends": ids(h["num_users"], rows, h["u_max_f"]),
            "user_packages": packs(h["u_max_pack"]),
            "pack_neighbors_b": packs(h["pack_max_nei_b"]),
            "pack_neighbors_f": packs(h["pack_max_nei_f"]),
            "label": (rng.rand(rows) < 0.4).astype(np.float32), "mask": mask,
        }
        batch["user_friends"][0] = 0  # no friend: uniform weights over padding
        batch["friends"][1] = 0
        return batch
    if model in ("rank.naml", "rank.fastformer"):
        s, v = h["neg_condidate_sample_size"] + 1, h["browse_size"]
        words = h["word_dict_size"] + 1  # the last id is fastformer's pad token

        def text(*shape):
            return rng.randint(0, words, shape).astype(np.int64)

        labels = np.zeros((rows, s), np.float32)
        labels[np.arange(rows), rng.randint(0, s, rows)] = 1.0
        labels[0] = [0.5, 0.5] + [0.0] * (s - 2)  # soft labels
        return {
            "cate_sample": rng.randint(0, h["category_size"] + 1, (rows, s)).astype(np.int64),
            "cate_visit": rng.randint(0, h["category_size"] + 1, (rows, v)).astype(np.int64),
            "sub_cate_sample": rng.randint(0, h["sub_category_size"] + 1,
                                           (rows, s)).astype(np.int64),
            "sub_cate_visit": rng.randint(0, h["sub_category_size"] + 1,
                                          (rows, v)).astype(np.int64),
            "title_sample": text(rows, s, h["article_title_size"]),
            "title_visit": text(rows, v, h["article_title_size"]),
            "content_sample": text(rows, s, h["article_content_size"]),
            "content_visit": text(rows, v, h["article_content_size"]),
            "labels": labels, "mask": mask,
        }
    if model == "rank.sign":
        f = h["num_nodes"]
        node_mask = (rng.rand(rows, f) < 0.8).astype(np.float32)
        node_mask[0] = 0.0  # an empty graph
        node_mask[1] = [1.0] + [0.0] * (f - 1)  # a single node: no edge
        nodes = (rng.randint(0, h["n_feature"], (rows, f)) * node_mask).astype(np.int64)
        return {"nodes": nodes, "node_mask": node_mask,
                "label": (rng.rand(rows) < 0.5).astype(np.float32), "mask": mask}
    t, m, v = h["_max_position_seq_len"], h["max_mask_per_seq"], h["_voc_size"]
    lens = rng.randint(m, t + 1, rows)
    lens[0] = t
    input_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    mask_pos = np.stack([rng.choice(n, m, replace=False) for n in lens]).astype(np.int32)
    weight = (rng.rand(rows, m) < 0.8).astype(np.float32)
    weight[-1] = 0.0
    return {
        "src_ids": (rng.randint(1, v, (rows, t)) * input_mask).astype(np.int32),
        "pos_ids": np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
        "sent_ids": rng.randint(0, 2, (rows, t)).astype(np.int32),
        "input_mask": input_mask, "mask_pos": mask_pos,
        "mask_label": rng.randint(0, v, (rows, m)).astype(np.int32),
        "mask_weight": weight,
    }


@functools.lru_cache(maxsize=None)
def reference(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params from
    seed 0 as numpy), built once per test process."""
    jax_def = jax_model_class(model)(JaxConfig(flat_config(model)))
    params = jax.jit(jax_def.init_params)(jax.random.PRNGKey(0))
    return (jax_def, jax.jit(jax_def.train_forward),
            jax.tree.map(np.asarray, jax.device_get(params)))


def jax_noise(key, shape):
    """What sign's JAX ``train_forward`` draws from ``key``."""
    return np.asarray(jax.random.uniform(key, shape))


def feed_noise(port_def, noise):
    """Make the port's sign draw ``noise`` (a numpy array, or a function of
    the generator's shape returning one) in place of its own."""
    def draw(generator, shape, device):
        arr = noise(shape) if callable(noise) else noise
        assert tuple(arr.shape) == tuple(shape)
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    port_def.draw_noise = draw


def build(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params, port
    ModelDef, the port's module holding those params)."""
    jax_def, forward, params = reference(model)
    port_def = port_model_class(model)(Config(flat_config(model)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, forward, params, port_def, module


def _jax_args(model, batch):
    """(batch on the device, extra kwargs of JAX's train_forward)."""
    jbatch = jax.tree.map(jax.numpy.asarray, batch)
    return jbatch, ({"rng": jax.random.PRNGKey(NOISE_KEY)} if model == "rank.sign" else {})


def _port_kwargs(model, port_def, batch):
    if model != "rank.sign":
        return {}
    b, f = batch["nodes"].shape
    feed_noise(port_def, jax_noise(jax.random.PRNGKey(NOISE_KEY), (b, f, f)))
    return {"generator": torch.Generator()}


def forward_and_loss(model, seed=1):
    """(port outputs from ``infer_forward``, JAX outputs of the deterministic
    forward, port loss, JAX loss of ``train_forward``, port train aux, JAX
    train aux)."""
    jax_def, forward, params, port_def, module = build(model)
    batch = make_batch(model, seed)
    if model == "rank.bert4rec":
        # the logits themselves, and labels that make some flags 1: JAX's
        # argmax at the first masked position of every row
        jbatch, _ = _jax_args(model, batch)
        logits = np.asarray(jax_def.module.apply({"params": params},
                                                 *jax_def.model_inputs(jbatch)))
        with torch.no_grad():
            got = module(*port_def.model_inputs(to_tensors(batch, CPU))).numpy()
        np.testing.assert_allclose(got, logits, rtol=0, atol=1e-5)
        batch["mask_label"][:, 0] = logits[:, 0].argmax(-1)
    jbatch, jkw = _jax_args(model, batch)
    want, ref_aux = forward(params, jbatch, **jkw)
    ref_infer = jax.jit(jax_def.infer_forward)(params, jbatch)
    with torch.no_grad():
        out = port_def.infer_forward(module.eval(), to_tensors(batch, CPU))
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU),
                                       **_port_kwargs(model, port_def, batch))
    assert sorted(aux) == sorted(ref_aux)
    key = OUTPUT_KEY.get(model, "predictions")
    return (out[key].numpy(), np.asarray(ref_infer[key]), float(loss.detach()), float(want),
            {k: v.detach().numpy() for k, v in aux.items()},
            {k: np.asarray(v) for k, v in ref_aux.items()})


@functools.lru_cache(maxsize=None)
def _jax_grad(model):
    jax_def, _, _ = reference(model)
    return jax.jit(jax.grad(lambda p, b, **kw: jax_def.train_forward(p, b, **kw)[0]))


def gradients(model, seed=2):
    """(port gradients, JAX gradients) of every leaf, as state_dict keys."""
    _, _, params, port_def, module = build(model)
    batch = make_batch(model, seed)
    jbatch, jkw = _jax_args(model, batch)
    grads = _jax_grad(model)(params, jbatch, **jkw)
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    loss, _ = port_def.train_forward(module, to_tensors(batch, CPU),
                                     **_port_kwargs(model, port_def, batch))
    loss.backward()
    return {k: p.grad for k, p in module.named_parameters()}, want


def names_round_trip(model):
    """The flat JAX tree and the port's tree after a round trip."""
    _, _, params, _, module = build(model)
    return flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))
