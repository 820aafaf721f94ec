"""Shared pieces of the tests of the match, content-understanding and recall
models of the port (dssm, multiview_simnet, match_pyramid, kim, textcnn,
tagspace, ncf, word2vec): small configs (tables of tens of rows, towers and
convs of a few units, kim's news cut to three clicks of four words, its 100-d
entity vectors kept), numpy-seeded batches in each model's layout (a padded
row, empty masks and masked tokens among them), and the checks of one port
model against the JAX ``ModelDef`` of the same name from the JAX package's
initial parameters."""

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
MODELS = ("match.dssm", "match.multiview_simnet", "match.match_pyramid", "match.kim",
          "contentunderstanding.textcnn", "contentunderstanding.tagspace", "recall.ncf",
          "recall.word2vec")
BATCH = 6
ENT_DIM = 100
# the spread of kim's entity vectors in the test batches: entries of about
# ±0.1, as 100-d TransE vectors of a knowledge graph have (see
# test_torch_match_models.py on standard normals)
KG_SCALE = 0.1

HYPER = {
    "match.dssm": {"trigram_d": 40, "neg_num": 2, "fc_sizes": [16, 12, 8]},
    "match.multiview_simnet": {"sparse_feature_number": 60, "query_slots": 2,
                               "title_slots": 1, "max_len": 5, "embedding_dim": 6,
                               "hidden_size": 8},
    # pooling windows of (2, 2) over a 13 × 103 image: the last row and
    # column fall outside every window
    "match.match_pyramid": {"vocab_size": 70, "sentence_left_size": 13,
                            "sentence_right_size": 103, "emb_size": 6, "kernel_num": 3,
                            "hidden_size": 5},
    # hidden 8: the 4-head branch (the 20-head one in test_torch_match_layers.py)
    "match.kim": {"vocab_size": 50, "max_sents": 3, "max_sentence": 4,
                  "max_entity_num": 2, "npratio": 1, "embedding_size": 6,
                  "hidden_size": 8},
    "contentunderstanding.textcnn": {"dict_dim": 80, "max_len": 9, "emb_dim": 6,
                                     "cnn_dim": 5, "hid_dim": 7},
    "contentunderstanding.tagspace": {"vocab_text_size": 90, "max_len": 9, "emb_dim": 5,
                                      "hid_dim": 12},
    "recall.ncf": {"num_users": 50, "num_items": 40, "mf_dim": 4, "fc_layers": [16, 8, 4]},
    "recall.word2vec": {"sparse_feature_number": 60, "sparse_feature_dim": 12,
                        "neg_num": 3, "window_size": 2},
}
# the aux entry each model's outputs are compared on
OUTPUT_KEY = {"match.dssm": "sim_pos", "match.multiview_simnet": "sim_pos",
              "contentunderstanding.tagspace": "pos_sim", "recall.word2vec": "pos_logit"}


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


def make_batch(model, seed, rows=BATCH, kg_scale=KG_SCALE):
    """A batch in ``model``'s layout at its small size; its last row is
    padding (``mask`` 0).  kim's entity vectors are normals of spread
    ``kg_scale``."""
    h = HYPER[model]
    rng = np.random.RandomState(seed)
    mask = np.ones(rows, np.float32)
    mask[-1] = 0.0
    if model == "match.dssm":
        def trig(*shape):
            return (rng.rand(*shape) < 0.3).astype(np.float32)

        return {"query": trig(rows, h["trigram_d"]), "doc_pos": trig(rows, h["trigram_d"]),
                "doc_negs": trig(rows, h["neg_num"], h["trigram_d"]), "mask": mask}
    if model == "match.multiview_simnet":
        def slots(s):
            ids = rng.randint(0, h["sparse_feature_number"], (rows, s, h["max_len"]))
            m = (rng.rand(rows, s, h["max_len"]) < 0.6).astype(np.float32)
            m[:, :, 0] = 1.0  # no empty bag: its zero vector has no cosine gradient
            return ids.astype(np.int32), m

        q, qm = slots(h["query_slots"])
        t, tm = slots(h["title_slots"])
        return {"q_slots": q, "q_mask": qm, "t_slots": t, "t_mask": tm, "mask": mask}
    if model == "match.match_pyramid":
        v = h["vocab_size"]
        return {"left": rng.randint(0, v, (rows, h["sentence_left_size"])).astype(np.int32),
                "right": rng.randint(0, v, (rows, h["sentence_right_size"])).astype(np.int32),
                "label": (rng.rand(rows) < 0.5).astype(np.float32), "mask": mask}
    if model == "match.kim":
        c, s, w, e = 1 + h["npratio"], h["max_sents"], h["max_sentence"], h["max_entity_num"]
        labels = np.zeros((rows, c), np.float32)
        labels[:, 0] = 1.0
        v = h["vocab_size"]

        def kg(*shape):
            return (rng.randn(*shape, ENT_DIM) * kg_scale).astype(np.float32)

        return {
            "titles": rng.randint(0, v, (rows, c, w)).astype(np.int64),
            "entities": kg(rows, c, e), "one_hops": kg(rows, c, e, e),
            "clicked_title": rng.randint(0, v, (rows, s, w)).astype(np.int64),
            "clicked_entity": kg(rows, s, e), "clicked_one_hop": kg(rows, s, e, e),
            "labels": labels, "mask": mask,
        }
    if model in ("contentunderstanding.textcnn", "contentunderstanding.tagspace"):
        t = h["max_len"]
        lens = rng.randint(1, t + 1, rows)
        lens[0] = 0  # a row with no token: -1e9 features
        lens[1] = t
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        vocab = h.get("dict_dim", h.get("vocab_text_size"))
        tokens = (rng.randint(0, vocab, (rows, t)) * seq_mask).astype(np.int32)
        if model == "contentunderstanding.textcnn":
            return {"tokens": tokens, "seq_mask": seq_mask,
                    "label": rng.randint(0, 2, rows).astype(np.int32), "mask": mask}
        pos = rng.randint(0, 4, rows).astype(np.int32)
        return {"tokens": tokens, "seq_mask": seq_mask, "pos_tag": pos,
                "neg_tags": ((pos[:, None] + rng.randint(1, 4, (rows, 3))) % 4).astype(np.int32),
                "mask": mask}
    if model == "recall.ncf":
        return {"users": rng.randint(0, h["num_users"], rows).astype(np.int32),
                "items": rng.randint(0, h["num_items"], rows).astype(np.int32),
                "label": (rng.rand(rows) < 0.5).astype(np.float32), "mask": mask}
    v = h["sparse_feature_number"]
    return {"center": rng.randint(0, v, rows).astype(np.int32),
            "pos": rng.randint(0, v, rows).astype(np.int32),
            "negs": rng.randint(0, v, (rows, h["neg_num"])).astype(np.int32), "mask": mask}


@functools.lru_cache(maxsize=None)
def reference(model, **extra):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params from
    seed 0 as numpy), built once per test process.  word2vec's output
    tables start at zero: they get the JAX package's normal draw of the
    input table's shape, so that its forward is not trivially 0."""
    jax_def = jax_model_class(model)(JaxConfig(flat_config(model, **extra)))
    params = jax.tree.map(np.asarray, jax.device_get(
        jax.jit(jax_def.init_params)(jax.random.PRNGKey(0))))
    if model == "recall.word2vec":
        rng = np.random.RandomState(11)
        for name in ("out_emb", "out_bias"):
            table = params[name]["embedding"]
            params[name]["embedding"] = (rng.randn(*table.shape) * 0.1).astype(np.float32)
    return jax_def, jax.jit(jax_def.train_forward), params


def build(model, **extra):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params, port
    ModelDef, the port's module holding those params)."""
    jax_def, forward, params = reference(model, **extra)
    port_def = port_model_class(model)(Config(flat_config(model, **extra)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, forward, params, port_def, module


def forward_and_loss(model, seed=1, **extra):
    """(port outputs from ``infer_forward``, JAX outputs of its
    ``infer_forward``, port loss, JAX loss of ``train_forward``, port train
    aux, JAX train aux)."""
    jax_def, forward, params, port_def, module = build(model, **extra)
    batch = make_batch(model, seed)
    jbatch = jax.tree.map(jax.numpy.asarray, batch)
    want, ref_aux = forward(params, jbatch)
    ref_infer = jax.jit(jax_def.infer_forward)(params, jbatch)
    with torch.no_grad():
        out = port_def.infer_forward(module.eval(), to_tensors(batch, CPU))
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU))
    assert sorted(aux) == sorted(ref_aux) and sorted(out) == sorted(ref_infer)
    key = OUTPUT_KEY.get(model, "predictions")
    return (out[key].numpy(), np.asarray(ref_infer[key]), float(loss.detach()), float(want),
            {k: v.detach().numpy() for k, v in aux.items()},
            {k: np.asarray(v) for k, v in ref_aux.items()})


@functools.lru_cache(maxsize=None)
def _jax_grad(model, **extra):
    jax_def, _, _ = reference(model, **extra)
    return jax.jit(jax.grad(lambda p, b: jax_def.train_forward(p, b)[0]))


def gradients(model, seed=2, **extra):
    """(port gradients, JAX gradients) of every leaf, as state_dict keys."""
    _, _, params, port_def, module = build(model, **extra)
    batch = make_batch(model, seed)
    grads = _jax_grad(model, **extra)(params, jax.tree.map(jax.numpy.asarray, batch))
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    loss, _ = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    return {k: p.grad for k, p in module.named_parameters()}, want


def names_round_trip(model):
    """The flat JAX tree and the port's tree after a round trip."""
    _, _, params, _, module = build(model)
    return flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))
