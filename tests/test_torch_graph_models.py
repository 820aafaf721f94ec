"""Recall's deepwalk, mind, tisas, ensfm and mhcn and the graph family in
the port against the JAX ``ModelDef`` of the same name, from the JAX
package's initial parameters and one numpy-seeded batch: loss, every aux
entry and every leaf's gradient against ``jax.grad`` of ``train_forward``
(``close``: 1e-5, scaled where the reference is above 1); graph.gnn under
each conv type and each loss; float64 runs of GIN and mhcn at 1e-7; the
serving calls against the JAX package's (``node_embeddings``,
``user_capsules``, ``score_items``, ensfm's ``infer_forward``,
``user_item_embeddings``); tisas's causality; mind's frozen routing logits;
ensfm's closed-form loss against the brute-force sum; mhcn's motif
adjacency bitwise and its error without a graph; the same leaf names and
``to_jax_params(from_jax_params(p))`` bitwise; and a seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.models.recall.mhcn import model as jax_mhcn
from paddlerec_tpu_torch.convert import flatten_tree, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class
from paddlerec_tpu_torch.models.recall.mhcn import model as port_mhcn
from tests.test_torch_graph_common import (
    CONVS, CPU, HYPER, LOSSES, MODELS, build, close, flat_config, forward_grad, make_batch,
    reference,
)

torch.set_num_threads(1)

# graph.gnn's other conv types and losses ride as extra cases of one check
GNN_CASES = [(c, l) for c in CONVS for l in LOSSES]


def _check(model, **extra):
    loss, want_loss, aux, ref_aux, got, want = forward_grad(model, **extra)
    assert np.isfinite(loss)
    close(loss, want_loss, err_msg="loss")
    assert sorted(aux) == sorted(ref_aux)
    for k, v in ref_aux.items():
        close(aux[k], v, err_msg=k)
    assert sorted(got) == sorted(want)
    assert [k for k, g in got.items() if g is None] == []
    # mind's routing logits stop their gradient: exactly 0 in both, a leaf
    # the optimizer still steps
    stopped = ["routing.routing_logits"] if model == "recall.mind" else []
    for k in stopped:
        assert not want[k].any() and not got[k].any(), k
    for k, g in want.items():
        close(got[k].numpy(), g.numpy(), err_msg=k)
    moved = [k for k, g in got.items() if float(g.abs().max()) > 0]
    assert len(moved) >= 0.8 * (len(got) - len(stopped)), sorted(set(got) - set(moved))
    return aux


@pytest.mark.parametrize("model", MODELS)
def test_loss_aux_and_gradients_match_jax(model):
    aux = _check(model)
    out = aux.get("predictions", aux.get("pos_logit", aux.get("scores", aux.get("rec_loss"))))
    assert np.ptp(np.ravel(out)) > 1e-4 or model == "recall.mhcn"


@pytest.mark.parametrize("conv,loss", GNN_CASES)
def test_gnn_every_conv_and_loss_matches_jax(conv, loss):
    _check("graph.gnn", **{"hyper_parameters.sage_layer_type": conv,
                           "hyper_parameters.loss_type": loss})


@pytest.mark.parametrize("model,extra", [
    ("graph.gnn", {"hyper_parameters.sage_layer_type": "gin"}),
    ("graph.gnn", {"hyper_parameters.sage_layer_type": "gin",
                   "hyper_parameters.loss_type": "sigmoid"}),
    ("recall.mhcn", {}),
])
def test_float64_matches_jax_exactly(model, extra):
    """The largest gradients (GIN's two hops of sums, mhcn's normalized
    propagation) in float64 in both packages: 1e-7 relative, a hundred times
    inside the float32 checks' tolerance, so that one covers rounding alone.
    The port's lookups still round their rows to float32 here (K1's plain
    version sums in float32), which is what is left."""
    loss, want_loss, _, ref_aux, got, want = forward_grad(model, dtype=np.float64, **extra)
    assert abs(loss - want_loss) < 1e-7 * max(1.0, abs(want_loss))
    assert max(float(g.abs().max()) for g in want.values()) > 10  # the large regime
    for k, g in want.items():
        assert got[k].dtype == torch.float64, k
        close(got[k].numpy(), g.numpy(), atol=1e-7, err_msg=k)


def _port_batch(model, seed):
    return make_batch(model, seed), to_tensors(make_batch(model, seed), CPU)


def test_serving_calls_match_jax():
    """deepwalk's ``node_embeddings`` (the table, and rows through K1), mind's
    ``user_capsules``, tisas's ``score_items``, ensfm's ``infer_forward``
    scores and mhcn's ``user_item_embeddings``."""
    jd, params, pd, module = build("recall.deepwalk")
    table = pd.node_embeddings(module)
    assert torch.equal(table, torch.from_numpy(jd.node_embeddings(params)))
    nodes = torch.tensor([3, 0, 49, 7])
    assert torch.equal(pd.node_embeddings(module, nodes), table[nodes])

    jd, params, pd, module = build("recall.mind")
    b, tb = _port_batch("recall.mind", 4)
    want = jd.module.apply({"params": params}, jnp.asarray(b["hist_items"]),
                           jnp.asarray(b["seq_mask"]), method=jd.module.user_capsules)
    got = module.user_capsules(tb["hist_items"], tb["seq_mask"])
    close(got.detach().numpy(), np.asarray(want))

    jd, params, pd, module = build("recall.tisas")
    b, tb = _port_batch("recall.tisas", 4)
    cand = np.random.RandomState(5).randint(1, HYPER["recall.tisas"]["item_num"] + 1, (6, 9))
    want = jd.score_items(params, jnp.asarray(b["log_seqs"]), jnp.asarray(b["time_matrices"]),
                          jnp.asarray(cand))
    got = pd.score_items(module, tb["log_seqs"], tb["time_matrices"], torch.from_numpy(cand))
    assert got.shape == (6, 9)
    close(got.detach().numpy(), np.asarray(want))

    jd, params, pd, module = build("recall.ensfm")
    b, tb = _port_batch("recall.ensfm", 4)
    want = jd.infer_forward(params, jax.tree.map(jnp.asarray, b))["scores"]
    got = pd.infer_forward(module, tb)["scores"]
    assert got.shape == (6, HYPER["recall.ensfm"]["num_items"])
    close(got.detach().numpy(), np.asarray(want))

    jd, params, pd, module = build("recall.mhcn")
    for g, w in zip(pd.user_item_embeddings(module), jd.user_item_embeddings(params)):
        close(g.numpy(), w)


def test_tisas_is_causal():
    """Changing the last item changes no logit at an earlier position."""
    _, _, pd, module = build("recall.tisas")
    b = make_batch("recall.tisas", 3)
    other = dict(b, log_seqs=b["log_seqs"].copy())
    other["log_seqs"][:, -1] = other["log_seqs"][:, -1] % 39 + 1
    with torch.no_grad():
        p1, _ = module(*pd.model_inputs(to_tensors(b, CPU)))
        p2, _ = module(*pd.model_inputs(to_tensors(other, CPU)))
    assert torch.equal(p1[:, :-1], p2[:, :-1]) and not torch.equal(p1[:, -1], p2[:, -1])


def test_ensfm_closed_form_loss_is_the_brute_force_sum():
    """The closed-form all-pair term equals ``w·Σ pre²`` over every (user,
    item) pair, as tests/test_recall_wave2.py holds the JAX package's."""
    _, _, pd, module = build("recall.ensfm")
    b = to_tensors(make_batch("recall.ensfm", 2), CPU)
    with torch.no_grad():
        pre, pos_r, q_emb, p_emb, h_emb = module(*pd.model_inputs(b))
        w = pd.negative_weight
        closed = w * torch.sum((q_emb.T @ q_emb) * (p_emb.T @ p_emb) * (h_emb @ h_emb.T))
        brute = w * torch.sum(pre.double() ** 2)
    np.testing.assert_allclose(float(closed), float(brute), rtol=1e-5)
    # the pad token's column is masked: a row of pads scores 0
    pads = b["positives"] == pd.num_items
    assert pads.any() and torch.all(pos_r[pads] == 0)


def test_mhcn_motif_adjacency_is_bitwise_and_a_graph_is_required():
    rng = np.random.RandomState(7)
    social = (rng.rand(30, 30) < 0.2).astype(np.float32)
    np.fill_diagonal(social, 0)
    rating = (rng.rand(30, 25) < 0.15).astype(np.float32)
    for got, want in zip(port_mhcn.build_motif_adjacency(social, rating),
                         jax_mhcn.build_motif_adjacency(social, rating)):
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    pd = get_model_class("recall.mhcn")(Config(flat_config(
        "recall.mhcn", **{"hyper_parameters.demo_graph": False})))
    module = pd.make_module(device="cpu")
    batch = to_tensors(make_batch("recall.mhcn", 0), CPU)
    with pytest.raises(RuntimeError, match="set_graph"):
        pd.train_forward(module, batch)
    pd.set_graph(social[:20, :20], rating[:20, :15])
    loss, aux = pd.train_forward(module, batch, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(loss)) and float(aux["ss_loss"]) > 0
    # the same step draw gives the same loss; evaluation has no self-supervision
    again, _ = pd.train_forward(module, batch, generator=torch.Generator().manual_seed(1))
    assert float(again) == float(loss)
    assert float(pd.infer_forward(module, batch)["ss_loss"]) == 0.0


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seeded_init(model):
    _, params, _, module = build(model)
    flat = flatten_tree(params)
    back = flatten_tree(to_jax_params(module.state_dict()))
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        assert v.dtype == back[k].dtype and v.shape == back[k].shape, k
        assert v.tobytes() == back[k].tobytes(), k
    port_def = get_model_class(model)(Config(flat_config(model)))
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(3))
    again = port_def.make_module(generator=torch.Generator().manual_seed(3))
    other = port_def.make_module(generator=torch.Generator().manual_seed(4))
    want = module.state_dict()
    assert sorted(fresh.state_dict()) == sorted(want)
    differs = False
    for (k, a), b, c in zip(fresh.state_dict().items(), again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.shape == want[k].shape and a.dtype == want[k].dtype, k
        differs = differs or not torch.equal(a, c)
    assert differs


def test_inits_follow_the_reference():
    """deepwalk's table uniform on [-1, 1); ensfm's tables truncated at
    ±0.02 and H at 0.01; mhcn's tables truncated at ±0.01."""
    g = torch.Generator().manual_seed(0)
    table = get_model_class("recall.deepwalk")(Config(flat_config(
        "recall.deepwalk"))).make_module(generator=g).node_embedding.embedding
    assert -1 <= float(table.min()) < -0.9 and 0.9 < float(table.max()) < 1
    ensfm = get_model_class("recall.ensfm")(Config(flat_config("recall.ensfm"))).make_module(
        generator=g)
    assert float(ensfm.user_feature_emb.embedding.abs().max()) <= 0.02
    assert torch.all(ensfm.H_i == 0.01) and torch.all(ensfm.bias == 0)
    mhcn = get_model_class("recall.mhcn")(Config(flat_config("recall.mhcn"))).make_module(
        generator=g)
    assert float(mhcn.user_embeddings.abs().max()) <= 0.01
    mind = get_model_class("recall.mind")(Config(flat_config("recall.mind"))).make_module(
        generator=g)
    assert mind.routing.routing_logits.requires_grad
    assert mind.routing.routing_logits.shape == (1, 3, 7)


def test_reference_shapes_of_the_graph_registrations():
    """graph.lightgcn and graph.transformer_conv default their conv and
    sage mode; graph.deepwalk_million is the pure skip-gram; an explicit
    key wins, as the JAX package's ``setdefault``."""
    for model, conv, hops in (("graph.lightgcn", "lightgcn", 2),
                              ("graph.transformer_conv", "transformer_conv", 2),
                              ("graph.deepwalk_million", "lightgcn", 0)):
        pd = get_model_class(model)(Config(flat_config(model)))
        jd, _ = reference(model)
        assert (pd.conv_type, len(pd.samples), pd.sage_mode) == (
            conv, hops, jd.sage_mode)
    pd = get_model_class("graph.lightgcn")(Config(flat_config(
        "graph.lightgcn", **{"hyper_parameters.sage_layer_type": "gin"})))
    assert pd.conv_type == "gin"
