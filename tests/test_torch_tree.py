"""The tree family in the port against the JAX package: ``TreeIndex`` (both
builders, the level sets, ``sample`` for one ``RandomState``, the ``.npz``
both ways), ``TDMNet`` and its gradients, the beam-search ``retrieve`` (ties
and a ragged tree included), ``TDMDataset``, ten trainer steps, and JTM: the
numpy tree learning given one weight function, ``model_weight_fn`` and the
whole loop through ``tools/jtm.py --device cpu``.

Tolerances: the tree, its samples, the datasets' batches and the re-learned
trees bitwise; outputs, losses and every gradient 1e-5; ten trainer steps'
losses and leaves 1e-5, Adam's first moment 1e-6, the AUC buckets equal but
for ≤ 2 predictions on a bucket's edge; ``model_weight_fn`` 1e-6; the item
lists of ``retrieve`` equal (``top_k`` orders ties as ``jax.lax.top_k``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.models.treebased import jtm as jax_jtm
from paddlerec_tpu.models.treebased.tree import TreeIndex as JaxTree
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.models.treebased import jtm as port_jtm
from paddlerec_tpu_torch.models.treebased.tree import TreeIndex as PortTree
from paddlerec_tpu_torch.ops.layers import top_k
from paddlerec_tpu_torch.train import trainer as port_trainer_mod

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_ITEMS = 32
SMALL = {"hyper_parameters.node_emb_size": 8, "hyper_parameters.fea_groups": "4,4,2",
         "hyper_parameters.neg_sampling_list": 2,
         "hyper_parameters.optimizer.class": "Adam",
         "hyper_parameters.optimizer.learning_rate": 0.001}


def _embeddings(n=N_ITEMS, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(n // 2, dim) + 3, rng.randn(n - n // 2, dim) - 3])


def _trees(kind="kmeans", n=N_ITEMS):
    """(JAX tree, port tree) built alike: by k-means over two clusters, or
    by category (5 categories: a ragged tree unless n is a power of 2)."""
    ids = np.arange(n)
    if kind == "kmeans":
        emb = _embeddings(n)
        return JaxTree.build_by_kmeans(ids, emb), PortTree.build_by_kmeans(ids, emb)
    cats = np.random.RandomState(3).randint(0, 5, n)
    return JaxTree.build_by_category(ids, cats), PortTree.build_by_category(ids, cats)


def _same_tree(a, b):
    assert a.branch == b.branch and a.max_level == b.max_level
    assert a.total_nodes == b.total_nodes
    np.testing.assert_array_equal(a.item_ids, b.item_ids)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert len(a.level_codes) == len(b.level_codes)
    for x, y in zip(a.level_codes, b.level_codes):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,n", [("kmeans", 32), ("kmeans", 23), ("category", 23),
                                    ("category", 64)])
def test_tree_builders_and_samples_are_bitwise(kind, n, tmp_path):
    jt, pt = _trees(kind, n)
    _same_tree(jt, pt)
    targets = np.random.RandomState(1).randint(0, n + 3, 40)  # unknown items too
    for neg in (1, 3):
        a = jt.sample(targets, neg, np.random.RandomState(7))
        b = pt.sample(targets, neg, np.random.RandomState(7))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert jt.beam_layers(4)[0].tolist() == pt.beam_layers(4)[0].tolist()
    assert jt.leaf_items(jt.codes[::-1]) == pt.leaf_items(pt.codes[::-1])
    # each package reads the other's file
    pt.save(str(tmp_path / "port"))
    jt.save(str(tmp_path / "jax"))
    _same_tree(JaxTree.load(str(tmp_path / "port")), pt)
    _same_tree(PortTree.load(str(tmp_path / "jax.npz")), jt)


def _build(tree_kind="kmeans", n=N_ITEMS, **extra):
    """(JAX ModelDef, its params from seed 0, port ModelDef, a port module
    holding them), both on the same tree."""
    flat = dict(SMALL, **extra)
    jt, pt = _trees(tree_kind, n)
    jax_def = jax_model_class("treebased.tdm")(JaxConfig(flat))
    jax_def.set_tree(jt)
    port_def = port_model_class("treebased.tdm")(Config(flat))
    port_def.set_tree(pt)
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(0)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(convert.from_jax_params(params))
    return jax_def, params, port_def, module


def _batch(md, rows, seed):
    b = md.example_batch(rows)
    rng = np.random.RandomState(seed)
    b["hist_ids"] = rng.randint(0, md.total_nodes, b["hist_ids"].shape).astype(np.int64)
    b["unit_codes"] = rng.randint(0, md.total_nodes, b["unit_codes"].shape).astype(np.int64)
    # unknown items: code 0 under mask 0, a whole group and a whole row of them
    b["hist_ids"][0, :4] = 0
    b["hist_mask"][0, :4] = 0.0
    b["hist_ids"][1] = 0
    b["hist_mask"][1] = 0.0
    b["unit_mask"][2, ::3] = 0.0
    return b


def test_tdm_forward_loss_and_every_gradient_match_jax():
    jax_def, params, port_def, module = _build()
    batch = _batch(port_def, 6, 2)
    (want, aux), grads = jax.value_and_grad(jax_def.train_forward, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, port_aux = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=0, atol=1e-5)
    for k in ("predictions", "labels", "mask"):
        np.testing.assert_allclose(port_aux[k].detach().numpy(), np.asarray(aux[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    want_grads = convert.from_jax_params(jax.tree.map(np.asarray, grads))
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    # the round trip to flax names is bitwise
    back = convert.to_jax_params(convert.from_jax_params(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(params) == {"node_emb", "group_proj", "relu_fc", "cos_sim_fc"}


def _histories(tree, rows, seed, length=10):
    rng = np.random.RandomState(seed)
    return np.take(tree.codes, rng.randint(0, len(tree.codes), (rows, length)))


@pytest.mark.parametrize("tree_kind,n,beam,topk", [("kmeans", 32, 8, 5),
                                                  ("category", 23, 4, 6),
                                                  ("category", 100, 6, 10)])
def test_retrieve_returns_the_jax_item_lists(tree_kind, n, beam, topk):
    """Beam search on a complete and on ragged trees (invalid children score
    -1.0 and tie)."""
    jax_def, params, port_def, module = _build(tree_kind, n)
    hist = _histories(port_def.tree, 7, 4)
    mask = np.ones(hist.shape, np.float32)
    mask[0, 5:] = 0.0
    want = jax_def.retrieve(params, jnp.asarray(hist), jnp.asarray(mask), topk=topk, beam=beam)
    got = port_def.retrieve(module, torch.from_numpy(hist), torch.from_numpy(mask),
                            topk=topk, beam=beam)
    assert got == want
    assert all(1 <= len(r) <= topk for r in got)


def test_retrieve_breaks_ties_as_jax():
    """Every valid candidate scores the same (a zero head): each level keeps
    the lowest positions, as ``jax.lax.top_k`` does."""
    jax_def, params, port_def, module = _build("category", 23)
    params = jax.tree.map(np.zeros_like, params)
    module.load_state_dict(convert.from_jax_params(params))
    hist = _histories(port_def.tree, 3, 5)
    mask = np.ones(hist.shape, np.float32)
    want = jax_def.retrieve(params, jnp.asarray(hist), jnp.asarray(mask), topk=5, beam=4)
    got = port_def.retrieve(module, torch.from_numpy(hist), torch.from_numpy(mask), topk=5,
                            beam=4)
    assert got == want and len(set(map(tuple, got))) == 1


def test_retrieve_follows_set_tree():
    """A module that retrieved on one tree retrieves on the tree that
    ``set_tree`` gives next (same node count, 17 leaves in place of 23) as
    JAX does: the validity table built for the first tree is not reused."""
    jax_def, params, port_def, module = _build("category", 23)
    hist = _histories(port_def.tree, 5, 6)
    mask = np.ones(hist.shape, np.float32)
    port_def.retrieve(module, torch.from_numpy(hist), torch.from_numpy(mask), topk=6, beam=4)
    jt, pt = _trees("category", 17)
    assert pt.total_nodes == port_def.total_nodes
    jax_def.set_tree(jt)
    port_def.set_tree(pt)
    hist = _histories(pt, 5, 6)
    want = jax_def.retrieve(params, jnp.asarray(hist), jnp.asarray(mask), topk=6, beam=4)
    got = port_def.retrieve(module, torch.from_numpy(hist), torch.from_numpy(mask), topk=6,
                            beam=4)
    assert got == want


def test_top_k_orders_ties_as_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 4, (50, 30)).astype(np.float32)  # many ties
    x[:, ::7] = -1.0
    for k in (1, 5, 30):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _write_lines(path, tree, rows, seed, malformed=True):
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "part-0"), "w") as f:
        for r in range(rows):
            hist = rng.choice(tree.item_ids, rng.randint(1, 14))
            if r % 9 == 0:
                hist[0] = 10_000  # an unknown item: code 0, mask 0
            f.write(" ".join(map(str, hist)) + f" | {rng.choice(tree.item_ids)}\n")
            if malformed and r % 13 == 0:
                f.write("1 2 x | 3\n" if r % 2 else "4 5 6 |\n")


def test_dataset_batches_are_bitwise(tmp_path):
    jax_def, _, port_def, _ = _build()
    _write_lines(str(tmp_path / "d"), port_def.tree, 45, 0)
    want = list(jax_def.make_dataset(str(tmp_path / "d"), 8))
    got = list(port_def.make_dataset(str(tmp_path / "d"), 8))
    assert len(got) == len(want) == 6  # 45 rows, the malformed lines skipped
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ten_trainer_steps_match_the_jax_trainer(tmp_path):
    jt, _ = _trees()
    jt.save(str(tmp_path / "tree"))
    flat = dict(SMALL, **{"runner.model": "treebased.tdm", "runner.train_batch_size": 8,
                          "runner.seed": 0,
                          "hyper_parameters.tree_path": str(tmp_path / "tree.npz")})
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    assert port.model_def.total_nodes == ref.model_def.total_nodes == jt.total_nodes
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    _write_lines(str(tmp_path / "d"), jt, 80, 1, malformed=False)
    batches = list(ref.model_def.make_dataset(str(tmp_path / "d"), 8))
    assert len(batches) == 10
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for batch in batches:
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert len(set(port_losses)) > 1
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    for k, mu in port.state.opt_state["mu"].items():
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms["auc"][k].numpy() - np.asarray(ref_ms["auc"][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k


def _weight_fn(seed):
    """A numpy weight function, the same object for both packages: random
    weights, fixed per (item, node), with near-ties (the float32 values
    repeat a few levels)."""
    def fn(items, nodes):
        items = np.asarray(items, np.int64).reshape(-1)
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        h = (items[:, None] * 7919 + nodes[None, :] * 104729 + seed) % 1009
        return (h % 17).astype(np.float32) / np.float32(17.0) + (h / 1e6).astype(np.float32)
    return fn


@pytest.mark.parametrize("kind,n,gap", [("kmeans", 16, 2), ("kmeans", 32, 1),
                                        ("category", 23, 3), ("category", 50, 2)])
def test_tree_learning_is_bitwise_given_one_weight_function(kind, n, gap):
    jt, pt = _trees(kind, n)
    fn = _weight_fn(n)
    _same_tree(jax_jtm.tree_learning(jt, fn, gap=gap), port_jtm.tree_learning(pt, fn, gap=gap))


def test_assign_parent_rebalances_as_jax():
    """Every item prefers one subtree: the capacity sends the rest to their
    next choices, in the same order in both packages."""
    jt, pt = _trees("category", 23)
    cands = port_jtm.descendants_at(pt, 0, 2)
    fav = set(port_jtm.path_codes(int(cands[0]), 0, pt.branch))

    def fn(items, nodes):
        nodes = np.asarray(nodes).reshape(-1)
        row = np.asarray([5.0 if int(c) in fav else 1.0 for c in nodes], np.float32)
        return np.tile(row, (len(items), 1)) + _weight_fn(1)(items, nodes) * 0.01

    items = [int(i) for i in pt.item_ids]
    origin = {it: int(c) for it, c in zip(items, port_jtm.descendants_at(pt, 0, 2)[
        np.arange(len(items)) % len(cands)])}
    want = jax_jtm.assign_parent(jt, jt.max_level, 2, 0, items, fn, origin)
    got = port_jtm.assign_parent(pt, pt.max_level, 2, 0, items, fn, origin)
    assert got == want and len(got) == len(items)
    caps = port_jtm.stage_capacities(pt, 2)
    counts = np.bincount(list(got.values()))
    assert all(counts[c] <= caps.get(c, 0) for c in set(got.values()))


def test_model_weight_fn_matches_jax():
    jax_def, params, port_def, module = _build()
    rng = np.random.RandomState(6)
    items = np.arange(N_ITEMS)
    samples = {int(i): _histories(port_def.tree, rng.randint(1, 4), 10 + int(i), length=10)
               for i in items[::2]}  # odd items have no sample: weight 0
    nodes = np.concatenate([port_def.tree.level_codes[2], port_def.tree.level_codes[4][:13]])
    want = jax_jtm.model_weight_fn(jax_def, params, samples, 3, code_chunk=8,
                                   item_chunk=4)(items, nodes)
    got = port_jtm.model_weight_fn(module, samples, 3, code_chunk=8,
                                   item_chunk=4)(items, nodes)
    assert got.shape == want.shape == (N_ITEMS, len(nodes)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[1::2].any() and got[::2].min() > 0


def test_jtm_through_the_cli_on_the_cpu(tmp_path):
    """``tools/jtm.py --device cpu`` on ``configs/treebased/jtm/config.yaml``:
    each round re-learns a valid permutation of the items onto the leaves
    and writes its tree file, as ``tests/test_jtm.py`` asks of JAX."""
    from paddlerec_tpu_torch.tools import jtm as jtm_cli

    n_items = 16
    ids = np.arange(1, n_items + 1, dtype=np.int64)
    tree = PortTree.build_by_kmeans(ids, np.random.RandomState(0).rand(n_items, 4))
    tree.save(str(tmp_path / "tree"))
    data = tmp_path / "train"
    data.mkdir()
    rng = np.random.RandomState(0)
    with open(data / "part-0", "w") as f:
        for _ in range(96):
            hist = rng.randint(1, n_items + 1, 6)
            f.write(" ".join(map(str, hist)) + f" | {rng.randint(1, n_items + 1)}\n")
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "treebased", "jtm",
                          "config.yaml")
    out = tmp_path / "out"
    metrics = jtm_cli.main([
        "-m", config, "--device", "cpu", "-o", f"runner.train_data_dir={data}",
        f"runner.model_save_path={out}", f"hyper_parameters.tree_path={tmp_path / 'tree.npz'}",
        "runner.train_batch_size=16", "runner.print_interval=100",
        "hyper_parameters.fea_groups=3,3", "hyper_parameters.node_emb_size=8",
        "hyper_parameters.jtm_gap=2", "hyper_parameters.jtm_sample_nums=2",
        "hyper_parameters.optimizer.learning_rate=0.01"])
    assert metrics["ips"] > 0 and 0.0 <= metrics["auc"] <= 1.0
    for r in (0, 1):
        new = PortTree.load(str(out / f"jtm_tree_round{r}.npz"))
        assert sorted(new.item_ids.tolist()) == list(range(1, n_items + 1))
        assert len(set(new.codes.tolist())) == n_items
        assert {new._level(int(c)) for c in new.codes} == {tree.max_level}
    # each round's training saved its epoch's checkpoint
    assert (out / "0" / "state" / "checkpoint.pt").exists()
