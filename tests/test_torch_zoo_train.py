"""Training of the rank zoo in the port against the JAX package: ten steps of
the two trainers from the same parameters and batches; GRDA against the optax
transformation; AutoFIS's search stage with the two optimizers; sparse
row-wise updates from the config alone (and dcn's, which the reference leaves
frozen); dlrm's head dying under Adam in both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import optimizers as jax_optimizers
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import optimizers as port_optimizers
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.conftest import small_config
from tests.test_torch_sparse_train import _batches as sparse_batches
from tests.test_torch_sparse_train import _compare as compare_sparse
from tests.test_torch_sparse_train import _pair as sparse_pair
from tests.test_torch_sparse_train import _train_both as train_both_sparse
from tests.test_torch_zoo_common import SMALL, VOCAB, make_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS, BATCH = 10, 64


def _pair(tmp_path, model, **extra):
    opts = {**SMALL, "runner.train_batch_size": BATCH, "runner.infer_batch_size": BATCH,
            **extra}
    cfg = small_config(tmp_path, model=model, **opts)
    ref = jax_trainer_mod.Trainer(cfg, mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(cfg.to_dict()), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


def _batches(seed, dense_dim=13):
    """A planted signal, so that the loss falls and the gradients stay alive."""
    rng = np.random.RandomState(seed)
    weight = rng.randn(3 * VOCAB)
    out = []
    for i in range(STEPS):
        b = make_batch(1000 * seed + i, rows=BATCH, dense_dim=dense_dim)
        score = weight[b["sparse"]].mean(axis=1) * 6 + b["dense"].mean(axis=1) - 0.5
        b["label"] = (rng.rand(BATCH) < 1 / (1 + np.exp(-score))).astype(np.float32)
        out.append(b)
    return out


def _run_both(ref, port, batches):
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for batch in batches:
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    return ref_losses, port_losses, ref_ms, port_ms


def _compare_params(ref, port, atol, skip=()):
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        if k in skip:
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


# Loss and float32 leaves after ten Adam steps of lr 1e-3: 1e-5, as for deepfm
# (sums in another order; Adam's m / sqrt(v) keeps a relative error of the
# gradient).  The AUC buckets are equal but for a prediction on a bucket's
# edge, as the sparse runs state it.
@pytest.mark.parametrize("model,extra", [
    ("rank.dcn", {"hyper_parameters.l2_reg_cross": 0.001,
                  "hyper_parameters.clip_by_norm": 0.5}),
    ("rank.dcn_v2", {}),
    ("rank.xdeepfm", {}),
    ("rank.dlrm", {}),
    ("rank.ffm", {}),
])
def test_ten_steps_match_the_jax_trainer(tmp_path, model, extra):
    ref, port = _pair(tmp_path, model, **extra)
    ref_losses, port_losses, ref_ms, port_ms = _run_both(ref, port, _batches(1))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(port_losses)) and port.state.step == STEPS
    _compare_params(ref, port, 1e-5)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    for k, mu in port.state.opt_state["mu"].items():
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms["auc"][k].numpy() - np.asarray(ref_ms["auc"][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k
    if model == "rank.dcn":
        assert port.tx.clip == 0.5
        unclipped = _run_both(*_pair(tmp_path, model), _batches(1))[1]
        assert abs(unclipped[-1] - port_losses[-1]) > 1e-5  # clip and penalty did bite
    if model == "rank.ffm":  # both tables took their steps
        assert port.state.module.embedding.embedding.shape == (VOCAB, 39 * 9)
        assert float(port.state.opt_state["nu"]["first_weight.embedding"].max()) > 0


# -- GRDA -------------------------------------------------------------------------

def test_grda_matches_the_optax_transformation():
    """GRDA alone for ten steps against the jitted optax transformation, the
    reference's accumulator carried across: atol 1e-6, zeros exactly where
    the reference has zeros."""
    rng = np.random.RandomState(0)
    lr, c, mu = 0.05, 0.5, 0.8
    params = {"gate": rng.uniform(0.599, 0.601, 40).astype(np.float32),
              "block": {"w": (0.3 * rng.randn(4, 5)).astype(np.float32)}}
    tx = jax_optimizers.grda(lr, c=c, mu=mu)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    port_tx = port_optimizers.Optimizer("grda", lr=lr, grda_c=c, grda_mu=mu)
    pparams = {k: v.clone() for k, v in convert.from_jax_params(params).items()}
    own = port_tx.init(pparams)
    assert sorted(own) == ["accumulator", "count", "l1_accumulation"]
    for k, a in own["accumulator"].items():  # the port's own draw: uniform(-0.1, 0.1)
        assert a.shape == pparams[k].shape and -0.1 <= float(a.min()) < float(a.max()) <= 0.1
    again = port_tx.init(pparams)
    assert all(torch.equal(a, again["accumulator"][k]) for k, a in own["accumulator"].items())
    pstate = convert.grda_state_from_optax(jax.device_get(jstate))
    assert pstate["count"] == 0 and pstate["l1_accumulation"] == 0.0
    zeros = 0
    for i in range(STEPS):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 0.2, params)
        jparams, jstate = step(jparams, jstate, jax.tree.map(jnp.asarray, grads))
        port_tx.apply(pparams, convert.from_jax_params(grads), pstate)
        want = convert.from_jax_params(jax.tree.map(np.asarray, jparams))
        for k, v in want.items():
            np.testing.assert_allclose(pparams[k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {k}")
            assert torch.equal(pparams[k] == 0, v == 0), f"step {i} {k}"
            zeros += int((v == 0).sum())
    assert zeros > 0  # the threshold did drive weights to zero
    ref_state = convert.grda_state_from_optax(jax.device_get(jstate))
    assert pstate["count"] == ref_state["count"] == STEPS
    assert abs(pstate["l1_accumulation"] - ref_state["l1_accumulation"]) < 1e-6
    for k, a in ref_state["accumulator"].items():
        np.testing.assert_allclose(pstate["accumulator"][k].numpy(), a.numpy(),
                                   rtol=0, atol=1e-6)
    back = convert.grda_state_to_optax(pstate)
    assert back["count"].dtype == np.int32 and back["l1_accumulation"].dtype == np.float32
    assert sorted(back["accumulator"]) == ["block", "gate"]


AUTOFIS = {"hyper_parameters.optimizer.learning_rate": 0.01,
           "hyper_parameters.grad_c": 10.0, "hyper_parameters.grad_mu": 0.8}


def test_autofis_search_stage_matches_the_jax_trainer(tmp_path):
    """Stage 0 for ten steps: Adam on every leaf but the gate, GRDA on the
    gate, with the reference's accumulator carried across."""
    ref, port = _pair(tmp_path, "rank.autofis", **AUTOFIS)
    state = convert.multi_state_from_optax(jax.device_get(ref.state.opt_state))
    assert sorted(state) == sorted(port.state.opt_state) == ["dense", "gate"]
    assert sorted(state["gate"]["accumulator"]) == ["interaction_mask"]
    assert "interaction_mask" not in state["dense"]["mu"]
    assert sorted(state["dense"]["mu"]) == sorted(port.state.opt_state["dense"]["mu"])
    port.state.opt_state["gate"]["accumulator"]["interaction_mask"].copy_(
        state["gate"]["accumulator"]["interaction_mask"])
    ref_losses, port_losses, _, _ = _run_both(ref, port, _batches(3, dense_dim=0))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    # lr 1e-2: ten Adam steps move a leaf ten times as far as at 1e-3.  The
    # biases of the layers before a batch standardization are left out: the
    # standardization removes any constant, so their true gradient is zero,
    # what arrives is rounding noise (1e-9), and Adam's m / sqrt(v) turns noise
    # into steps of lr; the output does not depend on them (the losses agree).
    _compare_params(ref, port, 1e-4, skip=("bin_fc0.bias", "bin_fc1.bias"))
    after = convert.multi_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["gate"]["count"] == after["gate"]["count"] == STEPS
    assert port.state.opt_state["dense"]["count"] == after["dense"]["count"] == STEPS
    assert abs(port.state.opt_state["gate"]["l1_accumulation"]
               - after["gate"]["l1_accumulation"]) < 1e-6
    gate = port.state.module.interaction_mask.detach()
    want = np.asarray(jax.device_get(ref.state.params)["interaction_mask"])
    assert np.array_equal(gate.numpy() == 0, want == 0)
    back = convert.multi_state_to_optax(port.state.opt_state)
    assert sorted(back["gate"]) == ["accumulator", "count", "l1_accumulation"]
    assert sorted(back["dense"]) == ["count", "mu", "nu"]


def test_autofis_grda_sparsifies_gate_and_the_state_rides_the_checkpoint(tmp_path):
    """The port's search stage drives gates exactly to zero, from its own
    accumulator; the two-group state saves, loads and resumes."""
    cfg = Config(small_config(tmp_path, model="rank.autofis", **{
        **SMALL, **AUTOFIS, "runner.train_batch_size": 32}).to_dict())
    trainer = port_trainer_mod.Trainer(cfg, device="cpu")
    trainer.init_state(seed=0)
    md = trainer.model_def
    assert md.stage == 0
    batch = to_tensors(md.example_batch(32), CPU)
    ms = trainer._init_metric_state()
    for _ in range(60):
        ms, loss = trainer.train_step(batch, ms)
    gate = trainer.state.module.interaction_mask.detach().numpy()
    assert np.isfinite(float(loss))
    assert np.sum(gate == 0.0) > 0, f"no gate reached zero: {gate}"
    kept = md.selected_pairs(trainer.state.module.state_dict())
    assert len(kept) == int(np.sum(gate != 0.0))

    port_ckpt.save_model(trainer.state.module.state_dict(), trainer.state.opt_state,
                         str(tmp_path / "out"), 0)
    other = port_trainer_mod.Trainer(cfg, device="cpu")
    other.load_checkpoint(str(tmp_path / "out"), 0)
    assert other.state.opt_state["gate"]["count"] == 60
    assert other.state.opt_state["gate"]["l1_accumulation"] == \
        trainer.state.opt_state["gate"]["l1_accumulation"] > 0
    assert torch.equal(other.state.opt_state["gate"]["accumulator"]["interaction_mask"],
                       trainer.state.opt_state["gate"]["accumulator"]["interaction_mask"])
    trainer.train_step(batch, ms)
    other.train_step(batch, other._init_metric_state())
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(other.state.module.state_dict()[k], v), k

    # stage 1 retrains only the kept pairs, under Adam alone
    stage1 = Config({**cfg.to_dict(), "stage": 1,
                     "hyper_parameters.comb_mask": [0, 3, 7, 11]})
    retrain = port_trainer_mod.Trainer(stage1, device="cpu")
    retrain.init_state(seed=0)
    assert retrain.state.module.interaction_mask.shape == (4,)
    assert sorted(retrain.state.opt_state) == ["count", "mu", "nu"]
    _, loss = retrain.train_step(batch, retrain._init_metric_state())
    assert np.isfinite(float(loss))


# -- sparse row-wise updates from the config alone -----------------------------------

@pytest.mark.parametrize("name", ["rank.fm", "rank.dcn_v2", "rank.xdeepfm", "rank.autoint"])
def test_sparse_update_and_bf16_from_config_alone(name):
    """``sparse_update: true`` and ``sparse_feature_dtype: bfloat16`` reach the
    table of every model through ``CTRModelDef.table_kwargs``: one tapped
    bfloat16 table that takes no gradient, a captured per-position gradient,
    and rows that move."""
    flat = {
        "runner.model": name, "runner.train_batch_size": 8, "runner.infer_batch_size": 8,
        "hyper_parameters.sparse_inputs_slots": 5, "hyper_parameters.dense_input_dim": 4,
        "hyper_parameters.sparse_feature_number": 300, "hyper_parameters.sparse_feature_dim": 8,
        "hyper_parameters.fc_sizes": [16], "hyper_parameters.sparse_update": True,
        "hyper_parameters.sparse_feature_dtype": "bfloat16",
    }
    md = port_model_class(name)(Config(flat))
    module = md.make_module(device="cpu", generator=torch.Generator().manual_seed(0))
    taps = md.sparse_taps(module)
    assert list(taps) == ["embedding/embedding_delta"], name
    table = module.embedding.embedding
    assert table.dtype == torch.bfloat16 and not table.requires_grad
    assert module.embedding.delta_capacity == 4 * 8
    # the JAX package taps the same table under the same key
    jmd = jax_model_class(name)(JaxConfig(flat))
    jbatch = jax.tree.map(jnp.asarray, jmd.example_batch(8))
    jparams = jmd.init_with_batch(jax.random.PRNGKey(0), jbatch)
    assert sorted(jmd.init_sparse_state(jparams)) == list(taps)
    assert jparams["embedding"]["embedding"].dtype == jnp.bfloat16

    extra = md.init_sparse_state(module)
    host = md.augment_batch_host(md.example_batch(8))
    batch = to_tensors(host, CPU)
    loss, _ = md.train_forward(module, batch)
    loss.backward()
    grads = {k: emb.take_delta_grad() for k, emb in taps.items()}
    assert table.grad is None
    dgrad = grads["embedding/embedding_delta"]
    assert dgrad.dtype == torch.float32 and float(dgrad.abs().max()) > 0
    before = table.detach().clone()
    md.apply_sparse_updates(module, extra, grads, batch)
    assert not torch.equal(table.detach(), before), name
    touched = (table.detach() != before).any(dim=1).sum()
    assert 0 < int(touched) <= 4 * 8


@pytest.mark.parametrize("rule,dtype", [("adagrad", "bfloat16"), ("adam", "float32")])
def test_ten_sparse_steps_of_dcn_v2_match_the_jax_trainer(tmp_path, rule, dtype):
    ref, port = sparse_pair(tmp_path, model="rank.dcn_v2", **{
        "hyper_parameters.low_rank": 8, "hyper_parameters.num_experts": 3,
        "hyper_parameters.sparse_feature_dtype": dtype,
        "hyper_parameters.sparse_update_rule": rule})
    batches = sparse_batches(6)[:STEPS]
    compare_sparse(ref, port, *train_both_sparse(ref, port, batches), dtype, rule)


def test_sparse_dcn_steps_its_rows_where_the_reference_leaves_them(tmp_path):
    """With ``sparse_update: true`` the port's dcn hands its table to the
    row-wise rules like every other model.  The JAX dcn's own
    ``train_forward`` runs outside the embedding context: its table is read
    densely, frozen by the optimizer and never stepped.  Both behaviours are
    held here, so neither changes unseen; the losses part once the port's
    rows have moved."""
    ref, port = sparse_pair(tmp_path, model="rank.dcn")
    table = port.state.module.embedding.embedding
    assert list(port.model_def.sparse_taps(port.state.module)) == [
        "embedding/embedding_delta"]
    assert not table.requires_grad
    before = table.detach().clone()
    ref_before = np.asarray(jax.device_get(ref.state.params)["embedding"]["embedding"])
    ref_losses, port_losses, _, _ = train_both_sparse(ref, port, sparse_batches(6)[:3])
    assert abs(ref_losses[0] - port_losses[0]) < 1e-5  # the same first forward
    assert np.all(np.isfinite(port_losses))
    moved = (table.detach() != before).any(dim=1)
    assert 0 < int(moved.sum()) <= 3 * 64 * 26
    ref_after = np.asarray(jax.device_get(ref.state.params)["embedding"]["embedding"])
    assert ref_after.tobytes() == ref_before.tobytes()


def test_autofis_adam_keeps_a_bf16_table_moment_in_bf16(tmp_path):
    """AutoFIS builds ``optax.adam(lr)`` with no ``mu_dtype``, so a bfloat16
    table's first moment is bfloat16 there, where every other model's is
    float32; the port's ``Optimizer(mu_dtype=None)`` does the same."""
    ref, port = _pair(tmp_path, "rank.autofis", **{
        **AUTOFIS, "hyper_parameters.sparse_feature_dtype": "bfloat16"})
    state = convert.multi_state_from_optax(jax.device_get(ref.state.opt_state))
    key = "embedding.embedding"
    assert state["dense"]["mu"][key].dtype == torch.bfloat16
    mine = port.state.opt_state["dense"]
    assert mine["mu"][key].dtype == mine["nu"][key].dtype == torch.bfloat16
    assert all(m.dtype == torch.float32 for k, m in mine["mu"].items() if k != key)
    other = port_trainer_mod.Trainer(Config({
        **port.config.to_dict(), "runner.model": "rank.dcn_v2"}), device="cpu")
    other.init_state(seed=0)  # a model on the common optimizer: float32
    assert other.state.opt_state["mu"][key].dtype == torch.float32
    assert other.state.module.embedding.embedding.dtype == torch.bfloat16
    port.state.opt_state["gate"]["accumulator"]["interaction_mask"].copy_(
        state["gate"]["accumulator"]["interaction_mask"])
    ref_losses, port_losses, _, _ = _run_both(ref, port, _batches(3, dense_dim=0)[:1])
    after = convert.multi_state_from_optax(jax.device_get(ref.state.opt_state))
    # One step.  The looked-up vectors are bfloat16 and every layer is batch
    # standardized, which divides rounding noise by a small deviation: XLA
    # keeps float32 inside fused bfloat16 chains where PyTorch rounds each
    # operation, so the first loss (about 1) differs by 2.7e-4 and the table's
    # gradient, whose largest moment is 0.072, by up to 7.3e-4 (measured).
    assert abs(port_losses[0] - ref_losses[0]) < 1e-3
    want = after["dense"]["mu"][key].float().numpy()
    np.testing.assert_allclose(mine["mu"][key].float().numpy(), want, rtol=0, atol=2e-3)
    assert float(np.abs(want).max()) > 0.02 and mine["mu"][key].dtype == torch.bfloat16
    assert mine["count"] == after["dense"]["count"] == 1


# -- dlrm's head ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_dlrm_head_dies_in_both_packages_at_the_default_tower_sizes(seed):
    """``configs/rank/dlrm/config.yaml`` with only the vocabulary cut: each
    package from its own initialisation, the same 40 batches.  The MLP ends
    both towers in a ReLU, and under Adam the two-unit head reaches, in both
    packages, the state it cannot leave: both units at or below 0 on every
    row, every prediction exactly 0.5, the loss log 2 and no gradient.  (How
    many steps that takes depends on the draw: 1 to 22 here.)"""
    from paddlerec_tpu_torch.core.config import load_config
    from paddlerec_tpu_torch.data.synthetic import synthetic_batch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flat = dict(load_config(
        os.path.join(repo, "configs", "rank", "dlrm", "config.yaml")).to_dict())
    flat.update({"hyper_parameters.sparse_feature_number": VOCAB,
                 "runner.train_batch_size": 256, "runner.infer_batch_size": 256,
                 "runner.model_save_path": None, "runner.infer_load_path": None})
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=seed)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=seed)
    assert port.model_def.top_layer_sizes == [512, 256, 2]

    # the two initialisations are draws of one distribution, leaf by leaf
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if k.endswith(".bias"):
            assert not got[k].any() and not v.any(), k
        elif v.numel() >= 4096:
            assert abs(float(got[k].std()) / float(v.std()) - 1) < 0.05, k

    rng = np.random.RandomState(5)
    batches = [synthetic_batch(rng, 256, vocab=VOCAB) for _ in range(41)]
    ref_losses, port_losses, _, _ = _run_both(ref, port, batches[:40])
    log2 = float(np.log(2))
    for losses in (ref_losses, port_losses):
        assert np.all(np.isfinite(losses))
        assert abs(losses[0] - log2) > 1e-6  # alive at the start
        np.testing.assert_allclose(losses[-10:], log2, rtol=0, atol=1e-6)

    last = batches[40]
    grads = jax.grad(lambda p: ref.model_def.train_forward(p, jax.device_put(last))[0])(
        ref.state.params)
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(grads))
    preds = ref.model_def.infer_forward(ref.state.params, jax.device_put(last))["predictions"]
    assert np.all(np.asarray(preds) == 0.5)
    port.state.module.zero_grad()
    loss, aux = port.model_def.train_forward(port.state.module, to_tensors(last, CPU))
    loss.backward()
    for k, p in port.state.module.named_parameters():
        assert p.grad is None or not p.grad.any(), k
    assert torch.all(aux["predictions"] == 0.5)
