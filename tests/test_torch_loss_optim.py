"""Loss and optimizer steps of the port against optax: ``binary_logloss``,
and ten steps of Adam, SGD, Adagrad, RMSProp, AdamW, lazy Adam, the
global-norm clip, ``embedding_l2`` and the runtime-injected hyperparameters
from identical parameters and identical gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlerec_tpu.models import base as jax_base
from paddlerec_tpu_torch.convert import (
    _to_numpy, adam_state_from_optax, adam_state_to_optax, from_jax_params,
)
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.models import base as port_base
from paddlerec_tpu_torch.train.optimizers import Optimizer

torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [False, True])
def test_binary_logloss_matches_optax(masked):
    rng = np.random.RandomState(0)
    logits = (rng.randn(64) * 4).astype(np.float32)
    logits[:4] = [-60.0, 60.0, 0.0, -0.0]  # the stable form's far ends
    labels = (rng.rand(64) < 0.4).astype(np.float32)
    mask = (rng.rand(64) < 0.8).astype(np.float32) if masked else None
    ref = jax_base.binary_logloss(jnp.asarray(logits), jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask))
    out = port_base.binary_logloss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    zero = port_base.binary_logloss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    torch.zeros(64))
    assert float(zero) == 0.0  # an all-masked batch divides by max(0, 1)


def _tree(rng, table_dtype):
    return {
        "embedding": {"embedding": jnp.asarray(rng.randn(40, 128) * 0.01, table_dtype)},
        "tower": {"fc_0": {"kernel": jnp.asarray(rng.randn(12, 8), jnp.float32),
                           "bias": jnp.zeros((8,), jnp.float32)}},
        "fm_bias": jnp.zeros((), jnp.float32),
    }


def _grads(rng, params, step):
    def leaf(p):
        g = rng.randn(*p.shape) * (0.1 if step % 3 else 1e-4)
        if p.ndim == 2 and p.shape[1] == 128:
            g[step::5] = 0.0  # rows no id touched
        return jnp.asarray(g, p.dtype)
    return jax.tree.map(leaf, params)


def _config(**hyper):
    flat = {"hyper_parameters.optimizer.learning_rate": 0.01}
    flat.update({f"hyper_parameters.{k}": v for k, v in hyper.items()})
    return Config(flat)


# optimizer class, clip_by_norm, table dtype, parameter tolerance.  f32: each
# step's elementwise arithmetic is the same, up to the last bit (XLA fuses
# a*b + c and rewrites (m / c) / d as m / (c * d)).  bf16 table: such a
# last-bit difference in the f32 update can flip the rounding of a bf16
# parameter, which is then one bf16 ulp off (2^-8 relative: 4.9e-4 for
# |p| in [0.0625, 0.125)); measured: 4 of 5120 elements differ, by one ulp.
CASES = [
    ("Adam", None, "float32", 1e-6),
    ("Adam", 0.5, "float32", 1e-6),
    ("SGD", None, "float32", 1e-6),
    ("Adagrad", 1.0, "float32", 1e-6),
    ("Adam", None, "bfloat16", 5e-4),
]


@pytest.mark.parametrize("name,clip,dtype,atol", CASES)
def test_ten_steps_match_optax(name, clip, dtype, atol):
    hyper = {"optimizer.class": name, "sparse_feature_dtype": dtype}
    if clip:
        hyper["clip_by_norm"] = clip
    cfg = _config(**hyper)
    tx = jax_base.ModelDef(cfg).create_optimizer()
    port_tx = port_base.ModelDef(cfg).create_optimizer()
    assert isinstance(port_tx, Optimizer) and port_tx.name == name.lower()

    rng = np.random.RandomState(1)
    params = _tree(rng, jnp.dtype(dtype))
    opt_state = tx.init(params)
    port_params = {k: v.clone() for k, v in from_jax_params(
        jax.tree.map(np.asarray, params)).items()}
    port_state = port_tx.init(port_params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for step in range(10):
        grads = _grads(rng, params, step)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = from_jax_params(jax.tree.map(np.asarray, grads))
        port_tx.apply(port_params, port_grads, port_state)

    want = from_jax_params(jax.tree.map(np.asarray, params))
    for k, p in port_params.items():
        assert p.dtype == want[k].dtype and p.shape == want[k].shape, k
        np.testing.assert_allclose(p.float().numpy(), want[k].float().numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    if name == "Adam":
        ref = adam_state_from_optax(opt_state)
        assert port_state["count"] == ref["count"] == 10
        for k in port_params:
            mu, nu = port_state["mu"][k], port_state["nu"][k]
            assert mu.dtype == torch.float32 == ref["mu"][k].dtype, k
            assert nu.dtype == ref["nu"][k].dtype == port_params[k].dtype, k
            # a fused multiply-add against a product and a sum: the last bit
            # of terms up to 0.1, which counts where they cancel
            np.testing.assert_allclose(mu.numpy(), ref["mu"][k].numpy(),
                                       rtol=1e-6, atol=1e-8, err_msg=k)
            if nu.dtype == torch.float32:
                np.testing.assert_allclose(nu.numpy(), ref["nu"][k].numpy(),
                                           rtol=1e-6, atol=1e-12, err_msg=k)
            else:  # every bf16 operation rounds as XLA's does
                assert torch.equal(nu, ref["nu"][k]), k
        back = adam_state_to_optax(port_state)
        assert back["count"] == 10 and back["count"].dtype == np.int32
        assert back["mu"]["tower"]["fc_0"]["kernel"].shape == (12, 8)
        np.testing.assert_array_equal(
            back["nu"]["embedding"]["embedding"].astype(np.float32),
            _to_numpy(port_state["nu"]["embedding.embedding"]).astype(np.float32))


@pytest.mark.parametrize("key,value", [
    ("optimizer.class", "rmsprop"), ("optimizer.class", "adamw"),
    ("optimizer.lazy_mode", True), ("optimizer.runtime_inject", True),
    ("embedding_l2", 1e-4), ("sparse_update", True),
])
def test_unported_optimizer_keys_raise(key, value):
    """These keys raised ``NotImplementedError`` until their code was ported.
    Now each builds its optimizer; the keys that still raise are held in
    ``test_keys_that_are_not_ported_raise_by_name``.  What is left to raise
    here is the reference's own refusal: ``runtime_inject`` with
    ``sparse_update``."""
    tx = port_base.ModelDef(_config(**{key: value})).create_optimizer()
    assert isinstance(tx, Optimizer)
    both = _config(**{"optimizer.runtime_inject": True, "sparse_update": True})
    for base in (port_base, jax_base):
        with pytest.raises(ValueError, match="runtime_inject does not compose"):
            base.ModelDef(both).create_optimizer()


# hyper-parameters, the change made to the injected values after step 4 (or
# None).  Float32 leaves, but for the ``_bf16`` cases, whose table is
# bfloat16 (``sparse_feature_dtype``): each bfloat16 operation rounds as XLA
# rounds it, so the table is held at Adam's bfloat16 bound of CASES below,
# one bfloat16 ulp on at most 0.1% of its elements.
NEW_KEYS = {
    "rmsprop": ({"optimizer.class": "rmsprop"}, None),
    "rmsprop_bf16": ({"optimizer.class": "rmsprop", "sparse_feature_dtype": "bfloat16"},
                     None),
    "adamw": ({"optimizer.class": "adamw", "optimizer.weight_decay": 0.05}, None),
    "adamw_bf16": ({"optimizer.class": "adamw", "optimizer.weight_decay": 0.05,
                    "sparse_feature_dtype": "bfloat16"}, None),
    "lazy_adam": ({"optimizer.lazy_mode": True}, None),
    "lazy_adam_bf16": ({"optimizer.lazy_mode": True, "sparse_feature_dtype": "bfloat16"},
                       None),
    "lazy_adam_clip": ({"optimizer.lazy_mode": True, "clip_by_norm": 0.5}, None),
    "embedding_l2": ({"embedding_l2": 0.3}, None),
    "embedding_l2_sgd_clip": ({"optimizer.class": "SGD", "embedding_l2": 0.3,
                               "clip_by_norm": 1.0}, None),
    "runtime_inject": ({"optimizer.runtime_inject": True, "embedding_l2": 0.2,
                        "clip_by_norm": 2.0},
                       {"learning_rate": 0.003, "embedding_l2": 0.0}),
    "runtime_inject_adagrad": ({"optimizer.runtime_inject": True,
                                "optimizer.class": "adagrad"},
                               {"learning_rate": 0.05}),
}


@pytest.mark.parametrize("case", sorted(NEW_KEYS))
def test_ten_steps_of_the_newly_ported_keys_match_optax(case):
    hyper, retune = NEW_KEYS[case]
    cfg = _config(**hyper)
    tx = jax_base.ModelDef(cfg).create_optimizer()
    port_tx = port_base.ModelDef(cfg).create_optimizer()
    rng = np.random.RandomState(4)
    params = _tree(rng, jnp.dtype(hyper.get("sparse_feature_dtype", "float32")))
    opt_state = tx.init(params)
    port_params = {k: v.clone() for k, v in from_jax_params(
        jax.tree.map(np.asarray, params)).items()}
    port_state = port_tx.init(port_params)
    start = {k: v.clone() for k, v in port_params.items()}
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for step in range(10):
        if retune and step == 5:
            hp = {k: jnp.asarray(retune.get(k, v), jnp.float32)
                  for k, v in opt_state.hyperparams.items()}
            opt_state = opt_state._replace(hyperparams=hp)
            port_state["hyperparams"].update(retune)
        grads = _grads(rng, params, step)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_tx.apply(port_params, from_jax_params(jax.tree.map(np.asarray, grads)),
                      port_state)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    for k, p in port_params.items():
        assert p.dtype == want[k].dtype, k
        if p.dtype == torch.bfloat16:
            _assert_within_one_ulp_on_few(p, want[k], k)
        else:
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert max(float((p.float() - start[k].float()).abs().max())
               for k, p in port_params.items()) > 1e-3  # they did move
    if "hyperparams" in port_state:
        assert sorted(port_state["hyperparams"]) == sorted(opt_state.hyperparams)
        for k, v in opt_state.hyperparams.items():
            assert abs(port_state["hyperparams"][k] - float(v)) < 1e-9, k


def _assert_within_one_ulp_on_few(got, want, name):
    """bfloat16 leaves: equal but for one ulp (bit patterns of one sign one
    apart) on at most 0.1% of the elements."""
    a, b = got.view(torch.int16).int(), want.view(torch.int16).int()
    off = a != b
    assert int((a - b).abs().max()) <= 1 and bool(((a < 0) == (b < 0))[off].all()), name
    assert int(off.sum()) <= 0.001 * got.numel(), (name, int(off.sum()))


def test_lazy_adam_keeps_untouched_rows_and_their_moments():
    cfg = _config(**{"optimizer.lazy_mode": True})
    port_tx = port_base.ModelDef(cfg).create_optimizer()
    params = {"embedding.embedding": torch.ones(6, 128), "fm_bias": torch.ones(())}
    state = port_tx.init(params)
    for _ in range(3):
        g = torch.zeros(6, 128)
        g[[1, 4], 7] = 0.5
        port_tx.apply(params, {"embedding.embedding": g, "fm_bias": torch.ones(())}, state)
    table = params["embedding.embedding"]
    assert torch.equal(table[[0, 2, 3, 5]], torch.ones(4, 128))
    assert float(state["mu"]["embedding.embedding"][[0, 2, 3, 5]].abs().max()) == 0.0
    assert float((table[[1, 4]] - 1).abs().max()) > 1e-2 and state["count"] == 3


def test_unknown_optimizer_is_a_value_error():
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_base.ModelDef(_config(**{"optimizer.class": "lion"})).create_optimizer()
