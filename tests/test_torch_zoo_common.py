"""Shared checks of the rank zoo's tests: one port model against the JAX
``ModelDef`` of the same name, from the same config, the JAX package's initial
parameters carried across with ``from_jax_params`` and one numpy-seeded
batch.  The parametrised tests live in ``test_torch_zoo_*.py``."""

import jax
import numpy as np
import torch

from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from tests.conftest import small_config

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB, BATCH = 2000, 32
# Criteo's 26 slots and 13 dense values at E = 9 (pad lanes in every packed
# row), narrow towers
SMALL = {
    "hyper_parameters.sparse_feature_number": VOCAB,
    "hyper_parameters.sparse_feature_dim": 9,
    "hyper_parameters.fc_sizes": [32, 16],
    "hyper_parameters.layer_sizes_dnn": [32, 16],
    "hyper_parameters.layer_sizes_cin": [12, 6],
    "hyper_parameters.bot_layer_sizes": [16, 9],
    "hyper_parameters.top_layer_sizes": [32, 2],
    "hyper_parameters.low_rank": 8,
    "hyper_parameters.num_experts": 3,
    "hyper_parameters.fen_layers_size": [32, 16],
    "hyper_parameters.width": 24,
    "hyper_parameters.depth": 2,
    "hyper_parameters.conv_filters": [6, 8],
    "hyper_parameters.new_maps": [3, 2],
}
# f32: summation order only.  bf16 table: the looked-up vectors are bf16 on
# both sides, and XLA may keep f32 between fused bf16 operations where PyTorch
# rounds after each, as for deepfm
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-4}


def make_batch(seed, rows=BATCH, dense_dim=13, zero_dense=False):
    """Hashed ids beyond the vocab, dense values in [0, 1) (or, with
    ``zero_dense``, a third of them exactly 0), a few masked rows."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(rows, max(dense_dim, 1)).astype(np.float32)
    if zero_dense:
        dense[rng.rand(*dense.shape) < 1 / 3] = 0.0
    return {
        "label": (rng.rand(rows) < 0.3).astype(np.float32),
        "sparse": rng.randint(0, 3 * VOCAB, (rows, 26)).astype(np.int64),
        "dense": dense,
        "mask": (rng.rand(rows) < 0.9).astype(np.float32),
    }


def build(tmp_path, model, dtype="float32", seed=0, **extra):
    """(JAX ModelDef, its initial params as numpy, port ModelDef, the port's
    module holding those params)."""
    opts = {**SMALL, "hyper_parameters.sparse_feature_dtype": dtype, **extra}
    top = {k: opts.pop(k) for k in list(opts) if "." not in k}
    cfg = small_config(tmp_path, model=model, **opts)
    flat = {**cfg.to_dict(), **top}
    jax_def = jax_model_class(model)(type(cfg)(flat))
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(seed)))
    port_def = port_model_class(model)(Config(flat))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, params, port_def, module


def check_forward_and_loss(tmp_path, model, dtype, atol=None, **extra):
    jax_def, params, port_def, module = build(tmp_path, model, dtype, **extra)
    atol = TOLERANCE[dtype] if atol is None else atol
    batch = make_batch(1, dense_dim=port_def.dense_dim)
    jbatch = jax.tree.map(jax.numpy.asarray, batch)
    ref = jax_def.infer_forward(params, jbatch)
    with torch.no_grad():
        out = port_def.infer_forward(module.eval(), to_tensors(batch, CPU))
    assert out["predictions"].dtype == torch.float32
    np.testing.assert_allclose(out["predictions"].numpy(), np.asarray(ref["predictions"]),
                               rtol=0, atol=atol)
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU))
    want, _ = jax_def.train_forward(params, jbatch)
    assert abs(float(loss.detach()) - float(want)) < atol
    assert sorted(aux) == ["labels", "mask", "predictions"]
    return module


def check_gradients(tmp_path, model, atol=1e-5, batch=None, **extra):
    """The gradient of every leaf against ``jax.grad`` of ``train_forward``."""
    jax_def, params, port_def, module = build(tmp_path, model, **extra)
    if batch is None:
        batch = make_batch(2, dense_dim=port_def.dense_dim)
    jbatch = jax.tree.map(jax.numpy.asarray, batch)
    grads = jax.grad(lambda p: jax_def.train_forward(p, jbatch)[0])(params)
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    loss, _ = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    got = {k: p.grad for k, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in got.values())
    return got, want


def check_names_round_trip_and_seed(tmp_path, model, **extra):
    _, params, port_def, module = build(tmp_path, model, "bfloat16", **extra)
    flat, back = flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        assert v.dtype == back[k].dtype and v.shape == back[k].shape, k
        assert v.tobytes() == back[k].tobytes(), k
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(3))
    again = port_def.make_module(generator=torch.Generator().manual_seed(3))
    other = port_def.make_module(generator=torch.Generator().manual_seed(4))
    differs = False
    for (k, a), b, c in zip(fresh.state_dict().items(), again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.shape == module.state_dict()[k].shape, k
        differs = differs or not torch.equal(a, c)
    assert differs
    return module
