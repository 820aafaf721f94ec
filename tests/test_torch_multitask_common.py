"""Shared pieces of the multitask family's tests (share_bottom, mmoe, ple,
esmm, aitm, escm2, dselect_k, maml, metaheac): small configs (37 Census
features, three experts of 8, an Ali-CCP vocabulary of 300 at the default
E = 12, dselect_k with three experts, maml 2-way on 16×16 images with two
inner steps, metaheac with tables of a few rows and two tasks),
numpy-seeded batches in each model's layout (masked rows and empty fields
among them), and the checks of one port model against the JAX ``ModelDef``
of the same name from the JAX package's initial parameters.

ple also runs at ``level_number: 2`` (``multitask.ple@2``) and escm2 in both
counterfactual modes (``multitask.escm2@DR`` is the doubly robust one)."""

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
BATCH = 8
CENSUS = ("multitask.share_bottom", "multitask.mmoe", "multitask.ple", "multitask.ple@2")
ALI_CCP = ("multitask.esmm", "multitask.aitm", "multitask.escm2", "multitask.escm2@DR")
MODELS = CENSUS + ALI_CCP + ("multitask.dselect_k", "multitask.maml", "multitask.metaheac")
VOCAB = 300
FEATURES = 37
MAX_IDXS = [[3, 2, 9, 5, 7, 2, 1], [12, 8, 12, 30, 20, 10, 9], [7, 13, 4, 3, 3, 3]]

_CENSUS = {"feature_size": FEATURES}
HYPER = {
    "multitask.share_bottom": {**_CENSUS, "bottom_size": 16, "tower_size": 4},
    "multitask.mmoe": {**_CENSUS, "expert_num": 3, "expert_size": 8, "tower_size": 4},
    "multitask.ple": {**_CENSUS, "exp_per_task": 2, "shared_num": 1, "expert_size": 8,
                      "tower_size": 4},
    "multitask.esmm": {"sparse_feature_number": VOCAB, "ctr_fc_sizes": [16, 8],
                       "cvr_fc_sizes": [16, 8]},
    "multitask.aitm": {"sparse_feature_number": VOCAB, "tower_dims": [16, 12, 8]},
    "multitask.escm2": {"sparse_feature_number": VOCAB, "expert_num": 3, "expert_size": 8,
                        "tower_size": 4},
    "multitask.dselect_k": {"expert_num": 3, "expert_size": 8, "top_k": 2},
    "multitask.maml": {"n_way": 2, "k_spt": 1, "k_query": 2, "imgsize": 16,
                       "update_step": 2},
    "multitask.metaheac": {"max_idxs": MAX_IDXS, "embed_dim": 8, "mlp_dims": [8, 8],
                           "num_expert": 3, "num_output": 2, "task_count": 2},
}
# variants: (base model, extra flat keys)
VARIANTS = {
    "multitask.ple@2": ("multitask.ple", {"hyper_parameters.level_number": 2}),
    "multitask.escm2@DR": ("multitask.escm2", {"runner.counterfact_mode": "DR"}),
}
# the aux entry each model's outputs are compared on
OUTPUT_KEY = {"multitask.dselect_k": "probs", "multitask.maml": "correct",
              "multitask.metaheac": "predictions"}
TASKS = 2  # maml's tasks a batch (its batch size)


def base_name(model):
    return VARIANTS.get(model, (model, {}))[0]


def flat_config(model, **extra):
    """The flat config of ``model`` at its small size (Adam, lr 1e-3)."""
    base, variant = VARIANTS.get(model, (model, {}))
    batch = TASKS if base == "multitask.maml" else BATCH
    flat = {
        "runner.model": base, "runner.train_batch_size": batch,
        "runner.infer_batch_size": batch, "runner.epochs": 1,
        "runner.print_interval": 100, "runner.seed": 0,
        "hyper_parameters.optimizer.class": "Adam",
        "hyper_parameters.optimizer.learning_rate": 0.001,
        **{f"hyper_parameters.{k}": v for k, v in HYPER[base].items()},
        **variant,
    }
    flat.update(extra)
    return flat


def make_batch(model, seed, rows=BATCH):
    """A batch in ``model``'s layout at its small size; the last row masked
    where the layout has a mask."""
    base = base_name(model)
    rng = np.random.RandomState(seed)
    mask = np.ones(rows, np.float32)
    mask[-1] = 0.0
    if base in CENSUS:
        return {"dense": rng.rand(rows, FEATURES).astype(np.float32),
                "labels": (rng.rand(rows, 2) < 0.4).astype(np.float32), "mask": mask}
    if base in ALI_CCP:
        shape = (rows, 23, 3)
        # raw feature ids beyond the vocabulary (hashed), repeats among them
        sparse = rng.randint(0, 3 * VOCAB, shape).astype(np.int64)
        sparse_mask = (rng.rand(*shape) < 0.6).astype(np.float32)
        sparse_mask[0, :5] = 0.0  # empty fields
        click = (rng.rand(rows) < 0.5).astype(np.float32)
        conversion = click * (rng.rand(rows) < 0.5)
        return {"sparse": sparse, "sparse_mask": sparse_mask,
                "labels": np.stack([click, conversion], -1).astype(np.float32),
                "mask": mask}
    if base == "multitask.dselect_k":
        return {"image": rng.rand(rows, 36, 36, 1).astype(np.float32),
                "labels": rng.randint(0, 10, (rows, 2)).astype(np.int32), "mask": mask}
    if base == "multitask.maml":
        h = HYPER[base]
        s, n = h["imgsize"], h["n_way"]
        ns, nq = n * h["k_spt"], n * h["k_query"]
        # pixels in [-1, 1], as the episode sampler scales them
        return {"x_spt": rng.uniform(-1, 1, (TASKS, ns, s, s, 1)).astype(np.float32),
                "y_spt": rng.randint(0, n, (TASKS, ns)).astype(np.int32),
                "x_qry": rng.uniform(-1, 1, (TASKS, nq, s, s, 1)).astype(np.float32),
                "y_qry": rng.randint(0, n, (TASKS, nq)).astype(np.int32)}
    t = HYPER[base]["task_count"]
    static, dynamic, ad = MAX_IDXS

    def half(prefix):
        lens = np.stack([rng.randint(1, hi - lo + 1, (t, rows)) for lo, hi in
                         ((0, 10), (10, 20), (20, 30), (30, 35), (35, 40), (40, 45),
                          (45, 50))], -1)
        ids = np.concatenate([rng.randint(0, v + 1, (t, rows, w))
                              for v, w in zip(dynamic, (10, 10, 10, 5, 5, 5, 5))], -1)
        return {f"{prefix}_static": np.stack([rng.randint(0, v + 1, (t, rows))
                                              for v in static], -1).astype(np.int32),
                f"{prefix}_dynamic_ids": ids.astype(np.int32),
                f"{prefix}_dynamic_lengths": lens.astype(np.int32),
                f"{prefix}_ad": np.stack([rng.randint(0, v + 1, (t, rows))
                                          for v in ad], -1).astype(np.int32),
                f"{prefix}_label": (rng.rand(t, rows) < 0.4).astype(np.float32)}

    return {**half("spt"), **half("qry")}


@functools.lru_cache(maxsize=None)
def reference(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params from
    seed 0 as numpy), built once per test process."""
    jax_def = jax_model_class(base_name(model))(JaxConfig(flat_config(model)))
    params = jax.jit(jax_def.init_params)(jax.random.PRNGKey(0))
    return (jax_def, jax.jit(jax_def.train_forward),
            jax.tree.map(np.asarray, jax.device_get(params)))


def build(model):
    """(JAX ModelDef, its jitted ``train_forward``, its initial params, port
    ModelDef, the port's module holding those params)."""
    jax_def, forward, params = reference(model)
    port_def = port_model_class(base_name(model))(Config(flat_config(model)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, forward, params, port_def, module


def forward_and_loss(model, seed=1):
    """(port outputs from ``infer_forward``, JAX outputs of
    ``infer_forward``, port loss, JAX loss, port train aux, JAX train
    aux)."""
    jax_def, forward, params, port_def, module = build(model)
    batch = make_batch(model, seed)
    jbatch = jax.tree.map(jax.numpy.asarray, batch)
    want, ref_aux = forward(params, jbatch)
    ref_infer = jax.jit(jax_def.infer_forward)(params, jbatch)
    with port_def.infer_context():
        out = port_def.infer_forward(module.eval(), to_tensors(batch, CPU))
    loss, aux = port_def.train_forward(module, to_tensors(batch, CPU))
    assert sorted(aux) == sorted(ref_aux)
    key = OUTPUT_KEY.get(base_name(model), "probs" if base_name(model) in CENSUS else "ctr")
    return (out[key].numpy(), np.asarray(ref_infer[key]), float(loss.detach()), float(want),
            {k: v.detach().numpy() for k, v in aux.items()},
            {k: np.asarray(v) for k, v in ref_aux.items()})


@functools.lru_cache(maxsize=None)
def _jax_grad(model):
    jax_def, _, _ = reference(model)
    return jax.jit(jax.grad(lambda p, b: jax_def.train_forward(p, b)[0]))


def gradients(model, seed=2):
    """(port gradients, JAX gradients) of every leaf, as state_dict keys;
    for maml and metaheac the meta-gradient through the inner loop."""
    _, _, params, port_def, module = build(model)
    batch = make_batch(model, seed)
    grads = _jax_grad(model)(params, jax.tree.map(jax.numpy.asarray, batch))
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    loss, _ = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    return {k: p.grad for k, p in module.named_parameters()}, want


def names_round_trip(model):
    """The flat JAX tree and the port's tree after a round trip."""
    _, _, params, _, module = build(model)
    return flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))


def check_forward_and_loss(model):
    """Outputs, loss and every aux entry within 1e-5 (float32 sums in another
    order); maml's correct flags exactly."""
    out, want, loss, want_loss, aux, ref_aux = forward_and_loss(model)
    if base_name(model) == "multitask.maml":
        np.testing.assert_array_equal(out, want)
    else:
        assert np.ptp(out) > 0
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k], v, rtol=0, atol=1e-5, err_msg=k)


def check_gradients(model, scaled=False):
    """Every leaf's gradient against ``jax.grad`` of ``train_forward`` within
    atol 1e-5, or with ``scaled`` within 1e-5·(1 + the leaf's largest
    gradient); the same leaf names, and most leaves moved."""
    got, want = gradients(model)
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert got[k] is not None, k
        atol = 1e-5 * (1 + float(g.abs().max())) if scaled else 1e-5
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0, atol=atol, err_msg=k)
    moved = [k for k, g in got.items() if float(g.abs().max()) > 0]
    assert len(moved) >= 0.9 * len(got), sorted(set(got) - set(moved))


def check_names_and_seed(model):
    """``to_jax_params(from_jax_params(p))`` bitwise, and the port's own
    init: the same leaves and shapes, reproducible from a generator's seed,
    another seed another draw."""
    flat, back = names_round_trip(model)
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        assert v.dtype == back[k].dtype and v.shape == back[k].shape, k
        assert v.tobytes() == back[k].tobytes(), k
    want = build(model)[4].state_dict()
    port_def = port_model_class(base_name(model))(Config(flat_config(model)))
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(3))
    again = port_def.make_module(generator=torch.Generator().manual_seed(3))
    other = port_def.make_module(generator=torch.Generator().manual_seed(4))
    assert sorted(fresh.state_dict()) == sorted(want)
    differs = False
    for (k, a), b, c in zip(fresh.state_dict().items(), again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.shape == want[k].shape, k
        differs = differs or not torch.equal(a, c)
    assert differs
