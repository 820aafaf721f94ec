"""gatenet, flen, deepfefm, difm, ffm, fat_deepffm, fgcnn and autofis of the
port against the JAX package: predictions, loss, the gradient of every leaf,
the parameter names and their round trip."""

import pytest
import torch

from tests.test_torch_zoo_common import (
    check_forward_and_loss, check_gradients, check_names_round_trip_and_seed,
)

torch.set_num_threads(1)

MODELS = ["rank.gatenet", "rank.flen", "rank.deepfefm", "rank.difm", "rank.ffm",
          "rank.fat_deepffm", "rank.fgcnn", "rank.autofis"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(tmp_path, model, dtype):
    module = check_forward_and_loss(tmp_path, model, dtype)
    assert module.embedding.embedding.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(tmp_path, model):
    check_gradients(tmp_path, model)


@pytest.mark.parametrize("model", MODELS)
def test_param_names_round_trip_and_seed(tmp_path, model):
    check_names_round_trip_and_seed(tmp_path, model)


# -- options ----------------------------------------------------------------------

def test_fat_deepffm_gradient_with_zero_dense_values(tmp_path):
    """A dense value of 0 makes all lanes of that field's vectors 0: the
    maximum over the lanes is a nine-way tie, whose gradient JAX splits evenly."""
    from tests.test_torch_zoo_common import make_batch

    batch = make_batch(5, zero_dense=True)
    assert (batch["dense"] == 0).mean() > 0.25
    got, _ = check_gradients(tmp_path, "rank.fat_deepffm", batch=batch)
    assert float(got["dense_field_emb"].abs().max()) > 0


def test_autofis_stage_one_keeps_the_named_pairs(tmp_path):
    from tests.test_torch_zoo_common import build

    kept = [0, 3, 7, 11, 300]
    opts = {"stage": 1, "hyper_parameters.comb_mask": kept}
    module = check_forward_and_loss(tmp_path, "rank.autofis", "float32", **opts)
    assert module.interaction_mask.shape == (len(kept),)
    assert module.pairs[:2] == ((0, 1), (0, 4)) and len(module.pairs) == len(kept)
    check_gradients(tmp_path, "rank.autofis", **opts)
    _, _, port_def, _ = build(tmp_path, "rank.autofis", **opts)
    tx = port_def.create_optimizer()
    assert tx.name == "adam" and tx.mu_dtype is None  # Adam alone, optax.adam(lr)
    # comb_mask without stage 1 is ignored, as in the JAX package
    _, _, search_def, search = build(tmp_path, "rank.autofis",
                                     **{"hyper_parameters.comb_mask": kept})
    assert search.interaction_mask.shape == (26 * 25 // 2,)
    assert sorted(search_def.create_optimizer().groups) == ["dense", "gate"]
    assert search_def.model_inputs({"sparse": 1, "dense": 2}) == (1, None)


def test_autofis_gate_is_drawn_uniform_and_one_row_normalizes_to_its_bias(tmp_path):
    from tests.test_torch_zoo_common import build

    _, _, port_def, _ = build(tmp_path, "rank.autofis")
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(0))
    gate = fresh.interaction_mask.detach()
    assert 0.599 <= float(gate.min()) < float(gate.max()) <= 0.601
    out = fresh(torch.arange(26)[None])  # variance 0: finite, as in the JAX package
    assert out.shape == (1,) and bool(torch.isfinite(out).all())
