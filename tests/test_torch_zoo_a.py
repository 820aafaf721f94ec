"""lr, fm, slot_dnn, dcn, dcn_v2, dlrm, xdeepfm and autoint of the port
against the JAX package: predictions, loss, the gradient of every leaf, the
parameter names and their round trip; then each model's options."""

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from tests.test_torch_zoo_common import (
    build, check_forward_and_loss, check_gradients, check_names_round_trip_and_seed,
)

torch.set_num_threads(1)

MODELS = ["rank.lr", "rank.fm", "rank.slot_dnn", "rank.dcn", "rank.dcn_v2",
          "rank.dlrm", "rank.xdeepfm", "rank.autoint"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(tmp_path, model, dtype):
    module = check_forward_and_loss(tmp_path, model, dtype)
    if model != "rank.lr":  # lr's rank-1 table is float32 whatever the config says
        assert module.embedding.embedding.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(tmp_path, model):
    check_gradients(tmp_path, model)


@pytest.mark.parametrize("model", MODELS)
def test_param_names_round_trip_and_seed(tmp_path, model):
    check_names_round_trip_and_seed(tmp_path, model)


# -- options ----------------------------------------------------------------------

def test_dcn_cross_penalty_enters_the_loss_and_the_gradient(tmp_path):
    opts = {"hyper_parameters.l2_reg_cross": 0.01, "hyper_parameters.cross_num": 3,
            "hyper_parameters.dnn_use_bn": True}  # read and ignored, as in the JAX package
    check_forward_and_loss(tmp_path, "rank.dcn", "float32", **opts)
    got, _ = check_gradients(tmp_path, "rank.dcn", **opts)
    plain, _ = check_gradients(tmp_path, "rank.dcn", **{**opts, "hyper_parameters.l2_reg_cross": 0.0})
    moved = (got["crossnet.layer_w"] - plain["crossnet.layer_w"]).abs().max()
    assert float(moved) > 1e-4  # the penalty did reach the cross weight


@pytest.mark.parametrize("mixture,stacked", [(False, True), (False, False), (True, False)])
def test_dcn_v2_full_rank_and_parallel(tmp_path, mixture, stacked):
    opts = {"hyper_parameters.use_low_rank_mixture": mixture,
            "hyper_parameters.is_Stacked": stacked}
    module = check_forward_and_loss(tmp_path, "rank.dcn_v2", "float32", **opts)
    names = [k for k, _ in module.crossnet.named_parameters()]
    assert ("U_0" in names) == mixture and ("cross_0.weight" in names) == (not mixture)
    assert module.head.in_features == (16 if stacked else 26 * 9 + 13 + 16)
    check_gradients(tmp_path, "rank.dcn_v2", **opts)


def test_dcn_v2_defaults_are_the_reference_s():
    from paddlerec_tpu_torch.core.config import Config
    md = port_model_class("rank.dcn_v2")(Config({"runner.model": "rank.dcn_v2"}))
    assert (md.use_low_rank_mixture, md.low_rank, md.num_experts, md.is_stacked,
            md.fc_sizes, md.cross_num) == (True, 32, 4, True, [768, 768], 2)


@pytest.mark.parametrize("self_interaction,top", [(True, [32, 1]), (False, [32, 1]),
                                                  (True, [32, 2])])
def test_dlrm_self_interaction_and_one_unit_head(tmp_path, self_interaction, top):
    opts = {"hyper_parameters.self_interaction": self_interaction,
            "hyper_parameters.top_layer_sizes": top}
    module = check_forward_and_loss(tmp_path, "rank.dlrm", "float32", **opts)
    pairs = 27 * 28 // 2 if self_interaction else 27 * 26 // 2
    assert module.top_mlp.fc_0.in_features == 9 + pairs
    check_gradients(tmp_path, "rank.dlrm", **opts)


def test_logistic_regression_resolves_to_lr(tmp_path):
    assert port_model_class("rank.logistic_regression") is port_model_class("rank.lr")
    check_forward_and_loss(tmp_path, "rank.logistic_regression", "float32")
    # without dense inputs the module has no dense weight, as in the JAX package
    _, params, port_def, module = build(tmp_path, "rank.lr",
                                        **{"hyper_parameters.dense_input_dim": 0})
    assert sorted(params["FMFirstOrder_0"]) == ["bias", "sparse_w"]
    assert port_def.model_inputs({"sparse": 1, "dense": 2}) == (1,)
    check_forward_and_loss(tmp_path, "rank.lr", "float32",
                           **{"hyper_parameters.dense_input_dim": 0})
