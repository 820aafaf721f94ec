"""The shared pieces of the last six rank models against the JAX package:
the accuracy metric family (exact counts), ``AccuracyModelDef``'s bundle and
log string, the LayerNorm at epsilon 1e-12, the news layers
(``AdditiveAttention``, ``NewsEncoder`` with its shared conv,
``FastSelfAttention``), iprec's ``UserAttention`` and ``GateAttention`` (each
against flax: outputs, every parameter's and float input's gradient vs
``jax.grad``, atol 1e-5), ``Embed``'s truncated-normal init and sign's
``clip`` at a tie."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.core import metrics as jax_metrics
from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.models.rank.bert4rec.model import ModelDef as JaxBert4Rec
from paddlerec_tpu.models.rank.fastformer import model as jax_fast
from paddlerec_tpu.models.rank.iprec import model as jax_iprec
from paddlerec_tpu.models.rank.naml import model as jax_naml
from paddlerec_tpu_torch.core import metrics
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.models.base import AccuracyModelDef
from paddlerec_tpu_torch.models.rank.bert4rec.model import ModelDef as PortBert4Rec
from paddlerec_tpu_torch.models.rank.fastformer import model as port_fast
from paddlerec_tpu_torch.models.rank.iprec import model as port_iprec
from paddlerec_tpu_torch.models.rank.naml import model as port_naml
from paddlerec_tpu_torch.models.rank.sign.model import clip
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import LayerNorm
from tests.test_torch_seq_ops import _check

torch.set_num_threads(1)


# -- the accuracy family ------------------------------------------------------

def _acc_stream(seed, batches=5, rows=37):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(batches):
        correct = (rng.rand(rows) < 0.3).astype(np.float32)
        mask = None if i == 0 else (rng.rand(rows) < 0.8).astype(np.float32)
        out.append((correct, mask))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_acc_counts_are_exact(seed):
    """The same flags and masks through both packages: the same float32
    counts, exactly (sums of 0/1), and the same accuracy."""
    jst, pst = jax_metrics.init_acc_state(), metrics.init_acc_state()
    for correct, mask in _acc_stream(seed):
        jst = jax_metrics.update_acc_state(
            jst, jnp.asarray(correct), None if mask is None else jnp.asarray(mask))
        pst = metrics.update_acc_state(
            pst, torch.from_numpy(correct), None if mask is None else torch.from_numpy(mask))
    for k in ("correct", "total"):
        assert pst[k].dtype == torch.float32
        assert float(pst[k]) == float(jst[k]), k
    assert metrics.compute_acc(pst) == jax_metrics.compute_acc(jst)
    assert metrics.compute_acc(metrics.init_acc_state()) == 0.0


class _TwoTask(AccuracyModelDef):
    metric_names = ("a", "b")

    def metric_updates(self, aux):
        return {"a": (aux["ca"], aux["m"]), "b": (aux["cb"], None)}


@pytest.mark.parametrize("names", [("acc",), ("a", "b")])
def test_accuracy_model_def_bundle_and_log_string_match_jax(names):
    """``acc`` for one name, ``acc_<name>`` for several, and the same log
    string as the JAX ``AccuracyModelDef``."""
    rng = np.random.RandomState(3)
    if names == ("acc",):
        flat = {"hyper_parameters._voc_size": 50}
        jax_def, port_def = JaxBert4Rec(JaxConfig(flat)), PortBert4Rec(Config(flat))
        aux = {"correct": (rng.rand(40) < 0.4).astype(np.float32),
               "mask_weight": (rng.rand(40) < 0.7).astype(np.float32)}
    else:
        from paddlerec_tpu.models.base import AccuracyModelDef as JaxAcc

        class JaxTwoTask(JaxAcc):
            metric_names = ("a", "b")

            def metric_updates(self, aux):
                return {"a": (aux["ca"], aux["m"]), "b": (aux["cb"], None)}

        jax_def, port_def = JaxTwoTask(JaxConfig({})), _TwoTask(Config({}))
        aux = {"ca": (rng.rand(40) < 0.4).astype(np.float32),
               "cb": (rng.rand(40) < 0.6).astype(np.float32),
               "m": (rng.rand(40) < 0.7).astype(np.float32)}
    assert port_def.metrics == jax_def.metrics == "acc"
    jst, pst = jax_def.init_metric_state(), port_def.init_metric_state()
    for _ in range(2):
        jst = jax_def.update_metric_state(jst, {k: jnp.asarray(v) for k, v in aux.items()})
        pst = port_def.update_metric_state(pst, {k: torch.from_numpy(v) for k, v in aux.items()})
    bundle = port_def.compute_metric_bundle(pst)
    assert bundle == jax_def.compute_metric_bundle(jst)
    assert sorted(bundle) == (["acc"] if len(names) == 1 else ["acc_a", "acc_b"])
    assert port_def.metric_log_str(pst) == jax_def.metric_log_str(jst)


# -- LayerNorm at epsilon 1e-12 ------------------------------------------------

def test_layer_norm_eps_1e12_matches_flax_on_random_rows():
    """fastformer's three LayerNorms: on rows with some spread the port's
    two-pass ``F.layer_norm`` and flax's E[x²] - E[x]² agree within 1e-5,
    output and every gradient."""
    rng = np.random.RandomState(7)
    x = (rng.randn(5, 3, 40) * 2 + 0.5).astype(np.float32)
    norm = LayerNorm(40, eps=1e-12)
    _check(fnn.LayerNorm(epsilon=1e-12), norm, [x], [0])


@pytest.mark.parametrize("spread", [1e-2, 1e-3])
def test_layer_norm_eps_1e12_on_near_constant_rows(spread):
    """Rows of mean 1.5 whose spread is ``spread``: flax's E[x²] - E[x]²
    loses the variance to cancellation (its output off the exact float64
    value by 1.5e-2 at spread 1e-2 and 2.0 at 1e-3), so no float32 arithmetic
    of another summation order can follow it, its own formula included
    (ROADMAP.md section 3, fault 2).  The port's two passes stay near the
    exact value: within 1e-4 at 1e-2 (measured 1.3e-5) and 1e-3 at 1e-3
    (1.4e-4), where flax is off by more than 1e-3 (9.3e-3, 0.96).  A copy of
    flax's arithmetic in torch ops (mean, mean of squares, clamp at 0,
    rsqrt) is off flax by more than 1e-4, ten times the models' 1e-5
    (measured 1.1e-2, 1.65): the repair that fault 2 rules out."""
    rng = np.random.RandomState(8)
    x = (1.5 + spread * rng.randn(16, 400)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: fnn.LayerNorm(epsilon=1e-12, use_scale=False,
                                                       use_bias=False).apply({}, v))(x))
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-12)
    got = LayerNorm(400, eps=1e-12)(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - exact).max() < (1e-4 if spread == 1e-2 else 1e-3)
    assert np.abs(want - exact).max() > 1e-3
    t = torch.from_numpy(x)
    mean = t.mean(-1, keepdim=True)
    var = torch.clamp((t * t).mean(-1, keepdim=True) - mean * mean, min=0)
    copy = ((t - mean) * torch.rsqrt(var + 1e-12)).numpy()
    assert np.abs(copy - want).max() > 1e-4


# -- the news layers --------------------------------------------------------------

def test_additive_attention_matches_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(5, 6, 12).astype(np.float32)
    _check(jax_naml.AdditiveAttention(proj_dim=9), port_naml.AdditiveAttention(12, 9),
           [x], [0])


def test_news_encoder_matches_jax():
    """One conv shared by title and content, its two bias vectors, the word
    table read once for both; ids include 0 and the last row."""
    rng = np.random.RandomState(11)
    n, words = 7, 40
    cate, sub = rng.randint(0, 5, n), rng.randint(0, 7, n)
    title, content = rng.randint(0, words + 1, (n, 5)), rng.randint(0, words + 1, (n, 8))
    _check(jax_naml.NewsEncoder(words, 6, 4, 6, 5, conv_out=24),
           port_naml.NewsEncoder(words, 6, 4, 6, 5, conv_out=24),
           [cate, sub, title, content], [])


@pytest.mark.parametrize("heads", [1, 4])
def test_fast_self_attention_matches_jax(heads):
    rng = np.random.RandomState(12)
    x = rng.randn(5, 7, 16).astype(np.float32)
    mask = (rng.rand(5, 7) < 0.8).astype(np.float32)
    mask[0] = 0.0  # every position masked: uniform weights
    _check(jax_fast.FastSelfAttention(16, heads), port_fast.FastSelfAttention(16, heads),
           [x, mask], [0])


def test_fastformer_encoder_matches_jax():
    """Position table, input LayerNorm and two layers (eps 1e-12) and the
    pooling readout."""
    rng = np.random.RandomState(13)
    x = np.maximum(rng.randn(4, 6, 16), 0).astype(np.float32)
    mask = (rng.rand(4, 6) < 0.8).astype(np.float32)
    _check(jax_fast.FastformerEncoder(16, 2, 2, 24, max_position=10),
           port_fast.FastformerEncoder(16, 2, 2, 24, max_position=10), [x, mask], [0])


# -- iprec's attention layers -------------------------------------------------------

def test_user_attention_matches_jax():
    """The mask pads where it is 0 with -2^31; an all-zero row gets uniform
    weights."""
    rng = np.random.RandomState(14)
    q, keys = rng.randn(5, 8).astype(np.float32), rng.randn(5, 6, 8).astype(np.float32)
    mask = (rng.rand(5, 6) < 0.6).astype(np.float32)
    mask[0] = 0.0
    out, att = _check(jax_iprec.UserAttention(8), port_iprec.UserAttention(8, 8),
                      [q, keys, mask], [0, 1])
    np.testing.assert_allclose(att[0].detach().numpy(), np.full(6, 1 / 6), atol=1e-7)


def test_gate_attention_matches_jax():
    rng = np.random.RandomState(15)
    anchor, others = rng.randn(5, 8).astype(np.float32), rng.randn(5, 4, 8).astype(np.float32)
    mask = (rng.rand(5, 4) < 0.6).astype(np.float32)
    _check(jax_iprec.GateAttention(8), port_iprec.GateAttention(8, 8),
           [anchor, others, mask], [0, 1])


# -- inits and ties ------------------------------------------------------------------

def test_truncated_normal_init_matches_flax():
    """bert4rec's word table: flax's ``truncated_normal(0.02)`` is 0.02 times
    a standard normal cut at ±2 (std 0.0176); the port's draw has its
    statistics within 5% and nothing beyond the cut."""
    vocab, features = 4000, 64
    init = fnn.Embed(vocab, features, embedding_init=fnn.initializers.truncated_normal(0.02))
    want = np.asarray(jax.jit(init.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1,), jnp.int32))["params"]["embedding"])
    got = Embed(vocab, features, stddev=0.02, truncated=True,
                generator=torch.Generator().manual_seed(0)).embedding.detach().numpy()
    assert abs(got.std() / want.std() - 1) < 0.05 and abs(want.std() / 0.0176 - 1) < 0.05
    assert abs(got.mean()) < 1e-3 and abs(want.mean()) < 1e-3
    for w in (got, want):
        assert np.abs(w).max() <= 0.04 and np.mean(np.abs(w) > 0.03) > 0.05
    # sign's edge table: a plain normal of std 0.01
    edge = Embed(vocab, 8, stddev=0.01, generator=torch.Generator().manual_seed(1))
    assert abs(float(edge.embedding.detach().std()) / 0.01 - 1) < 0.05


def test_clip_splits_a_tie_as_jax():
    """sign's clips: the gradient at a value exactly on a bound is halved in
    JAX's ``jnp.clip``; the port's ``clip`` matches it, where
    ``torch.clamp`` would pass it whole."""
    x = np.array([0.0, 1.0, 0.5, -1.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(x))
    t = torch.from_numpy(x).requires_grad_()
    clip(t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.5, 0.5, 1.0, 0.0, 0.0])
