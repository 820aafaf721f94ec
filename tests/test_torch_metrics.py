"""Streaming AUC/CTR metrics of the port against the JAX package over a
multi-batch stream with masks: bucket counts equal exactly, the bundle
within 1e-6, the log string letter for letter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.core import metrics as jax_metrics
from paddlerec_tpu_torch.core import metrics as port_metrics

torch.set_num_threads(1)


def _stream(seed, batches=7, rows=257):
    rng = np.random.RandomState(seed)
    for i in range(batches):
        preds = rng.rand(rows).astype(np.float32)
        preds[:6] = [0.0, 1.0, 1.0 - 2 ** -24, 0.5, 4095.5 / 4096, 1.0 / 4096]
        labels = (rng.rand(rows) < preds).astype(np.float32)
        mask = None if i % 3 == 0 else (rng.rand(rows) < 0.8).astype(np.float32)
        yield preds, labels, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_matches_jax(seed):
    ref = jax_metrics.init_auc_state()
    out = port_metrics.init_auc_state()
    for preds, labels, mask in _stream(seed):
        ref = jax_metrics.update_auc_state(
            ref, jnp.asarray(preds), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
        out = port_metrics.update_auc_state(
            out, torch.from_numpy(preds), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
    assert sorted(out) == sorted(ref)
    for k in ("stat_pos", "stat_neg"):
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    for k in ("pos_ins", "total_ins", "pos_ins_c", "total_ins_c"):
        assert float(out[k]) == float(ref[k]), k
    want = jax_metrics.compute_metrics(ref)
    got = port_metrics.compute_metrics(out)
    assert sorted(got) == sorted(want)
    assert got["auc"] == want["auc"] and got["bucket_error"] == want["bucket_error"]
    assert got["total_ins"] == want["total_ins"] > 1000
    # f32 sums over a batch run in another order; Kahan carries them on
    for k in ("mae", "rmse", "actual_ctr", "predicted_ctr", "copc", "mean_q"):
        assert abs(got[k] - want[k]) < 1e-6, k
    assert port_metrics.metrics_str(want, "train") == jax_metrics.metrics_str(want, "train")
    assert port_metrics.metrics_str(got, "infer") == jax_metrics.metrics_str(want, "infer")


def test_kahan_compensation_survives():
    """Many small adds after a large total: the compensated pair keeps what
    a plain float32 sum drops.  Powers of two, so every sum is exact."""
    state = port_metrics.init_auc_state(num_buckets=8)
    ref = jax_metrics.init_auc_state(num_buckets=8)
    big = np.full(4096, 0.5, np.float32)
    one = np.array([2.0 ** -14], np.float32)  # a float32 ulp at 16384 is 2^-9
    for preds in [big] * 8 + [one] * 50:
        labels = np.ones_like(preds)
        state = port_metrics.update_auc_state(state, torch.from_numpy(preds),
                                              torch.from_numpy(labels))
        ref = jax_metrics.update_auc_state(ref, jnp.asarray(preds), jnp.asarray(labels))
    for k in ("prob", "prob_c", "q", "q_c", "sqrerr", "sqrerr_c"):
        assert float(state[k]) == float(ref[k]), k
    assert float(state["prob_c"]) != 0.0
    assert float(state["prob"]) - float(state["prob_c"]) == 16384 + 50 * 2.0 ** -14
    plain = torch.tensor(16384.0)
    for _ in range(50):
        plain = plain + torch.tensor(2.0 ** -14)
    assert float(plain) == 16384.0  # a plain sum drops them all
    assert int(state["stat_pos"].sum()) == 8 * 4096 + 50


def test_empty_state_and_helpers():
    state = port_metrics.init_auc_state()
    ref = jax_metrics.compute_metrics(jax_metrics.init_auc_state())
    assert port_metrics.compute_metrics(state) == ref
    rng = np.random.RandomState(3)
    pos, neg = rng.randint(0, 50, 4096), rng.randint(0, 50, 4096)
    assert port_metrics.auc_from_buckets(pos, neg) == jax_metrics.auc_from_buckets(pos, neg)
    assert port_metrics.bucket_error(pos, neg) == jax_metrics.bucket_error(pos, neg)
