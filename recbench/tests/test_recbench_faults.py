"""Whole runs of the harness at small sizes on the CPU (the look for a card
skipped) with the timed path broken underneath: ``correct`` comes out
false for each fault a one-chip cell can have, and for the replayed
epoch's and the row rules' own.  (The exchange between chips is not on a
one-chip cell's path.)  The same run unbroken reads each number at a tenth
of the broken run's or less."""

import pytest
import torch

from recbench.tests.small import run_small

TRAIN = ["dlrm_mlperf.train", "deepfm_1e8.train"]


def _numbers(result):
    return {k: v["value"] for k, v in result["compared"].items()}


@pytest.fixture(scope="module")
def sound():
    return {w: run_small(w) for w in TRAIN + ["dlrm_mlperf.score"]}


@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_leaves_its_state_unchanged(workload, monkeypatch, sound):
    from paddlerec_tpu_torch.models.base import ModelDef
    from paddlerec_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, norm=None: None)
    monkeypatch.setattr(ModelDef, "apply_sparse_updates", lambda self, *a, **k: None)
    result = run_small(workload)
    assert result["correct"] is False
    assert _numbers(result)["change_gap"] == pytest.approx(1.0)
    assert _numbers(sound[workload])["change_gap"] < 0.1


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(workload, monkeypatch, sound):
    from paddlerec_tpu_torch.train import trainer as trainer_mod

    decode = trainer_mod.decode_batch

    def half(batch):
        out = dict(decode(batch))
        rows = out["label"].shape[0] // 2
        for key in ("label", "sparse", "dense", "mask"):
            out[key] = out[key][:rows]
        out["sparse_slot"] = out["sparse_slot"][:rows * out["sparse"].shape[1]]
        return out

    monkeypatch.setattr(trainer_mod, "decode_batch", half)
    result = run_small(workload)
    assert result["correct"] is False
    broken, ok = _numbers(result), _numbers(sound[workload])
    worst = max(broken, key=lambda k: broken[k] / max(ok[k], 1e-30))
    assert broken[worst] >= 10 * ok[worst]


@pytest.mark.parametrize("fault", ["nearest", "truncate"])
def test_rounding_that_drops_small_steps(fault, monkeypatch, sound):
    from paddlerec_tpu_torch.ops import sparse_update

    from recbench import control

    monkeypatch.setattr(sparse_update, "stochastic_round_bf16", control.biased_rounding(fault))
    result = run_small("deepfm_1e8.train")
    assert result["correct"] is False
    assert _numbers(result)["small_step_gap"] > 0.5
    assert _numbers(sound["deepfm_1e8.train"])["small_step_gap"] < 0.1


@pytest.mark.parametrize("workload", TRAIN)
def test_a_replayed_epoch_that_repeats_a_superbatch(workload, monkeypatch, sound):
    from paddlerec_tpu_torch.train.trainer import Trainer

    resident = Trainer._resident_superbatches

    def repeat(self, dataset, k, key):
        replay, first = key in self._resident, None
        for sb, i in resident(self, dataset, k, key):
            first = first or sb
            yield (first if replay else sb), i

    monkeypatch.setattr(Trainer, "_resident_superbatches", repeat)
    result = run_small(workload)
    assert result["correct"] is False and _numbers(result)["epoch_cover"] > 0
    assert _numbers(sound[workload])["epoch_cover"] == 0


@pytest.mark.parametrize("change", [
    {"optimizer": {"class": "SGD", "learning_rate": 0.1}},
    {"optimizer": {"class": "Adam", "learning_rate": 0.001, "beta1": 0.8}},
    {"sparse_update_rule": "adam"},
    {"sparse_update_stochastic_round": False},
], ids=["sgd", "adam_beta1", "row_adam", "bf16_nearest"])
def test_a_recipe_the_reference_lacks_is_refused(change):
    from recbench import harness, reference

    hp = dict(harness.load_json(harness.HERE, "configs", "deepfm_1e8.json")["hyper_parameters"])
    reference.recipe(hp)
    with pytest.raises(ValueError):
        reference.recipe(dict(hp, **change))


def _broken_scores(monkeypatch, how):
    from paddlerec_tpu_torch.models.base import LogitModelDef

    infer = LogitModelDef.infer_forward

    def broken(self, module, batch):
        if how == "half":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        aux = infer(self, module, batch)
        if how == "altered":
            preds = aux["predictions"].clone()
            preds[3] = 1.0 - preds[3]
            aux = dict(aux, predictions=preds)
        return aux

    monkeypatch.setattr(LogitModelDef, "infer_forward", broken)
    return run_small("dlrm_mlperf.score")


def test_an_answer_altered_where_it_is_produced(monkeypatch, sound):
    result = _broken_scores(monkeypatch, "altered")
    assert result["correct"] is False and result["failed"] == 0
    assert _numbers(result)["score_gap"] > 0.01
    assert _numbers(sound["dlrm_mlperf.score"])["score_gap"] < 1e-3


def test_half_of_a_scored_batch_left_out(monkeypatch):
    result = _broken_scores(monkeypatch, "half")
    assert result["correct"] is False and result["failed"] == result["attempted"]


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The control (the reference in TF32 in the program's place) against
    the float32 reference, at a quarter of each training cell's batch and a
    sixteenth of the score cell's, three seeds: each reads over a limit."""
    import time

    from recbench import control, harness

    bench = harness.Benchmark()
    sizes = {"dlrm_mlperf.train": {"traffic.batch_size": 16384},
             "deepfm_1e8.train": {"traffic.batch_size": 32768},
             "dlrm_mlperf.score": {"traffic.batch_size": 4096, "traffic.pool_batches": 8,
                                   "traffic.sample_max": 8}}
    for workload, overrides in sizes.items():
        for seed in (101, 102, 103):
            cell = bench.cell(workload, seed, 1.0, False, card, time.perf_counter(),
                              overrides=overrides)
            readings = control.control_readings(cell)["control_tf32"]
            assert any(readings[k] > cell.limits[k] for k in readings), (workload, readings)
            torch.cuda.empty_cache()
