"""The traffic generator: deterministic in the seed, keys in range, dense
features that the compact wire format carries exactly."""

import numpy as np
import torch

from recbench import harness, traffic


def _cell_files(workload):
    bench = harness.Benchmark()
    w = bench.workloads[workload]
    return (harness.load_json(harness.HERE, "configs", w["config"] + ".json"),
            harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json"))


def _draw(seed, rows=512, workload="deepfm_1e8.train"):
    config, tr = _cell_files(workload)
    return traffic.generate(seed, "corpus", rows, config, tr, torch.device("cpu"))


def test_same_seed_same_rows_other_seed_other_rows():
    a, b, c = _draw(3), _draw(3), _draw(2 ** 31 + 5)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["sparse"], c["sparse"])


def test_large_seeds_and_streams_differ():
    assert traffic.stream_seed(2 ** 33, "corpus") != traffic.stream_seed(2 ** 33, "pool")
    assert traffic.mix64(1) < 2 ** 63 and traffic.mix64(2 ** 40, 7) < 2 ** 63


def test_keys_labels_dense():
    config, _ = _cell_files("deepfm_1e8.train")
    d = _draw(11, rows=4096)
    vocab = config["hyper_parameters"]["sparse_feature_number"]
    assert d["sparse"].dtype == torch.int32 and d["sparse"].shape == (4096, 26)
    assert int(d["sparse"].min()) >= 0 and int(d["sparse"].max()) < vocab
    assert set(np.unique(d["label"].numpy())) <= {0.0, 1.0}
    assert torch.equal(d["dense"].to(torch.float16).to(torch.float32), d["dense"])
    # the slot of 3 values takes at most 3 ids
    assert len(np.unique(d["sparse"][:, 8].numpy())) <= 3


def test_zipf_ranks_skewed_and_in_range():
    u = torch.rand((200000, 1), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    r = traffic.zipf_ranks(u, [1.05]).reshape(-1)
    assert int(r.min()) >= 1 and int(r.max()) <= 2 ** 62
    counts = torch.bincount(r[r < 10], minlength=3)
    # rank 1 against rank 2: 2^1.05 ≈ 2.07 by the power law
    assert 1.8 < float(counts[1]) / float(counts[2]) < 2.4
    # rank 1 takes 1/zeta(1.05) of the draws; no rank but the head's repeats
    assert abs(float((r == 1).double().mean()) - 1.0 / traffic._zeta(1.05)) < 0.003
    assert int(torch.unique(r[r > 10 ** 12], return_counts=True)[1].max()) == 1


def test_a_whole_run_takes_a_seed_past_32_bits():
    from recbench.tests.small import run_small

    result = run_small("deepfm_1e8.train", seed=2 ** 33 + 5)
    assert result["attempted"] > 0 and set(result["compared"]) == {
        "loss_gap", "grad_gap", "change_gap", "replay_loss_gap", "replay_grad_gap",
        "replay_change_gap", "epoch_cover", "small_step_gap"}


def test_draws_show_the_distinct_count_the_fit_asks_for():
    """A slot's fitted exponent, drawn, shows the expected distinct count;
    and the fit reproduces a published count, with and without a cap."""
    alpha = traffic.fit_alpha(300000, 10 ** 6)
    u = torch.rand((10 ** 6, 1), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    seen = len(torch.unique(traffic.zipf_ranks(u, [alpha])))
    assert abs(seen - 300000) < 0.02 * 300000
    for distinct, rows, cap in ((10131227, 45840617, 0), (3, 45840617, 0),
                                (25641295, 4373472329, 40000000)):
        a = traffic.fit_alpha(distinct, rows, cap)
        v = traffic.distinct_values(a, rows)
        v = cap * -np.expm1(-v / cap) if cap else v
        assert abs(v - distinct) <= 1e-3 * distinct + 1.0


def test_the_fit_reads_steeper_laws_from_smaller_counts():
    config, tr = _cell_files("deepfm_1e8.train")
    alphas = traffic.slot_alphas(config, tr)
    cards = config["slot_cardinalities"]
    assert all(a > 1.0 for a in alphas)
    by_count = [a for _, a in sorted(zip(cards, alphas))]
    assert by_count == sorted(by_count, reverse=True)
    assert traffic.slot_alphas(config, dict(tr, zipf_alpha=1.2)) == [1.2] * len(cards)
