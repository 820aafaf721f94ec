"""Each per-layer reader on a small recorded trace fixture (the Chrome-trace
events ``torch.profiler`` exports) and the run's own counts."""

import pytest

from recbench import harness, trace

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "recbench.window", "tid": 1, "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "recbench.train_step", "tid": 1, "ts": 0, "dur": 400},
    {"ph": "X", "cat": "user_annotation", "name": "recbench.feed", "tid": 1, "ts": 400, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "tid": 1, "ts": 10, "dur": 40},
    {"ph": "X", "cat": "cpu_op", "name": "aten::unique", "tid": 2, "ts": 430, "dur": 300},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "tid": 1, "ts": 600, "dur": 300},
    {"ph": "X", "cat": "kernel", "name": "void gather_one_kernel<float, 4>", "tid": 7, "ts": 100, "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "tid": 7, "ts": 150, "dur": 200},
    {"ph": "X", "cat": "kernel", "name": "fill_zero_kernel(float*, long)", "tid": 7, "ts": 350, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void scatter_add_kernel<float, 0, 1>", "tid": 7, "ts": 360, "dur": 40},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "tid": 8, "ts": 380, "dur": 40},
    {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel", "tid": 7, "ts": 700, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "a kernel outside the window", "tid": 7, "ts": 1100, "dur": 100},
]

TRAIN = {"driver": "train", "steps": 10, "window_s": 2.0, "flops": 67e12, "peak_flops": 67e12,
         "reader_cost_s": [0.001, 0.003], "trace_steps": 1, "k1_bound_s": 25e-6,
         "k1b_bound_s": 40e-6}
SCORE = {"driver": "score", "batches": 10, "window_s": 2.0, "flops": 33.5e12,
         "peak_flops": 67e12, "trace_steps": 1, "k1_bound_s": 10e-6}


def _out(counts):
    return harness.Outcome(end_to_end={}, counts=counts, compared={}, attempted=1, failed=0,
                           memory_peak_bytes=0, trace=trace.reduce(EVENTS))


def _read(metric, counts):
    return harness.metric_reader(metric).read(_out(counts))


def test_reduce():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    # [100, 420] (kernels back to back, the copy overlapping the scatter) + [700, 800]
    assert r["busy_s"] == pytest.approx(420e-6)
    assert len(r["kernels"]) == 5
    assert r["breakdown"]["device_ops"][0] == ["sm90_xmma_gemm_f32f32_f32f32_f32_tn_n",
                                               pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in r["breakdown"]["idle_gaps"])
    assert gaps == {"no span / python": pytest.approx(280e-6),
                    "no span / cudaStreamSynchronize": pytest.approx(200e-6),
                    "recbench.train_step / aten::mm": pytest.approx(100e-6)}


@pytest.mark.parametrize("metric,counts,expected", [
    ("device_idle.train.dlrm", TRAIN, 58.0),
    ("device_idle.score", SCORE, 58.0),
    ("train_mfu.deepfm", TRAIN, 50.0),
    ("score_mfu", SCORE, 25.0),
    ("k1_roofline.train.dlrm", TRAIN, 50.0),
    ("k1_roofline.score", SCORE, 20.0),
    ("k1b_roofline.train.deepfm", TRAIN, 80.0),
    ("gemm_ms_per_step.train.dlrm", TRAIN, 0.2),
    ("kernels_per_step.train.deepfm", TRAIN, 5.0),
    ("feed_wait_ms.train.dlrm", TRAIN, 2.0),
])
def test_readers(metric, counts, expected):
    assert _read(metric, counts) == pytest.approx(expected)


SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_metric_reads_its_cells_fixture(metric):
    """Each per-layer metric of BENCHMARK.json reads a number from the
    fixture with the counts of its cells' driver."""
    drivers = {harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")["driver"]
               for w in SPEC["workloads"] if w["name"] in metric["workloads"]}
    assert len(drivers) == 1
    value = _read(metric["name"], TRAIN if drivers == {"train"} else SCORE)
    assert value is not None and value > 0


def test_roofline_reads_nothing_when_launches_do_not_match():
    counts = dict(TRAIN, trace_steps=2)
    assert _read("k1_roofline.train.dlrm", counts) is None
    assert _read("k1b_roofline.train.dlrm", counts) is None


@pytest.mark.parametrize("metric", ["device_idle.train.dlrm", "k1_roofline.score",
                                    "k1b_roofline.train.deepfm", "gemm_ms_per_step.train.dlrm",
                                    "kernels_per_step.train.deepfm"])
def test_readers_without_a_trace(metric):
    out = harness.Outcome(end_to_end={}, counts=TRAIN, compared={}, attempted=1, failed=0,
                          memory_peak_bytes=0, trace=None)
    assert harness.metric_reader(metric).read(out) is None
