"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file of the benchmark."""

import json
import os
import re

import pytest

from recbench import harness

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["recbench"] and SPEC["command"] == ["python3", "recbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("recbench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in SPEC[group]]
        assert len(group_names) == len(set(group_names))


def test_every_cell_reports_what_it_needs():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    bench = harness.Benchmark()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics_for("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for("per_layer", w["name"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_every_cell_of_the_metric(metric):
    target = E2E[metric["moves"]]
    assert metric.get("workloads"), "each per-layer metric names its cells"
    for cell in metric["workloads"]:
        assert cell in {w["name"] for w in SPEC["workloads"]}
        assert "workloads" not in target or cell in target["workloads"]


@pytest.mark.parametrize("workload", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_file_of_a_cell_is_there(workload):
    config = harness.load_json(harness.HERE, "configs", workload["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic", workload["traffic"] + ".json")
    limits = harness.load_json(harness.HERE, "limits", workload["name"] + ".json")
    assert os.path.exists(os.path.join(harness.HERE, "drivers", traffic["driver"] + ".py"))
    assert os.path.exists(os.path.join(harness.HERE, "models",
                                       config["runner"]["model"] + ".py"))
    assert limits and all(v >= 0 for v in limits.values())
    cfg = [c for c in SPEC["configs"] if c["name"] == workload["config"]][0]
    assert cfg["source"] == config["source"] and cfg["reduced"] == config["reduced"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.metric_reader(metric["name"]).read)


def test_a_scoped_name_finds_the_longest_part_served():
    served = {"a": 1, "a.b": 2}
    assert harness.by_scope("a.b.c", served.get) == 2
    assert harness.by_scope("a.x", served.get) == 1
    with pytest.raises(KeyError):
        harness.by_scope("z.b", served.get)


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
