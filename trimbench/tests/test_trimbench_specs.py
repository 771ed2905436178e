"""BENCHMARK.json and every file it names, found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from trimbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KNOBS = {"MV_THRESHOLD_SQ": 16, "BLOCK_SIZE": 16, "VECTORS_NEEDED": 2,
         "CLUSTERS_NEEDED": 2, "VERTICAL_MASK": 0.05, "MAX_GAP_SEC": 5,
         "PADDING_SEC": 0.5, "MIN_SAVINGS_PCT": 5, "CHUNK_DURATION_SEC": 30,
         "MVT_DEVICE_BATCH": 2048, "PARALLEL_STREAMS": 3}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["trimbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "trimbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and len(entry["source"]) <= 200
    assert entry["file"] == f"trimbench/configs/{entry['name']}.json"
    config = spec.load_config(entry["name"])
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in config
    for knob, value in KNOBS.items():
        assert config["env"][knob] == value, knob
    assert "THREADS_PER_STREAM" in config["assumed"]
    # the host's thread pools are fixed too, not sized by its core count
    assert int(config["env"]["OMP_NUM_THREADS"]) >= 1
    assert "OMP_NUM_THREADS" in config["assumed"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    found = spec.cell(cell["name"])
    assert found.traffic["files"] >= found.traffic["block_files"]
    e2e = {m["name"] for m in found.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert found.per_layer
    for m in found.per_layer:
        assert m["moves"] in e2e, (m["name"], cell["name"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if "bound" in metric else {"layer", "moves"}
    assert set(metric) <= allowed and NAME.match(metric["name"])
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert metric["source"] in SOURCES
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert callable(spec.metric_reader(metric["name"]))


def test_names_are_unique_and_each_config_is_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_traffic_file_is_data():
    for name in os.listdir(os.path.join(spec.PACKAGE_DIR, "traffic")):
        assert name.endswith(".json")
        json.loads(open(os.path.join(spec.PACKAGE_DIR, "traffic",
                                     name)).read())


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")
