"""A cell, found by its name in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by name: ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<name>.py`` (a ``read(run)`` that
returns the metric, or None where the run holds nothing to read it from).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_config(name: str) -> dict:
    return load_json(os.path.join(PACKAGE_DIR, "configs", f"{name}.json"))


def load_traffic(name: str) -> dict:
    return load_json(os.path.join(PACKAGE_DIR, "traffic", f"{name}.json"))


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``."""
    path = os.path.join(PACKAGE_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"trimbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    w = found[0]
    return Cell(
        name=name, chips=int(w["chips"]), config=load_config(w["config"]),
        traffic=load_traffic(w["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
