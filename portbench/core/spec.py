"""Finds the benchmark's pieces by name, so that a new configuration, cell
or metric is a new file and a new entry of ``BENCHMARK.json``, never an
edit:

- ``BENCHMARK.json`` at the checkout's root: the cells, configurations
  and metrics;
- ``portbench/configs/<config>.json``: a configuration (its ``file`` in
  ``BENCHMARK.json``);
- ``portbench/workloads/<cell>.json``: a cell's traffic parameters and the
  limits of its correctness check;
- ``portbench/traffic/<kind>.py``: the driver of a traffic kind;
- ``portbench/metrics/<metric>.py``: one metric's reader.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PKG = "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    source: str


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``: its configuration's file, its traffic
    kind and parameters, and the metrics it reports."""

    name: str
    config: dict
    traffic: str
    chips: int
    params: dict
    limits: dict
    end_to_end: tuple   # Metric, reported with --trace 0
    per_layer: tuple    # Metric, reported with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(root / PKG / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: BENCHMARK.json and its workload file name "
                         f"another configuration or traffic")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])

    def metrics(kind):
        return tuple(Metric(m["name"], m["unit"], m["source"])
                     for m in bench[kind] if _reports(m, name))

    return Cell(name=name, config=config, traffic=entry["traffic"],
                chips=entry["chips"], params=spec.get("params", {}),
                limits=spec["limits"], end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def traffic(root: Path, kind: str):
    """The driver module of a traffic kind."""
    return load_module(root / PKG / "traffic" / f"{kind}.py",
                       f"portbench_traffic_{kind}")


def metric(root: Path, name: str):
    """The reader module of a metric (``read(run)`` gives its value, or
    None where the run has nothing to read)."""
    return load_module(root / PKG / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


__all__ = ["Cell", "Metric", "cell", "traffic", "metric", "load_json",
           "load_module", "PKG"]
