"""Finding a cell's files by the names in ``BENCHMARK.json``.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* a configuration's file is the ``file`` of its ``configs`` entry;
* a traffic mix is ``benchmark/traffic/<traffic>.json``; its ``"driver"``
  names the general generator in ``benchmark/drivers/`` that reads it;
* a per-layer metric is read by ``benchmark/metrics/<metric name>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

TRAFFIC_DIR = os.path.join("benchmark", "traffic")
METRICS_DIR = os.path.join("benchmark", "metrics")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(root: str, spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            with open(os.path.join(root, entry["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, TRAFFIC_DIR, name + ".json")) as f:
        return json.load(f)


def driver(traffic: dict):
    """The driver module a traffic mix names."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (an entry without ``workloads`` counts
    wherever the end-to-end metric it moves is reported)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in names)]


def metric_reader(root: str, name: str):
    """``read(record)`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, METRICS_DIR, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
