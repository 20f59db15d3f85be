"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory that holds the repository's benchmark files and, added only as
files and entries, the tiny test cells of ``data/``."""
from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")

TINY_CELLS = {
    "flagship_tiny.serve_tiny": ("flagship_tiny", "serve_tiny"),
    "realesrgan_tiny.gan_tiny": ("realesrgan_tiny", "gan_tiny"),
    "flagship_tiny.city_tiny": ("flagship_tiny", "city_tiny"),
}
TINY_LIMITS = {"flagship_tiny.serve_tiny": {"height_tile_ratio": 3.0,
                                            "build_tile_ratio": 3.0},
               "realesrgan_tiny.gan_tiny": {"loss1_gap": 1e-4,
                                            "grad_gap": 1e-3,
                                            "change_gap": 0.05,
                                            "window_loss_gap": 1e-4,
                                            "window_change_gap": 0.05},
               "flagship_tiny.city_tiny": {"height_block_ratio": 3.0,
                                           "class_ratio": 3.0,
                                           "outside": 0.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test module: the tests run beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_root(tmp, cells=TINY_CELLS, limits=TINY_LIMITS, extra=None):
    """A checkout root under ``tmp``: ``BENCHMARK.json`` with the tiny
    configurations and cells added, the traffic, limits and metrics
    folders copied with the tiny files added. ``extra`` is applied to the
    spec before it is written."""
    root = os.path.join(tmp, "root")
    bench = os.path.join(root, "benchmark")
    for sub in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub),
                        os.path.join(bench, sub))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell, (config, traffic) in cells.items():
        if not any(c["name"] == config for c in spec["configs"]):
            shutil.copy(os.path.join(DATA, config + ".json"),
                        os.path.join(bench, "configs", config + ".json"))
            spec["configs"].append({
                "name": config, "source": "test", "reduced": [],
                "file": f"benchmark/configs/{config}.json", "why": "test"})
        shutil.copy(os.path.join(DATA, traffic + ".json"),
                    os.path.join(bench, "traffic", traffic + ".json"))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            like = cell.split(".")[1].split("_")[0]
            if any(w.split(".")[1].startswith(like)
                   for w in m.get("workloads", ())):
                m["workloads"].append(cell)
    for cell, lims in limits.items():
        with open(os.path.join(bench, "limits", cell + ".json"), "w") as f:
            json.dump(lims, f)
    if extra:
        extra(spec, bench)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
