"""BENCHMARK.json against the contract's shape, discovery of every file by
name, and a cell, a configuration, a traffic mix and a per-layer metric
added as files and entries alone."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import run
from benchmark.harness import registry

from conftest import DATA, REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return registry.load_spec(REPO)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_names_units_and_sources(spec):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_the_contract_asks(spec):
    for cell in spec["workloads"]:
        e2e = [m["name"] for m in registry.cell_metrics(spec, cell["name"],
                                                        False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        per_layer = registry.cell_metrics(spec, cell["name"], True)
        assert per_layer, cell["name"]
        for m in per_layer:
            assert m["moves"] in e2e, (cell["name"], m["name"])
        assert cell["chips"] == 1


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "limits"])
def test_every_file_is_found_by_name(spec, kind):
    for cell in spec["workloads"]:
        if kind == "configs":
            assert registry.load_config(REPO, spec, cell["config"])
        elif kind == "traffic":
            tr = registry.load_traffic(REPO, cell["traffic"])
            assert registry.driver(tr).run
        elif kind == "limits":
            path = os.path.join(REPO, "benchmark", "limits",
                                cell["name"] + ".json")
            assert os.path.isfile(path), path
        else:
            for m in registry.cell_metrics(spec, cell["name"], True):
                assert callable(registry.metric_reader(REPO, m["name"]))


def test_configs_are_unique_files_under_paths(spec):
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(REPO, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert "precision" in data and "assumed" in data


def _add_dummy(spec, bench):
    """A new configuration, traffic mix, cell and per-layer metric, as new
    files and entries only."""
    shutil.copy(os.path.join(DATA, "flagship_tiny.json"),
                os.path.join(bench, "configs", "dummy_model.json"))
    tr = json.load(open(os.path.join(DATA, "serve_tiny.json")))
    tr["batch"] = 2
    json.dump(tr, open(os.path.join(bench, "traffic", "dummy_mix.json"), "w"))
    with open(os.path.join(bench, "metrics", "dummy.requests.py"), "w") as f:
        f.write("def read(record):\n    return float(record['batch'])\n")
    json.dump({"height_tile_ratio": 3.0, "build_tile_ratio": 3.0},
              open(os.path.join(bench, "limits", "dummy_model.dummy_mix.json"),
                   "w"))
    spec["configs"].append({"name": "dummy_model", "source": "test",
                            "file": "benchmark/configs/dummy_model.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy_model.dummy_mix",
                              "config": "dummy_model", "traffic": "dummy_mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0].setdefault("workloads", []).append(
        "dummy_model.dummy_mix")
    spec["per_layer"].append({"name": "dummy.requests", "unit": "tiles",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "serve_tiles_per_s",
                              "workloads": ["dummy_model.dummy_mix"]})


def test_a_cell_added_as_files_runs(tmp_path, capsys):
    root = make_root(str(tmp_path), extra=_add_dummy)
    spec = registry.load_spec(root)
    assert registry.find_cell(spec, "dummy_model.dummy_mix")
    rc = run.main(["--workload", "dummy_model.dummy_mix", "--seed",
                   str(2**31 + 11), "--seconds", "0.5", "--trace", "0"],
                  device="cpu", root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert {"serve_tiles_per_s", "setup_s"} <= set(out["metrics"])
    assert list(out)[-1] == "checks"
    reader = registry.metric_reader(root, "dummy.requests")
    assert reader({"batch": 2}) == 2.0


def test_no_card_no_result(tmp_path, capsys):
    """Off a card (and asked to look for one) a run prints no result and
    exits with another code than 0."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "flagship_b4.serve_b32", "--seed", "1",
                   "--seconds", "1"], root=REPO)
    assert rc != 0
    assert capsys.readouterr().out == ""
