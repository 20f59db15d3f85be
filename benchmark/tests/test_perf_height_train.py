"""The height-training cell (``drivers/height_train.py``) on the CPU.

* a tiny cell (the flagship's train step with a tiny encoder and RRDBNet,
  the published decoder; 24 tiles, batch 4), added as files and entries
  alone, runs end to end through ``run.main(..., device="cpu")``: the
  trainer's loader, models, ``TrainState`` and ``make_train_step``, checked
  against ``reference/height_train.py``;
* the bf16 control and the planted faults fail the limits: half a batch,
  a step that leaves the state as it was, and in the loader's first batch
  heights left unrotated and the next epoch's draws;
* the synthetic tiles are seeded, in the dataset's on-disk form, and the
  port's dataset reads them;
* the cell's per-layer readers read nothing from a record that holds
  nothing (a program without the ``train.*`` spans) and the arithmetic
  they state from one that does.
"""
from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.drivers import common, height_train
from benchmark.harness import registry
from benchmark.synth import height_tiles

from conftest import REPO, make_root

CELL = "flagship_ttiny.train_ttiny"
LIMITS = {CELL: {"loss1_gap": 1e-4, "grad_err": 1e-3, "grad_gap": 1e-3,
                 "change_gap": 0.05, "window_loss1_gap": 1e-4,
                 "window_loss_gap": 1e-4,
                 "window_change_gap": 0.05, "loader_image_err": 1e-3,
                 "loader_target_miss": 1e-3}}
SEED = 2**33 + 77
METRICS = ("train.mfu", "train.idle_share", "train.loader_wait_ms",
           "train.model_pass_stream_ms", "train.adam_stream_ms")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("train")),
                     cells={CELL: ("flagship_ttiny", "train_ttiny")},
                     limits=LIMITS)


def _ctx(root):
    spec = registry.load_spec(root)
    c = registry.find_cell(spec, CELL)
    return SimpleNamespace(
        root=root, cell=c, config=registry.load_config(root, spec, c["config"]),
        traffic=registry.load_traffic(root, c["traffic"]), seed=SEED,
        seconds=0.5, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter())


def test_the_cell_runs_end_to_end(root, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device="cpu", root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert {"train_tiles_per_s", "setup_s"} <= set(out["metrics"])
    # float32 on the CPU: the reference follows the program closely
    assert out["checks"]["loss1_gap"]["value"] < 1e-5
    assert out["checks"]["window_change_gap"]["value"] < 0.05


def test_control_and_faults_fail_the_limits(root):
    ctx = _ctx(root)
    out = height_train.run(ctx)
    assert out["correct"], out["checks"]
    lims = common.limits(root, CELL)
    readings = {"control": height_train.control(ctx, out),
                **height_train.faults(ctx, out)}
    for name in ("control", "half_batch", "unchanged", "unrotated_heights",
                 "next_epoch"):
        ok, checks = common.judge(readings[name], lims)
        assert not ok, (name, checks)
    assert readings["half_batch"]["loss1_gap"] > 1e-3
    assert readings["unchanged"]["change_gap"] >= 0.5
    assert readings["unrotated_heights"]["loader_target_miss"] > 0.01
    assert readings["next_epoch"]["loader_image_err"] > 0.01
    # off a card TF32 does nothing: the reference with it off is the
    # yardstick itself
    assert common.judge(readings["tf32_off"], lims)[0]
    assert out["readings"]["loader_image_err"] < 1e-4
    assert out["readings"]["loader_target_miss"] < 1e-4


def test_tiles_are_seeded_and_readable(tmp_path):
    from srbh_tpu_torch.data.dataset import S12GlobeDataset

    # enough tiles that every height class has pixels (its weight is
    # an inverse square root of its frequency)
    a = height_tiles.make(32, SEED)
    b = height_tiles.make(32, SEED)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[2], height_tiles.make(32, SEED + 1)[2])
    s2, s1, bh = a
    assert s2.dtype == np.uint16 and s2.shape == (32, 64, 64, 6)
    assert s1.dtype == np.float32 and s1.shape == (32, 64, 64, 2)
    assert bh.dtype == np.uint8 and bh.shape == (32, 256, 256)
    assert 0 < (bh > 0).mean() < 0.5
    paths = height_tiles.write(str(tmp_path), *a)
    ds = S12GlobeDataset(
        os.path.join(paths["datapath"], height_tiles.TRAINLIST),
        paths["datapath"], datastats=paths["datastats"],
        s1dir=height_tiles.S1DIR, s2dir=height_tiles.S2DIR,
        heightdir=height_tiles.BHDIR, preweight=paths["preweight"],
        isaggre=True, ishir=True)
    item = ds[0]
    assert item["image"].shape == (64, 64, 8)
    assert 0.0 <= item["image"].min() and item["image"].max() <= 1.0
    np.testing.assert_array_equal(item["height"], bh[0])


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_from_an_empty_record(name, monkeypatch):
    from srbh_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, "spans", lambda: [])
    assert registry.metric_reader(REPO, name)({}) is None


def test_readers_arithmetic(monkeypatch):
    from srbh_tpu_torch.utils import profiler

    def tree(k):
        root = {"name": "train.step", "parent": None, "t0_ns": 0,
                "t1_ns": 10**8, "self_ns": 0, "device_ms": None}
        kids = [{"name": n, "parent": 4 * k, "t0_ns": 0, "t1_ns": 1,
                 "self_ns": 1, "device_ms": ms}
                for n, ms in (("train.sr_features", 20.0),
                              ("train.model_pass", 100.0 + k),
                              ("train.adam", 5.0 + k))]
        return [root] + kids

    spans = []
    for k in range(4):
        spans += [dict(s, parent=None if s["parent"] is None
                       else len(spans)) for s in tree(k)]
    monkeypatch.setattr(profiler, "spans", lambda: spans)
    rec = {"step_flops": 2.0e12, "steps_per_s": 5.0,
           "trace": {"busy_s": 0.8, "window_s": 1.0},
           "loader_wait_s": [0.001, 0.003]}
    read = {n: registry.metric_reader(REPO, n)(rec) for n in METRICS}
    assert read["train.mfu"] == pytest.approx(100 * 2.0e12 * 5.0 / 495e12)
    assert read["train.idle_share"] == pytest.approx(20.0)
    assert read["train.loader_wait_ms"] == pytest.approx(2.0)
    # the oldest root (the warm-up stretch's) is left out: k = 1, 2, 3
    assert read["train.model_pass_stream_ms"] == pytest.approx(102.0)
    assert read["train.adam_stream_ms"] == pytest.approx(7.0)


def test_the_cell_is_declared():
    spec = registry.load_spec(REPO)
    cell = registry.find_cell(spec, "flagship_b4.train_b16")
    assert cell["chips"] == 1 and cell["config"] == "flagship_b4"
    per_layer = [m["name"] for m in registry.cell_metrics(spec, cell["name"],
                                                          True)]
    assert sorted(per_layer) == sorted(METRICS)
    tr = registry.load_traffic(REPO, cell["traffic"])
    assert (tr["driver"], tr["batch"], tr["tiles"], tr["num_workers"]) == (
        "height_train", 16, 2048, 8)
