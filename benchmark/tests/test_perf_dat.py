"""The DAT serving cell (``drivers/dat_serve.py``) and its counts on the CPU.

* the benchmark's counts at the published widths: 36 window-branch
  attentions a forward of DAT x4, their operations, and the bytes of one
  masked branch;
* a tiny DAT cell, added as files and entries alone, runs end to end
  through ``run.main(..., device="cpu")``: the port's ``define_model(...,
  arch="dat")`` builds the tiny widths of the test configuration (its
  preset stood in for), ``apply`` serves;
* the check that decides ``correct`` fails the bf16 control and each
  planted fault: one tile +0.01, one shifted block run unshifted, the
  channel attention normalised over channels; the tapped attentions are
  held to float32 from the program's own inputs;
* the cell's per-layer readers read nothing from a record that holds
  nothing (a program without the spans) and the arithmetic they state from
  one that does.
"""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.drivers import common, dat_serve
from benchmark.harness import dat_counts, registry

from conftest import REPO, make_root

CELL = "dat_tiny.serve_dattiny"
LIMITS = {CELL: {"sr_tile_ratio": 3.0, "dat_attn_err": 1e-4,
                 "attn_call_misses": 0}}
SEED = 2**33 + 2024
METRICS = ("dat.spatial_attn_ms", "dat.channel_attn_ms",
           "dat.spatial_attn_roofline", "dat.mfu", "serve.idle_share")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("dat")),
                     cells={CELL: ("dat_tiny", "serve_dattiny")},
                     limits=LIMITS)


@pytest.fixture(autouse=True)
def tiny_preset(root, monkeypatch):
    """``define_model``'s DAT preset at the test configuration's widths."""
    from srbh_tpu_torch.tools import swinir_harness

    spec = registry.load_spec(root)
    m = registry.load_config(root, spec, "dat_tiny")["model"]
    preset = dict(upscale=4, in_chans=3, embed_dim=m["embed_dim"],
                  split_size=tuple(m["split_size"]), depth=tuple(m["depth"]),
                  num_heads=tuple(m["num_heads"]),
                  expansion_factor=m["expansion_factor"],
                  img_range=m["img_range"], num_feat=m["num_feat"])
    monkeypatch.setattr(swinir_harness, "_dat_preset", lambda *a: preset)


def _ctx(root):
    spec = registry.load_spec(root)
    c = registry.find_cell(spec, CELL)
    return SimpleNamespace(
        root=root, cell=c, config=registry.load_config(root, spec, c["config"]),
        traffic=registry.load_traffic(root, c["traffic"]), seed=SEED,
        seconds=0.5, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter())


def _result(root, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_counts_at_published_widths():
    cfg = registry.load_config(REPO, registry.load_spec(REPO), "dat_x4")
    c = dat_counts.serve_counts(cfg, 8)
    assert c["spatial_calls"] == 36
    # 8 tiles of 16 windows of 256 tokens, 3 heads of 30
    assert c["spatial_flops"] == 36 * 4 * 8 * 16 * 3 * 256 * 256 * 30
    assert 120e9 < c["tile_flops"] < 160e9
    assert dat_serve.expected_calls(cfg) == {"spatial": 36, "channel": 18}


def test_attention_bytes_of_a_masked_branch():
    b = dat_counts.attention_bytes(128, 3, 256, 30, nw=16)
    assert b == 4 * 128 * 3 * 256 * 30 * 4 + 4 * 19 * 256 * 256
    least, bound = dat_counts.roofline_ms(
        {"spatial_flops": 36 * 4 * 128 * 3 * 256 * 256 * 30,
         "spatial_bytes": 36 * b})
    assert bound == "bytes"
    assert least == pytest.approx(1e3 * 36 * b / 3.35e12)


def test_the_cell_runs_end_to_end(root, capsys):
    out = _result(root, capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert {"serve_tiles_per_s", "serve_p95_ms", "setup_s"} <= set(
        out["metrics"])
    assert out["checks"]["attn_call_misses"]["value"] == 0
    assert out["checks"]["sr_tile_ratio"]["value"] < 1.0
    assert out["checks"]["dat_attn_err"]["value"] < 1e-5


def test_unshifted_block_fails_correct(root, capsys, monkeypatch):
    build = dat_serve.port_model
    monkeypatch.setattr(dat_serve, "port_model",
                        lambda *a: dat_serve.unshift(build(*a)))
    out = _result(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["dat_attn_err"]["value"] > 0.01


def test_a_missing_attention_call_fails_correct(root, capsys, monkeypatch):
    from srbh_tpu_torch.ops import dat_attention

    inner = dat_attention.channel_attention

    def uncounted(*a):
        dat_attention.calls["channel"] -= 1
        return inner(*a)

    monkeypatch.setattr("srbh_tpu_torch.models.dat.channel_attention",
                        uncounted)
    out = _result(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["attn_call_misses"]["value"] > 0


def test_control_and_faults_fail_the_limits(root):
    ctx = _ctx(root)
    out = dat_serve.run(ctx)
    assert out["correct"], out["checks"]
    lims = common.limits(root, CELL)
    readings = {"control": dat_serve.control(ctx, out),
                **dat_serve.faults(ctx, out)}
    for name in ("control", "one_tile", "unshifted_block", "channel_norm"):
        ok, checks = common.judge(readings[name], lims)
        assert not ok, (name, checks)
    # the output's fault leaves the attention as the program computed it
    assert readings["one_tile"]["dat_attn_err"] < 1e-5
    assert readings["control"]["dat_attn_err"] > 1e-3
    assert readings["channel_norm"]["dat_attn_err"] > 1e-2
    # off a card cuBLAS has no TF32: that control is the truth itself
    assert readings["tf32_matmul"]["sr_tile_ratio"] == 0.0
    assert readings["tf32_matmul"]["dat_attn_err"] == 0.0


def test_weights_follow_the_rules():
    cfg = registry.load_config(REPO, registry.load_spec(REPO), "dat_x4")
    st = dat_serve.dat_weights(cfg, SEED, "cpu")
    assert torch.equal(st["conv_first.weight"],
                       dat_serve.dat_weights(cfg, SEED, "cpu")
                       ["conv_first.weight"])
    t = st["layers.0.blocks.1.attn.temperature"]
    assert t.shape == (6, 1, 1) and 0.5 < float(t.min()) < float(t.max()) < 1.5
    # BatchNorm is no identity: seeded running statistics
    bn = "layers.0.blocks.0.attn.dwconv.1"
    assert float(st[bn + ".running_mean"].abs().max()) > 0
    assert float((st[bn + ".running_var"] - 1).abs().max()) > 0
    # the group tails gain 0.1, the SGFN's depthwise conv the default
    std = lambda k: float(st[k].std() * st[k][0].numel() ** 0.5)  # noqa: E731
    assert std("layers.0.conv.weight") == pytest.approx(0.1, rel=0.05)
    assert std("layers.0.blocks.0.ffn.sg.conv.weight") == pytest.approx(
        2 ** 0.5, rel=0.05)


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_from_an_empty_record(name):
    assert registry.metric_reader(REPO, name)({}) is None


def test_readers_arithmetic():
    c = {"tile_flops": 137e9, "spatial_flops": 108.7e9,
         "spatial_bytes": 1.8e9, "spatial_calls": 36}
    rec = {"counts": c, "traced_requests": 12, "tiles_per_s": 100.0,
           "trace": {"busy_s": 0.95, "window_s": 1.0},
           "range_kernel_ms": {"dat.spatial_attn": [2.0] * 12 * 18,
                               "dat.channel_attn": [1.0] * 12 * 18,
                               "dat.spatial_core": [0.25] * 12 * 36}}
    read = {n: registry.metric_reader(REPO, n)(rec) for n in METRICS}
    assert read["dat.spatial_attn_ms"] == pytest.approx(36.0)
    assert read["dat.channel_attn_ms"] == pytest.approx(18.0)
    least = max(108.7e9 / 495e12, 1.8e9 / 3.35e12)
    assert read["dat.spatial_attn_roofline"] == pytest.approx(
        100 * least / 9e-3)
    assert read["dat.mfu"] == pytest.approx(100 * 137e9 * 100 / 495e12)
    assert read["serve.idle_share"] == pytest.approx(5.0)


def test_the_cell_is_declared():
    spec = registry.load_spec(REPO)
    cell = registry.find_cell(spec, "dat_x4.serve_b8")
    assert cell["chips"] == 1 and cell["config"] == "dat_x4"
    per_layer = [m["name"] for m in registry.cell_metrics(spec, cell["name"],
                                                          True)]
    assert sorted(per_layer) == sorted(METRICS)
    e2e = [m["name"] for m in registry.cell_metrics(spec, cell["name"],
                                                    False)]
    assert sorted(e2e) == ["serve_p95_ms", "serve_tiles_per_s", "setup_s"]


def test_the_weights_template_loads_no_dynamo():
    """The seeded weights are drawn from the reference built on the meta
    device; that build loads no ``torch._dynamo`` (seconds of a run's
    set-up)."""
    import subprocess
    import sys

    code = ("import json, sys\n"
            "from benchmark.drivers import dat_serve\n"
            "cfg = json.load(open('benchmark/configs/dat_x4.json'))\n"
            "dat_serve.dat_weights(cfg, 7, 'cpu')\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
