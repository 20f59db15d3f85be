"""The SR serving cell (``drivers/sr_serve.py``) and its counts on the CPU.

* the benchmark's counts at the published widths: the operations a tile of
  SwinIR-L's forward (the hand count, 253.3 GFLOP) and the bytes of one
  masked window attention of a request;
* a tiny SwinIR cell, added as files and entries alone, runs end to end
  through ``run.main(..., device="cpu")``: the port's ``define_model``
  builds the tiny widths of the test configuration (its preset stood in
  for), ``apply`` serves;
* the check that decides ``correct`` fails the bf16 control and each
  planted fault: one tile +0.01, one shifted block run unshifted; the
  tapped blocks are held to float32 from the program's own inputs;
* the cell's six per-layer readers read nothing from a record that holds
  nothing (a program without the spans, a run off a card) and the
  arithmetic they state from one that does.
"""
from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.drivers import common, sr_serve
from benchmark.harness import registry, swin_counts

from conftest import REPO, make_root

CELL = "swinir_tiny.serve_srtiny"
LIMITS = {CELL: {"sr_tile_ratio": 3.0, "sr_block_err": 1e-4,
                 "launch_misses": 0}}
SEED = 2**33 + 1919
METRICS = ("swin.body_ms", "swin.upsample_ms", "swin.attn_kernel_ms",
           "swin.attn_roofline", "swin.mfu", "serve.idle_share")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("swin")),
                     cells={CELL: ("swinir_tiny", "serve_srtiny")},
                     limits=LIMITS)


@pytest.fixture(autouse=True)
def tiny_preset(root, monkeypatch):
    """``define_model``'s real-world preset at the test configuration's
    widths (its published one is SwinIR-L)."""
    from srbh_tpu_torch.tools import swinir_harness

    spec = registry.load_spec(root)
    m = registry.load_config(root, spec, "swinir_tiny")["model"]
    preset = dict(upscale=4, in_chans=3, embed_dim=m["embed_dim"],
                  depths=tuple(m["depths"]), num_heads=tuple(m["num_heads"]),
                  window_size=m["window_size"], mlp_ratio=m["mlp_ratio"],
                  img_range=m["img_range"], upsampler=m["upsampler"],
                  resi_connection=m["resi_connection"],
                  num_feat=m["num_feat"])
    monkeypatch.setattr(swinir_harness, "_preset", lambda *a, **k: preset)


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


def test_tile_flops_at_published_widths():
    cfg = registry.load_config(REPO, registry.load_spec(REPO), "swinir_x4")
    c = swin_counts.serve_counts(cfg, 8)
    assert abs(c["tile_flops"] / 253.3e9 - 1) < 0.01
    assert c["attn_calls"] == 54
    assert c["attn_flops"] == 54 * 4 * 8 * 512 * 64 * 64 * 30


def test_attention_bytes_of_a_masked_call():
    b = swin_counts.attention_bytes(8, 512, 64, 30, nw=64)
    assert abs(b / 127e6 - 1) < 0.01
    assert b - swin_counts.attention_bytes(8, 512, 64, 30) == 4 * 64 * 64 * 64


def test_the_cell_runs_end_to_end(root, capsys):
    out = _result(root, capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert {"serve_tiles_per_s", "serve_p95_ms", "setup_s"} <= set(
        out["metrics"])
    assert out["checks"]["launch_misses"]["value"] == 0
    assert out["checks"]["sr_tile_ratio"]["value"] < 1.0
    assert out["checks"]["sr_block_err"]["value"] < 1e-5


def test_unshifted_block_fails_correct(root, capsys, monkeypatch):
    build = sr_serve.port_model
    monkeypatch.setattr(sr_serve, "port_model",
                        lambda *a: sr_serve.unshift(build(*a)))
    out = _result(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["sr_tile_ratio"]["value"] > 3.0
    # the unshifted block is the second tapped one
    assert out["checks"]["sr_block_err"]["value"] > 0.1


def test_control_and_faults_fail_the_limits(root):
    ctx = _ctx(root)
    out = sr_serve.run(ctx)
    assert out["correct"], out["checks"]
    lims = common.limits(root, CELL)
    readings = {"control": sr_serve.control(ctx, out),
                **sr_serve.faults(ctx, out)}
    for name in ("control", "one_tile", "unshifted_block"):
        ok, checks = common.judge(readings[name], lims)
        assert not ok, (name, checks)
    # the output's fault leaves the blocks as the program computed them
    assert readings["one_tile"]["sr_block_err"] < 1e-5
    assert readings["control"]["sr_block_err"] > 1e-3
    # off a card cuBLAS has no TF32: that control is the truth itself
    assert readings["tf32_matmul"]["sr_tile_ratio"] == 0.0
    assert readings["tf32_matmul"]["sr_block_err"] == 0.0


def test_tiles_are_seeded_smooth_and_in_range():
    cfg = {"model": {"tile": 32}}
    a = sr_serve.tile_pool(2, 3, cfg, SEED, "cpu")
    assert a.shape == (2, 3, 32, 32, 3)
    assert torch.equal(a, sr_serve.tile_pool(2, 3, cfg, SEED, "cpu"))
    assert not torch.equal(a, sr_serve.tile_pool(2, 3, cfg, SEED + 1, "cpu"))
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    # neighbouring pixels agree as imagery's do, not as white noise's
    x = a.flatten(0, 1)
    d = (x[:, 1:] - x[:, :-1]).std() / x.std()
    assert d < 0.5


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_from_an_empty_record(root, name):
    assert registry.metric_reader(REPO, name)({}) is None


def test_readers_arithmetic():
    c = {"tile_flops": 253.3e9, "attn_flops": 4.0e9, "attn_bytes": 6.7e9,
         "attn_calls": 54}
    rec = {"counts": c, "traced_requests": 12, "attn_kernels": 648,
           "attn_kernel_s": 12 * 4.8e-3, "tiles_per_s": 50.0,
           "trace": {"busy_s": 0.9, "window_s": 1.0},
           "range_kernel_ms": {"swinir.body": [60.0, 61.0, 90.0],
                               "swinir.upsample": [2.0, 2.5]}}
    read = {n: registry.metric_reader(REPO, n)(rec) for n in METRICS}
    assert read["swin.body_ms"] == pytest.approx(61.0)
    assert read["swin.upsample_ms"] == pytest.approx(2.25)
    assert read["swin.attn_kernel_ms"] == pytest.approx(4.8)
    assert read["swin.attn_roofline"] == pytest.approx(
        100 * 6.7e9 / 3.35e12 / 4.8e-3)
    assert read["swin.mfu"] == pytest.approx(100 * 253.3e9 * 50 / 495e12)
    assert read["serve.idle_share"] == pytest.approx(10.0)


def test_the_cell_is_declared(root):
    spec = registry.load_spec(REPO)
    cell = registry.find_cell(spec, "swinir_x4.serve_b8")
    assert cell["chips"] == 1 and cell["config"] == "swinir_x4"
    per_layer = [m["name"] for m in registry.cell_metrics(spec, cell["name"],
                                                          True)]
    assert sorted(per_layer) == sorted(METRICS)
    assert os.path.isfile(os.path.join(REPO, "benchmark", "limits",
                                       "swinir_x4.serve_b8.json"))


def test_range_kernels_are_found_one_a_forward():
    """The traced run's reader of the port's ranges finds one
    ``srbh.swinir.body`` and one ``srbh.swinir.upsample`` a forward (no
    kernels on the CPU: 0 ms each), and nothing where no span opens."""
    from srbh_tpu_torch.models.swinir import SwinIR
    from srbh_tpu_torch.tools import swinir_harness

    model = SwinIR(embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                   mlp_ratio=2, upscale=4, upsampler="nearest+conv",
                   resi_connection="1conv", num_feat=8).eval()
    x = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(5))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            swinir_harness.apply(model, x)
    got = sr_serve.range_kernel_ms(prof.events(), sr_serve.RANGES)
    assert got == {"swinir.body": [0.0, 0.0], "swinir.upsample": [0.0, 0.0]}
    with torch.profiler.profile(activities=acts) as prof:
        torch.ones(3).sum()
    assert sr_serve.range_kernel_ms(prof.events(), sr_serve.RANGES) == {
        "swinir.body": [], "swinir.upsample": []}


def test_the_body_counts_the_hand_kernels_no_range_holds():
    """A kernel launched through ctypes is linked to no operation, so no
    range's device time holds it: the reader takes the kernels of that name
    the trace leaves unlinked; one an operation holds is not counted
    twice."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def dev(name, us):
        return NS(device_type=DeviceType.CUDA, name=name,
                  time_range=NS(start=0, end=us))

    name = sr_serve.KERNEL
    events = [dev(name, 300.0), dev(name, 200.0), dev("gemm", 900.0),
              NS(device_type=DeviceType.CPU, name="aten::op",
                 kernels=[NS(name=name, duration=200.0)]),
              NS(device_type=DeviceType.CPU, name="srbh.swinir.body",
                 kernels=[])]
    assert sr_serve.unlinked_kernel_ms(events, name) == pytest.approx(0.3)
    assert sr_serve.unlinked_kernel_ms(events[1:], name) == 0.0
