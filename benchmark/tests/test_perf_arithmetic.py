"""The arithmetic of the metrics: rates over the whole window, a 95th
percentile over every request, spreads, rooflines, utilisation and the
reduction of a profiled stretch."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import counts, peaks, stats, trace
from benchmark.harness.registry import metric_reader

from conftest import REPO


def test_rate_counts_every_item_over_the_whole_window():
    assert stats.rate(32 * 250, 20.0) == 400.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_over_every_value(q):
    xs = np.random.default_rng(q).exponential(size=257).tolist()
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_roofline_takes_the_larger_bound():
    t, bound = peaks.roofline_seconds(989e12, 1.0, "bfloat16")
    assert (t, bound) == (pytest.approx(1.0), "ops")
    t, bound = peaks.roofline_seconds(1.0, 3.35e12, "bfloat16")
    assert (t, bound) == (pytest.approx(1.0), "bytes")


def test_conv_counts_from_shapes_on_meta():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(64, 32, 3, padding=1)
        x = torch.empty(2, 64, 16, 16)
    c = counts.conv_counts(conv, x, itemsize=2)
    assert c["flops"] == 2 * 2 * 32 * 16 * 16 * 64 * 9
    assert c["bytes"] == 2 * (x.numel() + conv.weight.numel() + 2 * 32 * 16 * 16)


def test_step_flops_counts_backward():
    with torch.device("meta"):
        lin = torch.nn.Linear(128, 64)
        x = torch.empty(8, 128)

    def fwd_bwd():
        lin(x).sum().backward()

    # forward 2*8*128*64; backward: the weight's gradient only (x needs none)
    assert counts.step_flops(fwd_bwd) == 2 * (2 * 8 * 128 * 64)


def test_mfu_and_roofline_readers():
    rec = {"flops": {"step_flops": 32 * 155.67e9, "trunk_flops": 4.0e12,
                     "trunk_bytes": 1.0e9}, "batch": 32, "tiles_per_s": 300.0,
           "trace": {"span_device_s": {"sr_trunk": [0.05, 0.05]},
                     "busy_s": 0.6, "window_s": 1.0}}
    mfu = metric_reader(REPO, "serve.mfu")(rec)
    assert mfu == pytest.approx(100 * 155.67e9 * 300 / 989e12)
    roof = metric_reader(REPO, "serve.trunk_roofline")(rec)
    assert roof == pytest.approx(100 * (4.0e12 / 989e12) / 0.05)
    assert metric_reader(REPO, "serve.idle_share")(rec) == pytest.approx(40.0)
    assert metric_reader(REPO, "serve.trunk_roofline")({"trace": {}}) is None
    gan = {"step_flops": 2.0e12, "steps_per_s": 3.0}
    assert metric_reader(REPO, "gan.mfu")(gan) == pytest.approx(
        100 * 6.0e12 / 495e12)


def test_city_readers():
    rec = {"spans": {"loader_wait": [0.01, 0.03], "stitch": [0.002, 0.004],
                     "finalize": [1.0, 2.0], "write": [0.5, 0.5, 1.0, 1.0]},
           "cities": 2}
    assert metric_reader(REPO, "city.loader_wait_ms")(rec) == pytest.approx(20)
    assert metric_reader(REPO, "city.stitch_ms")(rec) == pytest.approx(3)
    assert metric_reader(REPO, "city.finalize_write_s")(rec) == pytest.approx(3)


def _ev(name, start, end, device, device_total=0.0):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=False, device_time_total=device_total)


def test_reduce_unions_device_time_and_labels_gaps():
    events = [
        _ev("bench.stretch", 0, 100, False),
        _ev("bench.loader_wait", 10, 40, False),
        _ev("bench.step", 40, 90, False, device_total=35.0),
        _ev("kernel_a", 0, 10, True),
        _ev("kernel_b", 5, 10, True),   # overlaps kernel_a
        _ev("kernel_a", 45, 80, True),
    ]
    red = trace.reduce_events(events, wall_s=1.0)
    assert red["busy_s"] == pytest.approx(45e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["device_ops"][0] == ["kernel_a", pytest.approx(45e-6)]
    gaps = dict(red["idle_gaps"])
    # each instant of a gap goes to the innermost span open then
    assert gaps["loader_wait"] == pytest.approx(30e-6)
    assert gaps["step"] == pytest.approx(5e-6 + 10e-6)
    assert gaps["other"] == pytest.approx(10e-6)
    assert red["span_device_s"]["step"] == [pytest.approx(35e-6)]
