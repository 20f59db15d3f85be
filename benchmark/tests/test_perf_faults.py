"""The check that decides ``correct`` fails what it must: the control (the
reference a precision lower, in the program's place) and each fault a cell
can have, planted in the program underneath a run that skips the look for
a card. Tiny sizes on the CPU; the same at the cells' sizes on the card is
``python3 -m benchmark.calibrate`` (PERF.md, section 2)."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.drivers import common
from benchmark.harness import registry

from conftest import make_root

SEED = 2**31 + 4242


def _ctx(root, cell):
    spec = registry.load_spec(root)
    c = registry.find_cell(spec, cell)
    return SimpleNamespace(
        root=root, cell=c, config=registry.load_config(root, spec, c["config"]),
        traffic=registry.load_traffic(root, c["traffic"]), seed=SEED,
        seconds=0.5, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter())


def _result(root, cell, capsys):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("faults")))


@pytest.mark.parametrize("cell", ["flagship_tiny.serve_tiny",
                                  "realesrgan_tiny.gan_tiny",
                                  "flagship_tiny.city_tiny"])
def test_sound_run_is_correct_and_control_is_not(root, cell):
    ctx = _ctx(root, cell)
    drv = registry.driver(ctx.traffic)
    out = drv.run(ctx)
    assert out["correct"], out["checks"]
    ok, checks = common.judge(drv.control(ctx, out),
                              common.limits(root, cell))
    assert not ok, checks


def _half_step(make):
    def patched(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(image):
            n = (image.shape[0] + 1) // 2
            h, b = step(image[:n])
            return (torch.cat([h, h[:image.shape[0] - n]]),
                    torch.cat([b, b[:image.shape[0] - n]]))
        return half
    return patched


def _altered_step(make):
    def patched(*args, **kwargs):
        step = make(*args, **kwargs)

        def altered(image):
            h, b = step(image)
            h = h.to(torch.int32)
            h[0] += 30  # three metres on one tile
            return h.to(torch.uint16), b
        return altered
    return patched


@pytest.mark.parametrize("fault", [_half_step, _altered_step])
def test_serve_faults(root, fault, capsys, monkeypatch):
    from srbh_tpu_torch.predict import predictor
    monkeypatch.setattr(predictor, "make_city_step",
                        fault(predictor.make_city_step))
    out = _result(root, "flagship_tiny.serve_tiny", capsys)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_half_step, _altered_step])
def test_city_faults(root, fault, capsys, monkeypatch):
    from srbh_tpu_torch.predict import predictor
    monkeypatch.setattr(predictor, "make_city_step",
                        fault(predictor.make_city_step))
    out = _result(root, "flagship_tiny.city_tiny", capsys)
    assert out["correct"] is False, out["checks"]


def test_city_stitch_dropping_half_a_batch(root, capsys, monkeypatch):
    from srbh_tpu_torch.predict import predictor
    base = predictor.MosaicAccumulator.add_batch

    def half(self, h, b, pos):
        n = max(1, h.shape[0] // 2)
        return base(self, h[:n], b[:n], pos[:n])
    monkeypatch.setattr(predictor.MosaicAccumulator, "add_batch", half)
    out = _result(root, "flagship_tiny.city_tiny", capsys)
    assert out["correct"] is False, out["checks"]


def _gan_fault(kind, sound_calls=0):
    """The trainer's step with ``kind`` planted, sound for its first
    ``sound_calls`` calls (a fault that appears once set-up is over)."""
    def patched_make(self, group=None):
        step = original(self, group)
        calls = [0]

        def faulty(state, lq, gt):
            calls[0] += 1
            if calls[0] <= sound_calls:
                return step(state, lq, gt)
            if kind == "unchanged":
                return {k: torch.zeros(()) for k in (
                    "l_g_pix", "l_g_percep", "l_g_gan", "l_d_real",
                    "l_d_fake")}
            n = lq.shape[0] // 2
            return step(state, lq[:n], gt[:n])
        return faulty
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
    original = RealESRGANTrainer.make_step
    return patched_make


@pytest.mark.parametrize("after_setup", [False, True])
@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_gan_faults(root, kind, after_setup, capsys, monkeypatch):
    """Each fault from the first step on, and, ``after_setup``, only once
    the set-up's steps are over (as a step captured or replayed once warm
    would be): then the window's sampled steps alone fail."""
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
    checked = registry.load_traffic(root, "gan_tiny")["checked_steps"]
    monkeypatch.setattr(RealESRGANTrainer, "make_step", _gan_fault(
        kind, sound_calls=checked if after_setup else 0))
    out = _result(root, "realesrgan_tiny.gan_tiny", capsys)
    assert out["correct"] is False, out["checks"]
    bad = {k for k, v in out["checks"].items()
           if v["value"] is None or v["value"] > v["limit"]}
    if after_setup:
        assert bad <= {"window_loss_gap", "window_change_gap"}, bad
