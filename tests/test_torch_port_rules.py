"""Rules the PyTorch port keeps.

* It imports nothing of JAX, flax or the JAX package ``srbh_tpu``.
* Its entry points run on the card unless the caller asks for the CPU: with
  no card and ``device=None`` they raise instead of running on the CPU.
* No module of the port catches a failed kernel build or launch (it has no
  ``try`` statement at all), so nothing falls back from the kernel quietly.
* ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import srbh_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PKG = Path(srbh_tpu_torch.__file__).parent


def port_modules():
    return ["srbh_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PKG)], "srbh_tpu_torch.")]


def test_port_has_the_slice_modules():
    mods = set(port_modules())
    for name in ("ops.window_attention", "ops.shuffle", "ops.resize",
                 "models.layers", "models.rrdbnet", "models.efficientnet",
                 "models.unet_decoder", "models.hrfuse", "models.height_model",
                 "models.swinir", "predict.predictor", "tools.swinir_harness",
                 "entry", "convert", "losses.adaptive", "ops.hierarchy",
                 "ops.normalize", "data.tiff", "data.augment", "data.dataset",
                 "data.pipeline", "metrics.streaming", "train.schedule",
                 "train.state", "train.steps", "train.config",
                 "train.checkpoint", "train.trainer", "train.__main__",
                 "data.shapefile", "data.grid", "predict.colormap",
                 "predict.writers", "predict.stitcher",
                 "predict.device_stitcher", "predict.sliding",
                 "predict.__main__"):
        assert f"srbh_tpu_torch.{name}" in mods


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'flax', "
        "'srbh_tpu') or n.startswith(('jax.', 'flax.', 'srbh_tpu.')))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_has_no_try_statements():
    offenders = []
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        offenders += [f"{path.name}:{n.lineno}" for n in ast.walk(tree)
                      if isinstance(n, ast.Try)]
    assert offenders == []


def _entry_points():
    from srbh_tpu_torch import entry
    from srbh_tpu_torch.data.pipeline import DataLoader
    from srbh_tpu_torch.predict import __main__ as predict_cli
    from srbh_tpu_torch.predict.device_stitcher import DeviceMosaicAccumulator
    from srbh_tpu_torch.predict.predictor import (
        make_city_step,
        predict_cities,
        predict_city,
    )
    from srbh_tpu_torch.tools import swinir_harness
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.steps import make_train_step

    return {
        "flagship": lambda: entry.flagship(tiny=True),
        "entry": lambda: entry.entry(),
        "make_city_step": lambda: make_city_step(torch.nn.Identity(),
                                                 torch.nn.Identity()),
        "define_model": lambda: swinir_harness.define_model("classical_sr", 4),
        "trainer.main": lambda: trainer.main(TrainConfig()),
        "make_train_step": lambda: make_train_step(torch.nn.Identity(), None),
        "DataLoader": lambda: DataLoader([], device_put=True),
        "predict_city": lambda: predict_city(None, None, "", "city"),
        "predict_cities": lambda: predict_cities("", [], None, None, "", ""),
        "DeviceMosaicAccumulator": lambda: DeviceMosaicAccumulator(4, 4, 7),
        "predict.__main__.main": lambda: predict_cli.main([]),
    }


@pytest.mark.parametrize("name", ["flagship", "entry", "make_city_step",
                                  "define_model", "trainer.main",
                                  "make_train_step", "DataLoader",
                                  "predict_city", "predict_cities",
                                  "DeviceMosaicAccumulator",
                                  "predict.__main__.main"])
def test_entry_points_need_a_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
