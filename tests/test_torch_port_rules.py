"""Rules the PyTorch port keeps.

* It imports nothing of JAX, flax or the JAX package ``srbh_tpu``, and none
  of pandas, cv2, osgeo, pyproj or PIL, which the card's machine lacks.
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module's tests: tier-1 runs six test
    processes on eight cores, and torch's default of one thread a core made
    them oversubscribe. Every ``tests/test_torch_*.py`` imports this."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                 "predict.__main__", "ops.aggregate", "ops.device_aug",
                 "ops.usm", "losses.sr", "models.vgg", "models.discriminators",
                 "train.sr_trainer", "train.sr_driver", "train.sr_config",
                 "metrics.image", "metrics.writers", "data.png",
                 "models.edsr", "models.espcn", "models.sr_regress",
                 "models.lpips", "models.clip", "ops.ssim",
                 "losses.ssim_loss", "losses.segmentation", "metrics.learned",
                 "train.optimizers", "utils.eval_seg", "utils.ramps",
                 "utils.cam", "utils.profiler", "bench", "tools.timing",
                 "tools._trace", "tools.profile_flagship",
                 "tools.conv_microbench", "tools.train_bench",
                 "tools.train_diag", "tools.sr_train_bench",
                 "tools.loader_bench", "tools.composed_bench",
                 "tools.predict_stress", "tools.ref_bench",
                 "tools.export_model", "data.crs", "data.datalist",
                 "data.stats", "data.legacy", "data.raster",
                 "tools.preprocess", "tools.products", "native",
                 "parallel.collectives", "parallel.mesh", "parallel.data",
                 "parallel.spatial", "parallel.tensor", "parallel.pipeline",
                 "ops.s2d", "ops.quant", "models.dual_head",
                 "examples.quickstart", "examples.parallel_modes"):
        assert f"srbh_tpu_torch.{name}" in mods


def test_port_imports_no_jax():
    """Nor what the card's machine lacks: pandas, cv2, GDAL's osgeo, pyproj
    and PIL."""
    banned = ("jax", "flax", "srbh_tpu", "pandas", "cv2", "osgeo", "pyproj",
              "PIL")
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"banned = {banned!r}\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in banned)\n"
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
    from srbh_tpu_torch.examples import parallel_modes, quickstart
    from srbh_tpu_torch.metrics import learned
    from srbh_tpu_torch.models.clip import CLIPVisionTransformer
    from srbh_tpu_torch.models.lpips import LPIPS
    from srbh_tpu_torch.predict import __main__ as predict_cli
    from srbh_tpu_torch.predict.device_stitcher import DeviceMosaicAccumulator
    from srbh_tpu_torch.predict.predictor import (
        make_city_step,
        predict_cities,
        predict_city,
    )
    from srbh_tpu_torch.tools import swinir_harness
    from srbh_tpu_torch.train import __main__ as train_cli
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.sr_driver import eval_sr, train_sr
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
    from srbh_tpu_torch.train.steps import make_train_step
    from srbh_tpu_torch.utils.profiler import StepTimer

    img = torch.zeros(8, 8, 3).numpy()
    tiny_clip = CLIPVisionTransformer(8, 4, 8, 1, 2, 4)
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
        "make_train_step(device_aug=True)": lambda: make_train_step(
            torch.nn.Identity(), None, device_aug=True),
        "RealESRGANTrainer.init": lambda: RealESRGANTrainer(num_block=1).init(),
        "train_sr": lambda: train_sr(RealESRGANTrainer(), [], ""),
        "eval_sr": lambda: eval_sr(RealESRGANTrainer(), None, []),
        "trainer.main_test": lambda: trainer.main_test(TrainConfig()),
        "train.__main__.main": lambda: train_cli.main([]),
        "swinir_harness.run_folder": lambda: swinir_harness.run_folder(
            "color_dn", "", None),
        "swinir_harness.main": lambda: swinir_harness.main([]),
        "calculate_clipscore": lambda: learned.calculate_clipscore(
            img, img, tiny_clip.state_dict(), model=tiny_clip),
        "calculate_lpips": lambda: learned.calculate_lpips(
            img, img, LPIPS().state_dict()),
        "StepTimer": lambda: StepTimer(1),
        "dryrun_multichip": lambda: entry.dryrun_multichip(1),
        "make_city_step(mesh=...)": lambda: make_city_step(
            torch.nn.Identity(), torch.nn.Identity(), mesh=object(),
            partition="spatial"),
        "examples.quickstart.main": lambda: quickstart.main(),
        "examples.parallel_modes.main": lambda: parallel_modes.main(),
    }


@pytest.mark.parametrize("name", ["flagship", "entry", "make_city_step",
                                  "define_model", "trainer.main",
                                  "make_train_step", "DataLoader",
                                  "predict_city", "predict_cities",
                                  "DeviceMosaicAccumulator",
                                  "predict.__main__.main",
                                  "make_train_step(device_aug=True)",
                                  "RealESRGANTrainer.init", "train_sr",
                                  "eval_sr", "trainer.main_test",
                                  "train.__main__.main",
                                  "swinir_harness.run_folder",
                                  "swinir_harness.main", "calculate_clipscore",
                                  "calculate_lpips", "StepTimer",
                                  "dryrun_multichip",
                                  "make_city_step(mesh=...)",
                                  "examples.quickstart.main",
                                  "examples.parallel_modes.main"])
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
