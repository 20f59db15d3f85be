"""The port's SR finetune and evaluation drivers against the JAX package's.

* ``LRHRPairDataset`` against the JAX dataset on one ``np.random.Generator``
  state: without augmentation equal; with it equal where the rotation does
  not fire, within the float32-against-cv2 bounds of
  ``tests/test_torch_data.py`` where it does (the JAX package rotates with
  cv2's fixed-point bilinear), and the generator ends in the same state.
* ``num_sample``: the rows of pandas' ``DataFrame.sample(n, random_state=0)``.
* ``train_sr`` (6 pairs, batch 2 -> 3 steps) writes ``net_g`` / ``net_d``,
  which ``load_sr_generator`` reloads to an identical generator.
* ``eval_sr``: PSNR / SSIM / cPSNR against the JAX ``eval_sr`` on the same
  carried weights within 1e-3, the ``acc1.txt`` lines, zeros for no pairs.
* ``trainer_from_yml`` on a YAML written here, against the JAX twin.
* The host metrics (PSNR, SSIM, cPSNR, BT.601 conversions) equal
  ``srbh_tpu.metrics.image``'s.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from srbh_tpu.data import augment as jaug
from srbh_tpu.data.dataset import LRHRPairDataset as JaxPairs
from srbh_tpu.metrics import image as jimage
from srbh_tpu.train.sr_config import trainer_from_yml as jax_trainer_from_yml
from srbh_tpu.train.sr_driver import eval_sr as jax_eval_sr
from srbh_tpu.train.sr_trainer import RealESRGANTrainer as JaxTrainer
from srbh_tpu_torch import convert
from srbh_tpu_torch.data import augment as taug
from srbh_tpu_torch.data.dataset import LRHRPairDataset
from srbh_tpu_torch.data.tiff import write_tiff
from srbh_tpu_torch.metrics import image as timage
from srbh_tpu_torch.train.sr_config import load_finetune_yml, trainer_from_yml
from srbh_tpu_torch.train.sr_driver import eval_sr, load_sr_generator, train_sr
from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_block=1, num_feat=8, num_grow_ch=8, disc_feat=8, perceptual=False)


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """6 pairs of 16x16 Sentinel-2 RGB (uint16) and 64x64 GoogleEarth
    (uint8), as ``tests/test_sr_driver.py`` writes them."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    names = [f"p_{i}.tif" for i in range(6)]
    os.makedirs(root / "s2p")
    os.makedirs(root / "gep")
    for n in names:
        write_tiff(str(root / "s2p" / n),
                   rng.integers(0, 3000, (16, 16, 3)).astype(np.uint16),
                   (0.0, 10.0, 0.0, 100.0, 0.0, -10.0))
        write_tiff(str(root / "gep" / n),
                   rng.integers(0, 255, (64, 64, 3)).astype(np.uint8),
                   (0.0, 2.5, 0.0, 100.0, 0.0, -2.5))
    with open(root / "list.csv", "w") as f:
        f.writelines(f"{n}\n" for n in names)
    os.makedirs(root / "stats")
    np.savetxt(root / "stats" / "s2p_minmax.txt",
               np.stack([np.zeros(3), np.full(3, 3000.0)]))
    return root


def _datasets(root, **kw):
    args = (str(root / "list.csv"), str(root), str(root / "stats"))
    kw = dict(s2dir="s2p", gedir="gep", **kw)
    return LRHRPairDataset(*args, **kw), JaxPairs(*args, **kw)


def test_pair_augmentation_matches_jax_on_one_generator_state():
    rng = np.random.default_rng(1)
    lr = rng.uniform(0, 3000, (16, 16, 3)).astype(np.float32)
    hr = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    rotated = 0
    for seed in range(12):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = taug.augment_lrhr_pair(a, lr, hr), jaug.augment_lrhr_pair(b, lr, hr)
        assert a.random() == b.random()  # the same draws were taken
        probe = np.random.default_rng(seed)
        fired = [probe.random() < 0.5 and (probe.integers(-1, 2) or True),
                 probe.random() < 0.5 and (probe.permutation(4) is not None),
                 probe.random() < 0.5]
        for g, w, scale in zip(got, want, (3000.0, 255.0)):
            assert g.shape == w.shape
            if not fired[2]:
                np.testing.assert_array_equal(g, w)
            else:
                err = np.abs(g - w) / scale
                assert err.max() < 0.03 and err.mean() < 0.004
        rotated += bool(fired[2])
    assert 0 < rotated < 12


@pytest.mark.parametrize("aug", [False, True])
def test_pair_dataset_matches_jax(pair_root, aug):
    port, jds = _datasets(pair_root, aug=aug, seed=3)
    assert len(port) == len(jds) == 6
    for i in range(6):
        got, want = port[i], jds[i]
        assert set(got) == set(want) == {"lq", "gt"}
        for k in ("lq", "gt"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            if aug:
                assert np.abs(got[k] - want[k]).max() < 0.03, k
            else:
                np.testing.assert_array_equal(got[k], want[k])
        assert 0 <= got["lq"].min() and got["lq"].max() <= 1


def test_num_sample_takes_the_rows_of_pandas_sample(pair_root):
    port, jds = _datasets(pair_root, num_sample=4)
    want = pd.read_csv(pair_root / "list.csv", header=None).sample(n=4, random_state=0)
    assert [r[0] for r in port._rows] == list(want[0]) == [r[0] for r in jds._rows]
    for i in range(4):
        np.testing.assert_array_equal(port[i]["gt"], jds[i]["gt"])
    names = [f"n{i}" for i in range(50)]
    picked = np.random.RandomState(0).choice(50, 17, replace=False)
    assert [names[i] for i in picked] == list(
        pd.DataFrame({0: names}).sample(n=17, random_state=0)[0])


def test_train_sr_writes_checkpoints_that_reload(pair_root, tmp_path):
    tr = RealESRGANTrainer(**TINY)
    ds, _ = _datasets(pair_root, aug=True)
    logdir = str(tmp_path / "sr")
    state = train_sr(tr, ds, logdir, epochs=1, batch_size=2, num_workers=0,
                     device="cpu")
    assert state.step == 3  # 6 pairs / batch 2
    g = torch.load(os.path.join(logdir, "net_g"), weights_only=True)
    d = torch.load(os.path.join(logdir, "net_d"), weights_only=True)
    assert set(g) == {"params", "params_ema", "epoch", "current_iter"}
    assert (g["epoch"], g["current_iter"], d["current_iter"]) == (1, 3, 3)
    assert "conv1.weight_u" in d["params"] and "conv1.weight_v" in d["params"]
    fresh = tr.init(1, (2, 16, 16, 3), device="cpu")
    restored = load_sr_generator(tr, logdir, fresh)
    for a, b in ((restored.net_g, state.net_g), (restored.g_ema, state.g_ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    assert not all(torch.equal(v, w) for v, w in zip(
        state.net_g.parameters(), state.g_ema.parameters()))
    assert load_sr_generator(tr, str(tmp_path / "none"), fresh) is fresh


def test_eval_sr_matches_jax_and_writes_acc(pair_root, tmp_path):
    jt = JaxTrainer(**TINY)
    js = jt.init(jax.random.PRNGKey(0), (2, 16, 16, 3))
    g, ema, d, _, _ = convert.gan_state_from_jax(
        jax.device_get(js.g_params), jax.device_get(js.g_ema),
        jax.device_get(js.d_vars), num_block=1)
    tr = RealESRGANTrainer(**TINY)
    state = tr.init(0, (2, 16, 16, 3), g_state=g, d_state=d, device="cpu")
    state.g_ema.load_state_dict(ema)
    port, jds = _datasets(pair_root)
    want = jax_eval_sr(jt, js, jds, batch_size=2)
    got = eval_sr(tr, state, port, txtpath=str(tmp_path / "acc1.txt"), batch_size=2,
                  num_workers=0, device="cpu")
    for k in ("psnr", "ssim", "cpsnr"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    lines = open(tmp_path / "acc1.txt").read().splitlines()
    assert lines[0] == "psnr, ssim" and len(lines) == 6
    assert float(lines[1]) == pytest.approx(got["psnr"], abs=1e-3)
    assert float(lines[5]) == pytest.approx(got["cpsnr"], abs=1e-3)
    fn = tr._eval_sr_fn
    empty = eval_sr(tr, state, port, batch_size=2, max_batches=0, num_workers=0,
                    device="cpu")
    assert empty == {"psnr": 0.0, "ssim": 0.0, "cpsnr": 0.0}
    assert tr._eval_sr_fn is fn  # built once per trainer


def test_trainer_from_yml_matches_jax(tmp_path):
    path = tmp_path / "finetune.yml"
    path.write_text(
        "scale: 4\nl1_gt_usm: true\npercep_gt_usm: false\ngan_gt_usm: true\n"
        "network_g: {num_feat: 16, num_block: 2, num_grow_ch: 8}\n"
        "network_d: {num_feat: 8}\n"
        "datasets: {train: {batch_size_per_gpu: 6, gt_size: 128, use_rot: true}}\n"
        "train:\n  ema_decay: 0.99\n  total_iter: 1000\n  warmup_iter: 10\n"
        "  optim_g: {lr: 2.0e-4}\n  scheduler: {milestones: [500, 800], gamma: 0.1}\n"
        "  perceptual_opt: {perceptual_weight: 1.0}\n  gan_opt: {loss_weight: 0.05}\n")
    from srbh_tpu.train.sr_config import load_finetune_yml as jax_load

    assert load_finetune_yml(str(path)) == jax_load(str(path))
    want = jax_trainer_from_yml(str(path))
    got = trainer_from_yml(str(path), dtype=torch.bfloat16, perceptual=False)
    for k in ("ema_decay", "gan_weight", "lr", "l1_gt_usm", "percep_gt_usm",
              "gan_gt_usm"):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.num_block, got.num_feat, got.num_grow_ch, got.disc_feat) == (
        want.net_g.num_block, want.net_g.num_feat, want.net_g.num_grow_ch,
        want.net_d.num_feat)
    assert got.dtype == torch.bfloat16 and not got.perceptual
    for step in (0, 5, 10, 499, 500, 800, 900):
        assert got.schedule(step) == pytest.approx(float(want.schedule(step)), rel=1e-6)


@pytest.mark.parametrize("crop,y,order", [(0, False, "HWC"), (4, True, "HWC"),
                                          (2, False, "CHW")])
def test_host_metrics_equal_jax(crop, y, order):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (40, 40, 3)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).round()
    if order == "CHW":
        a, b = a.transpose(2, 0, 1), b.transpose(2, 0, 1)
    for name in ("calculate_psnr", "calculate_ssim", "calculate_cpsnr"):
        kw = dict(crop_border=crop, input_order=order, test_y_channel=y)
        assert getattr(timage, name)(a, b, **kw) == getattr(jimage, name)(a, b, **kw), name
    assert timage.calculate_psnr(a, a) == float("inf")
    u8 = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    for img in (u8, u8.astype(np.float32) / 255):
        for y_only in (False, True):
            np.testing.assert_array_equal(timage.bgr2ycbcr(img, y_only),
                                          jimage.bgr2ycbcr(img, y_only))
    np.testing.assert_array_equal(timage.to_y_channel(u8.astype(np.float64)),
                                  jimage.to_y_channel(u8.astype(np.float64)))
