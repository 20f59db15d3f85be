"""The port's test-set evaluation against the JAX package's.

* The streaming metrics against ``srbh_tpu.metrics.streaming``: the
  confusion matrix exact (labels and predictions out of range left out,
  empty classes NaN), the per-batch-weighted height rows within 1e-12 on
  data whose float32 sums are exact, and within float32 rounding (2e-6 of
  the row) on data whose sums are not: the two frameworks add in another
  order.
* The writers byte-equal to ``srbh_tpu.metrics.writers`` (pandas) when
  both are fed the same metric numbers (NaN, 1e-5, integer counts).
* ``HRUpsample`` / ``SRRegressClsNosuper`` against the JAX models through
  ``convert.nosuper_state_dict`` (1e-5), and one nosuper train step against
  JAX's by the gradient-noise rule (ROADMAP Queue 3).
* ``--encoder_weights``: an efficientnet-pytorch state dict through the
  port's graft and the JAX package's ``load_imagenet_encoder``, a JAX
  encoder ``.npz`` through both ``graft_encoder_npz``, equal encoders; a
  file of another architecture raises, naming the file; a fresh run
  grafts, a resumed one does not.
* ``trainer.main_test`` against the JAX package's on one carried ``.npz``
  checkpoint (efficientnet-test, RRDBNet-1 of width 8, 6 tiles of 32x32):
  the same files with the same lines, columns and header; the RMSE and the
  ``_he`` values within 1e-5 x (1 + |b|), confusion counts within 0.1 % of
  the pixels, and the ``issave`` tifs within 1 LSB on 0.1 % of the pixels.
  The files cannot be byte-equal: the float32 per-tile RMSEs differ in the
  last bits, and random weights' argmaxes can flip on near-ties. Also an
  ``isaggre=False`` nosuper checkpoint, ``max_batches=0`` and no
  checkpoint.
* ``python -m srbh_tpu_torch.train``'s sequence (the repository's
  ``train.py``) with ``main`` / ``main_test`` recorded.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.metrics import streaming as jstream
from srbh_tpu.metrics import writers as jwriters
from srbh_tpu.models import SRRegressClsNosuper as JaxNosuper
from srbh_tpu.train import convert as jconvert
from srbh_tpu.train import trainer as jtrainer
from srbh_tpu.train.config import TrainConfig as JaxConfig
from srbh_tpu.train.state import TrainState as JaxState
from srbh_tpu.train.steps import make_train_step as jax_train_step
from srbh_tpu_torch import convert
from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
from srbh_tpu_torch.losses.adaptive import ce_dice_adapt, mse_adapt
from srbh_tpu_torch.metrics import streaming, writers
from srbh_tpu_torch.models.efficientnet import EfficientNetEncoder
from srbh_tpu_torch.models.height_model import SRRegressClsNosuper
from srbh_tpu_torch.models.hrfuse import HRUpsample
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.predict import __main__ as predict_cli
from srbh_tpu_torch.train import __main__ as train_cli
from srbh_tpu_torch.train import trainer
from srbh_tpu_torch.train.config import TrainConfig
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

ENC = "efficientnet-test"
NCLS = 7
TILES = 6
TOL = 1e-5  # |a - b| <= TOL x (1 + |b|): RMSE and _he values
QUANT_SHARE = 1e-3  # confusion counts, classes and heights of the tifs


# ----------------------------------------------------------------- metrics

def _seg_pair(batches):
    j, t = jstream.SegmentationMetric(NCLS), streaming.SegmentationMetric(NCLS)
    for pred, label in batches:
        j.add_batch(pred, label)
        t.add_batch(torch.from_numpy(pred), torch.from_numpy(label))
    return j, t


SEG_FINALISERS = ("overall_accuracy", "precision", "recall", "f1", "iou",
                  "miou", "fwiou", "mfwiou", "confusion_matrix")


@pytest.mark.parametrize("case", ["out_of_range", "empty_classes"])
def test_segmentation_metric_matches_jax(case):
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        pred = rng.integers(-1, NCLS + 2, (2, 40, 40))
        label = rng.integers(-1, NCLS + 1, (2, 40, 40))
        if case == "empty_classes":  # classes 3 and 5 neither labelled nor predicted
            pred, label = np.clip(pred, 0, NCLS - 1), np.clip(label, 0, NCLS - 1)
            for c in (3, 5):
                pred[pred == c], label[label == c] = 2, 2
        batches.append((pred, label))
    j, t = _seg_pair(batches)
    valid = sum(int(((p >= 0) & (p < NCLS) & (lb >= 0) & (lb < NCLS)).sum())
                for p, lb in batches)
    assert t.confusion_matrix().sum() == valid
    for name in SEG_FINALISERS:
        got, want = getattr(t, name)(), getattr(j, name)()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)
    if case == "empty_classes":
        assert np.isnan(t.iou()[[3, 5]]).all() and np.isnan(t.f1()[3])


def _height_pair(batches):
    j, t = jstream.HeightMetric(NCLS), streaming.HeightMetric(NCLS)
    for pred, ref, cls in batches:
        j.add_batch(pred, ref, cls)
        t.add_batch(*(torch.from_numpy(a) for a in (pred, ref, cls)))
    return j, t


def _height_batches(rng, exact):
    out = []
    for _ in range(4):
        if exact:  # quarters below 16: every float32 sum of the batch is exact
            pred = rng.integers(-64, 64, (1, 64, 64)) / 4
            ref = rng.integers(0, 64, (1, 64, 64)) / 4
        else:
            pred = rng.normal(8, 6, (1, 64, 64))
            ref = np.abs(rng.normal(8, 6, (1, 64, 64)))
        cls = rng.integers(0, NCLS - 1, (1, 64, 64))  # class 6 stays empty
        out.append((pred.astype(np.float32), ref.astype(np.float32), cls))
    return out


@pytest.mark.parametrize("exact", [True, False])
def test_height_metric_matches_jax(exact):
    j, t = _height_pair(_height_batches(np.random.default_rng(1), exact))
    np.testing.assert_array_equal(t.count(), j.count())
    tol = 1e-12 if exact else 2e-6
    np.testing.assert_allclose(t.stats, j.stats, rtol=tol, atol=0)
    for name in ("avg_each", "avg_balance", "avg_all"):
        np.testing.assert_allclose(getattr(t, name)(), getattr(j, name)(),
                                   rtol=tol, atol=0, err_msg=name)
    assert t.count()[6, 0] == 0 and (t.avg_each()[6] == 0).all()


def test_height_rows_are_count_weighted_per_batch():
    """Per class: the sum over batches of the batch's RMSE times its pixel
    count, not a pooled RMSE."""
    batches = _height_batches(np.random.default_rng(2), exact=True)
    _, t = _height_pair(batches)
    want = np.zeros(NCLS)
    for pred, ref, cls in batches:
        for c in range(NCLS):
            m = cls == c
            if m.any():
                want[c] += np.sqrt(np.mean((pred[m] - ref[m]) ** 2)) * m.sum()
    np.testing.assert_allclose(t.stats[:, 0], want, rtol=1e-6)


# ----------------------------------------------------------------- writers

class FixedSeg:
    """A segmentation metric's finalisers with chosen numbers."""

    def __init__(self, rng):
        self.cm = rng.integers(0, 5000, (NCLS, NCLS)).astype(np.float64)
        self.cm[4] = 0  # an empty class
        self.vec = rng.uniform(0, 1, (6, NCLS))
        self.vec[:, 4] = np.nan
        self.vec[2, 1], self.vec[3, 2] = 1e-5, 3.0

    def overall_accuracy(self):
        return 0.25

    def miou(self):
        return np.nan

    def mfwiou(self):
        return 1e-05

    def fwiou(self):
        return self.vec[0]

    def iou(self):
        return self.vec[1]

    def f1(self):
        return self.vec[2]

    def precision(self):
        return self.vec[3]

    def recall(self):
        return self.vec[4]

    def confusion_matrix(self):
        return self.cm


class FixedHeight:
    def __init__(self, rng):
        self.each = rng.uniform(0, 30, (NCLS, 3))
        self.each[6] = 0.0
        self.each[2, 1] = 1e-5
        self.counts = rng.integers(0, 100000, (NCLS, 1)).astype(np.float64)

    def avg_each(self):
        return self.each

    def count(self):
        return self.counts

    def avg_balance(self):
        return self.each.mean(axis=0)

    def avg_all(self):
        return np.array([np.nan, 2.5, -1e-05])


def test_writers_are_byte_equal_to_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    seg, height, meter = FixedSeg(rng), FixedHeight(rng), jstream.AverageMeter()
    meter.update(12.345678901234567, 3)
    for name, metric, ext in (("rmse", meter, ".txt"), ("cls", seg, ".txt"),
                              ("seg", seg, ".csv"), ("height", height, ".csv")):
        for side, mod in (("j", jwriters), ("t", writers)):
            getattr(mod, f"acc2file_{name}")(metric, str(tmp_path / f"{side}{name}.txt"))
        want = (tmp_path / f"j{name}{ext}").read_bytes()
        assert (tmp_path / f"t{name}{ext}").read_bytes() == want, name
    seg_lines = (tmp_path / "tseg.csv").read_text().splitlines()
    assert seg_lines[0].endswith(",oa_miou_mfiou") and ",," in seg_lines[0]
    assert "1e-05" in seg_lines[0] and ",3.0," in seg_lines[4]
    assert (tmp_path / "theight.csv").read_text().startswith("rmse,mae,me,count\n")


# --------------------------------------------------------- nosuper models

def _nosuper_jax(isaggre=False, rate=0.2):
    return JaxNosuper(encoder_name=ENC, upscale=4, isaggre=isaggre,
                      chans_build=NCLS, drop_connect_rate=rate)


def _nosuper_port(variables, isaggre=False, rate=0.2):
    m = SRRegressClsNosuper(ENC, isaggre=isaggre, chans_build=NCLS,
                            drop_connect_rate=rate)
    m.load_state_dict(convert.nosuper_state_dict(variables, ENC, isaggre))
    return m


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in tree.items()}


@pytest.fixture(scope="module")
def nosuper_vars():
    """A JAX nosuper model's variables (isaggre=False), BatchNorm running
    statistics drawn at random."""
    v = jax.device_get(dict(jax.jit(_nosuper_jax().init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 8)))))
    v["batch_stats"] = _random_stats(v["batch_stats"], np.random.default_rng(4))
    return v


def test_hr_upsample_matches_jax():
    from srbh_tpu.models.hrfuse import HRUpsample as JaxHRUpsample

    jm = JaxHRUpsample(out_chans=NCLS, upscale=4)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 8)).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = HRUpsample(8, NCLS, 4)
    sd = {}
    for k in range(2):
        convert._conv(sd, f"upsampler.{2 * k}", v["params"]["upsampler"][f"conv_{k}"])
    convert._conv(sd, "conv_last", v["params"]["conv_last"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 64, 64, NCLS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_nosuper_model_matches_jax(nosuper_vars):
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 8)).astype(np.float32)
    want = jax.jit(_nosuper_jax().apply)(nosuper_vars, jnp.asarray(x))
    tm = _nosuper_port(nosuper_vars).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("isaggre", [True, False])
def test_nosuper_state_dict_names_every_port_tensor(isaggre):
    shapes = jax.eval_shape(_nosuper_jax(isaggre).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 8)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert.nosuper_state_dict(zeros, ENC, isaggre)
    want = SRRegressClsNosuper(ENC, isaggre=isaggre, chans_build=NCLS).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# Largest float32 error of a two-head model's training gradient as a share
# of its tensor's max |g| (tests/test_torch_train_step.py's F32_GRAD_NOISE)
F32_GRAD_NOISE = 0.2


def test_nosuper_train_step_matches_jax(nosuper_vars):
    """One step of the plain (two-head) epoch, drop-connect off. Loss, rmse
    and log-vars within 1e-3; a parameter more than 1e-4 from JAX's is a
    fault only where the float64 gradient stands clear of float32 noise
    (twice ``F32_GRAD_NOISE`` x its tensor's max |g|, plus 1e-6 x the
    model's largest gradient): Adam's first update is +-lr whatever the
    gradient's size."""
    rng = np.random.default_rng(7)
    b = {"image": rng.normal(size=(2, 32, 32, 8)).astype(np.float32),
         "height": np.abs(rng.normal(size=(2, 128, 128))).astype(np.float32) * 8,
         "weight": np.ones((2, 128, 128), np.float32),
         "build": rng.integers(0, NCLS, (2, 128, 128)).astype(np.int32)}
    jstate = JaxState.create(nosuper_vars, n_log_vars=2, lr=1e-3,
                             weight_decay=1e-4, log_var_lr=1e-3)
    jstep = jax_train_step(_nosuper_jax(rate=0.0), None, isaggre=False, seed=0)
    jstate, jm = jstep(jstate, {}, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.float32(1e-3))
    state = TrainState(_nosuper_port(nosuper_vars, rate=0.0), n_log_vars=2)
    m = make_train_step(state.model, None, isaggre=False, seed=0,
                        device="cpu")(state, b, 1e-3)
    for key in ("loss", "rmse"):
        assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-3), key
    np.testing.assert_allclose(m["log_vars"].numpy(), np.asarray(jm["log_vars"]),
                               rtol=1e-3, atol=1e-6)

    m64 = _nosuper_port(nosuper_vars, rate=0.0).double().train()
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    h, bl = m64(t["image"].double().permute(0, 3, 1, 2))
    lv = torch.zeros(2, dtype=torch.float64)
    (mse_adapt(h[:, 0], t["height"].double(), lv[0])
     + ce_dice_adapt(bl, t["build"], lv[1])).backward()
    g64 = {n: p.grad.numpy() for n, p in m64.named_parameters()}
    floor = 1e-6 * max(np.abs(g).max() for g in g64.values())
    want = convert.nosuper_state_dict(
        {"params": jax.device_get(jstate.params),
         "batch_stats": nosuper_vars["batch_stats"]}, ENC, False)
    faults = differ = 0
    for name, p in state.model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy()) > 1e-4
        g = g64[name]
        clear = np.abs(g) > 2 * F32_GRAD_NOISE * np.abs(g).max() + floor
        differ += int(d.sum())
        faults += int((d & clear).sum())
    total = sum(p.numel() for p in state.model.parameters())
    print(f"nosuper step 1: {differ / total:.4%} of params beyond 1e-4")
    assert faults == 0


# ------------------------------------------------------- encoder weights

def _imagenet_sd(name, seed):
    """A random efficientnet-pytorch ImageNet state dict of ``name``: a
    3-channel stem, BatchNorm statistics drawn, the classifier head."""
    enc = init_weights(EfficientNetEncoder(name, 3), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    sd = enc.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0, 0.1, generator=gen)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=gen)
    head = sd["_blocks.0._project_conv.weight"].shape[0]
    sd.update({"_conv_head.weight": torch.randn(64, head, 1, 1, generator=gen),
               "_bn1.weight": torch.ones(64), "_bn1.bias": torch.zeros(64),
               "_bn1.running_mean": torch.zeros(64), "_bn1.running_var": torch.ones(64),
               "_fc.weight": torch.randn(10, 64, generator=gen),
               "_fc.bias": torch.zeros(10)})
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_encoder_of(model):
    """The port model's encoder as a JAX encoder tree (the JAX package's
    converter, efficientnet-pytorch names)."""
    return jconvert._convert_encoder(_np(model.encoder.state_dict()), "", ENC)


def _assert_same_encoder(model, jax_vars):
    got_p, got_s = _jax_encoder_of(model)
    want_p = jax_vars["params"]["encoder"]
    want_s = jax_vars["batch_stats"]["encoder"]
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, w), (path2, g) in zip(flat((want_p, want_s)), flat((got_p, got_s))):
        assert path == path2
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=str(path))


def _fresh_model(cfg):
    model, _ = trainer.build_models(cfg)
    return model


def test_encoder_weights_from_an_imagenet_state_dict(split, tmp_path):
    sd = _imagenet_sd(ENC, 11)
    path = str(tmp_path / "effnet.pth")
    torch.save(sd, path)
    cfg = make_cfg(split, tmp_path, encoder_weights=path)
    model = _fresh_model(cfg)
    trainer.load_encoder_weights(cfg, model)
    enc_p, enc_s = _jax_encoder_of(_fresh_model(cfg))
    variables = {"params": {"encoder": enc_p}, "batch_stats": {"encoder": enc_s}}
    _assert_same_encoder(model, jconvert.load_imagenet_encoder(variables, _np(sd), ENC))
    stem = model.encoder._conv_stem.weight.detach()
    np.testing.assert_allclose(stem[:, 3:6].numpy(), stem[:, :3].numpy())
    np.testing.assert_allclose(stem[:, :3].numpy(), sd["_conv_stem.weight"].numpy() * 3 / 8,
                               rtol=1e-6)


def test_encoder_weights_from_a_jax_encoder_npz(split, tmp_path):
    path = str(tmp_path / "enc.npz")
    jconvert.save_tree_npz(path, jconvert.convert_efficientnet_imagenet(
        _np(_imagenet_sd(ENC, 12)), ENC))
    cfg = make_cfg(split, tmp_path, encoder_weights=path)
    model = _fresh_model(cfg)
    trainer.load_encoder_weights(cfg, model)
    enc_p, enc_s = _jax_encoder_of(_fresh_model(cfg))
    want = jconvert.graft_encoder_npz(
        {"params": {"encoder": enc_p}, "batch_stats": {"encoder": enc_s}}, path)
    _assert_same_encoder(model, want)


@pytest.mark.parametrize("form", ["pth", "npz"])
def test_encoder_weights_of_another_architecture_raise(split, tmp_path, form):
    sd = _imagenet_sd("efficientnet-b0", 13)
    path = str(tmp_path / f"b0.{form}")
    if form == "pth":
        torch.save(sd, path)
    else:
        jconvert.save_tree_npz(path, jconvert.convert_efficientnet_imagenet(
            _np(sd), "efficientnet-b0"))
    cfg = make_cfg(split, tmp_path, encoder_weights=path)
    with pytest.raises(ValueError, match="b0"):
        trainer.load_encoder_weights(cfg, _fresh_model(cfg))


def test_main_grafts_the_encoder_on_a_fresh_run_only(split, tmp_path, capsys):
    path = str(tmp_path / "effnet.pth")
    sd = _imagenet_sd(ENC, 14)
    torch.save(sd, path)
    cfg = make_cfg(split, tmp_path, encoder_weights=path, maxepoch=1)
    trainer.main(cfg, max_steps_per_epoch=1, device="cpu")
    out = capsys.readouterr().out
    assert f"=> encoder initialised from {path}" in out and "RANDOM" not in out
    cfg.maxepoch = 2
    trainer.main(cfg, max_steps_per_epoch=1, device="cpu")
    out = capsys.readouterr().out
    assert "=> resumed epoch 1" in out and "initialised" not in out


def test_main_trains_the_nosuper_variant(split, tmp_path, capsys):
    cfg = make_cfg(split, tmp_path, model_variant="nosuper", maxepoch=1)
    state = trainer.main(cfg, max_steps_per_epoch=2, device="cpu")
    assert state.sr_model is None and state.step == 2
    assert isinstance(state.model, SRRegressClsNosuper)
    assert "SR checkpoint" not in capsys.readouterr().out
    cfg.checkpoint = "checkpoint"
    res = trainer.main_test(cfg, num_sample=4, suffix="ns", device="cpu")
    assert np.isfinite(res["rmse"]) and res["txtpath"].endswith("acc1ns_4.txt")


# --------------------------------------------------------------- main_test

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """``TILES`` synthetic tiles (32x32 S2 / S1, 128x128 heights), the
    train / val / test lists, min-max tables and a height histogram."""
    root = tmp_path_factory.mktemp("eval_split")
    rng = np.random.default_rng(8)
    names = [f"t_{i}.tif" for i in range(TILES)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(root / d)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for n in names:
        write_tiff(str(root / "s2c" / n),
                   rng.integers(0, 5000, (32, 32, 6)).astype(np.uint16), gt)
        write_tiff(str(root / "s1c" / n),
                   rng.uniform(-25, 5, (32, 32, 2)).astype(np.float32), gt)
        write_tiff(str(root / "bhc" / n),
                   rng.integers(0, 100, (128, 128)).astype(np.uint8),
                   (gt[0], 2.5, 0, gt[3], 0, -2.5))
    for split_name in ("train", "val", "test"):
        with open(root / f"dl_{split_name}.csv", "w") as f:
            f.writelines(f"{n},s1c,s2c,bhc\n" for n in names)
    np.savetxt(root / "s2c_minmax.txt", np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(root / "s1c_minmax.txt", np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(root / "bh_stats.txt", hist)
    return root


def make_cfg(root, logdir, config=TrainConfig, **kw):
    base = dict(
        datapath=str(root), trainlist="dl_train.csv", vallist="dl_val.csv",
        testlist="dl_test.csv", logdir=str(logdir),
        logdirhr=str(root / "sr.npz"), datastats=str(root),
        preweight=str(root / "bh_stats.txt"), s1dir="s1c", s2dir="s2c",
        bhdir="bhc", batch_size=2, num_workers=0, encoder_name=ENC,
        super_mid=8, sr_num_block=1, sr_num_feat=8, sr_num_grow=8, tile=32)
    return config(**{**base, **kw})


def _carry(root, name, tree):
    """Write the JAX checkpoint ``tree`` as ``<name>.npz`` in a log
    directory for each framework; returns their paths."""
    dirs = {}
    for side in ("jax", "port"):
        d = root / f"{name}_{side}"
        os.makedirs(d, exist_ok=True)
        jconvert.save_tree_npz(str(d / "checkpoint7.npz"), tree)
        dirs[side] = d
    return dirs


def _run_both(root, dirs, suffix, issave=False, **kw):
    jcfg = make_cfg(root, dirs["jax"], JaxConfig, checkpoint="checkpoint7.npz",
                    batch_size=1, **kw)
    tcfg = make_cfg(root, dirs["port"], checkpoint="checkpoint7", **kw)
    want = jtrainer.main_test(jcfg, num_sample=0, suffix=suffix, issave=issave)
    got = trainer.main_test(tcfg, num_sample=0, suffix=suffix, issave=issave,
                            device="cpu")
    return got, want


@pytest.fixture(scope="module")
def feature_runs(split):
    """The SR-feature model (isaggre) carried as a JAX npz: the port's seeded
    model, BatchNorm statistics drawn, through the JAX package's
    reference-checkpoint converter; its RRDBNet the same way."""
    cfg = make_cfg(split, split / "unused")
    model, sr = trainer.build_models(cfg)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.normal_(0, 0.1, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 1.5, generator=gen)
        model.reg.conv_last.bias.fill_(4.0)  # heights above the clamp at 0
    tree = jconvert.convert_height_model(_np(model.state_dict()), True, ENC)
    tree["log_vars"] = {f"w{i + 1}": np.float32(0.1 * i) for i in range(3)}
    tree["meta"] = {"epoch": np.int32(7)}
    jconvert.save_tree_npz(cfg.logdirhr, jconvert.convert_rrdbnet(
        _np(sr.state_dict()), num_block=1))
    dirs = _carry(split, "feature", tree)
    return dirs, _run_both(split, dirs, "t", issave=True)


@pytest.fixture(scope="module")
def nosuper_runs(split, nosuper_vars):
    dirs = _carry(split, "nosuper", {**nosuper_vars, "meta": {"epoch": np.int32(7)},
                                     "log_vars": {"w1": np.float32(0.5),
                                                  "w2": np.float32(-0.5)}})
    return dirs, _run_both(split, dirs, "n", model_variant="nosuper", isaggre=False)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert (np.isnan(a) == np.isnan(b)).all()
    ok = np.isnan(b) | (np.abs(a - b) <= tol * (1 + np.abs(b)))
    assert ok.all(), np.abs(a - b)[~ok]


def _csv(path):
    return [line.split(",") for line in open(path).read().splitlines()]


def _check_acc_files(dirs, got, want, suffix):
    name = f"acc7{suffix}_0"
    for ext in (".txt", "_seg.csv", "_he.csv"):
        assert os.path.isfile(dirs["port"] / f"{name}{ext}"), ext
    assert os.path.basename(got["txtpath"]) == os.path.basename(want["txtpath"])
    _close(got["rmse"], want["rmse"])
    _close(float(open(dirs["port"] / f"{name}.txt").read()),
           float(open(dirs["jax"] / f"{name}.txt").read()))
    seg_t, seg_j = (_csv(dirs[s] / f"{name}_seg.csv") for s in ("port", "jax"))
    assert [len(r) for r in seg_t] == [len(r) for r in seg_j] == [NCLS + 1] * (6 + NCLS)
    assert [r[-1] for r in seg_t] == [r[-1] for r in seg_j]
    cm_t, cm_j = (np.array([r[:NCLS] for r in s[6:]], np.float64) for s in (seg_t, seg_j))
    pixels = TILES * 128 * 128
    assert cm_t.sum() == cm_j.sum() == pixels
    moved = np.abs(cm_t - cm_j).sum() / 2
    print(f"confusion counts moved: {moved:g} of {pixels} pixels")
    assert moved <= QUANT_SHARE * pixels
    he_t, he_j = (_csv(dirs[s] / f"{name}_he.csv") for s in ("port", "jax"))
    assert he_t[0] == he_j[0] == ["rmse", "mae", "me", "count"]
    assert len(he_t) == len(he_j) == NCLS + 3
    num = lambda rows: np.array([[float(v) if v else np.nan for v in r] for r in rows[1:]])
    _close(num(he_t), num(he_j))


def test_main_test_matches_jax(feature_runs):
    dirs, (got, want) = feature_runs
    _check_acc_files(dirs, got, want, "t")
    assert got["oa"] == pytest.approx(want["oa"], abs=QUANT_SHARE)


def test_main_test_saves_tiles_as_jax_does(feature_runs):
    dirs, _ = feature_runs
    pred_t, pred_j = (dirs[s] / "pred_7_t" for s in ("port", "jax"))
    names = sorted(os.listdir(pred_j))
    assert sorted(os.listdir(pred_t)) == names and len(names) == 2 * TILES
    for n in names:
        a, b = TiffReader(str(pred_t / n)), TiffReader(str(pred_j / n))
        assert (a.dtype, a.compression, a.geotransform) == (b.dtype, b.compression,
                                                            b.geotransform)
        assert (a.info().colormap is None) == (b.info().colormap is None)
        d = np.abs(a.read().astype(np.int64) - b.read().astype(np.int64))
        if n.endswith("_build.tif"):
            assert (d > 0).mean() <= QUANT_SHARE, n
        else:
            assert d.max() <= 1 and (d > 0).mean() <= QUANT_SHARE, n


def test_main_test_of_a_nosuper_checkpoint_matches_jax(nosuper_runs):
    dirs, (got, want) = nosuper_runs
    _check_acc_files(dirs, got, want, "n")


def test_main_test_without_batches_writes_empty_metrics(split, feature_runs):
    """``max_batches=0``: RMSE 0.0, and the files the JAX package's writers
    give empty metrics (NaN where 0/0)."""
    dirs, _ = feature_runs
    cfg = make_cfg(split, dirs["port"], checkpoint="checkpoint7")
    res = trainer.main_test(cfg, num_sample=0, suffix="e", max_batches=0,
                            device="cpu")
    assert res["rmse"] == 0.0 and np.isnan(res["oa"])
    ref = split / "empty_ref"
    os.makedirs(ref, exist_ok=True)
    jwriters.acc2file_seg(jstream.SegmentationMetric(NCLS), str(ref / "a_seg.txt"))
    jwriters.acc2file_height(jstream.HeightMetric(NCLS), str(ref / "a_he.txt"))
    for ext in ("_seg.csv", "_he.csv"):
        assert (dirs["port"] / f"acc7e_0{ext}").read_bytes() == \
            (ref / f"a{ext}").read_bytes()


def test_main_test_without_a_checkpoint_stops(split, tmp_path, capsys):
    cfg = make_cfg(split, tmp_path, checkpoint="checkpoint20")
    assert trainer.main_test(cfg, device="cpu") is None
    assert "no checkpoint at" in capsys.readouterr().out


# ------------------------------------------------------------ the sequence

def test_train_main_runs_the_train_py_sequence(monkeypatch):
    calls = []
    fields = ("maxepoch", "checkpoint", "testlist", "logdir")
    monkeypatch.setattr(trainer, "main", lambda cfg, device=None: calls.append(
        ("main", {f: getattr(cfg, f) for f in fields}, device)))

    def main_test(cfg, num_sample=100, suffix="", device=None):
        calls.append(("main_test", {f: getattr(cfg, f) for f in fields},
                      num_sample, suffix))
        return suffix

    monkeypatch.setattr(trainer, "main_test", main_test)
    out = train_cli.main(["--logdir", "/l"], device="cpu")
    assert out == ["", "china", "eu", "usa"]
    assert calls[0] == ("main", {"maxepoch": 20, "checkpoint": "checkpoint",
                                 "testlist": "datalist_globe_test_0.7_test_0.3.csv",
                                 "logdir": "/l"}, torch.device("cpu"))
    tests = [(c[1]["checkpoint"], c[1]["testlist"], c[2], c[3]) for c in calls[1:]]
    assert tests == [
        ("checkpoint20", "datalist_globe_test_0.7_test_0.3.csv", 100, ""),
        ("checkpoint20", "datalist_china_test_0.7_test_0.3.csv", 0, "china"),
        ("checkpoint20", "datalist_eu_test_0.7_test_0.3.csv", 0, "eu"),
        ("checkpoint20", "datalist_usa_test_0.7_test_0.3.csv", 0, "usa")]


def test_predict_cli_refuses_the_nosuper_variant():
    with pytest.raises(ValueError, match="nosuper"):
        predict_cli.main(["--model_variant", "nosuper"], device="cpu")
