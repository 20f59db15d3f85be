"""The single-sensor datasets, the colour jitter and the tools' --test-scale
against the JAX package.

* ``S2GlobeDataset`` / ``S1GlobeDataset`` samples equal the JAX datasets'
  bit for bit on the same tiles (as ``tests/test_torch_data.py`` holds
  ``S12GlobeDataset``), with augmentation whenever the rotation branch does
  not fire; the S1 dataset raises on a missing S1 table after the optional
  augmentation, as the JAX one does, and both refuse ``device_norm``.
* ``color_jitter`` equals the JAX one (cv2's float32 HSV) within 1e-5
  given the same ``Generator`` state, which both leave in the same state;
  ``rgb_to_hsv`` / ``hsv_to_rgb`` follow cv2; the four cases of
  ``tests/test_review8_fixes.py::TestColorJitter`` hold on the port.
* ``--test-scale`` reaches ``run(tiny=True)`` in ``composed_bench`` and
  ``predict_stress``.
"""
import cv2
import numpy as np
import pytest
import torch

from srbh_tpu.data import augment as jaug
from srbh_tpu.data.dataset import S1GlobeDataset as JaxS1
from srbh_tpu.data.dataset import S2GlobeDataset as JaxS2
from srbh_tpu_torch import data as tdata
from srbh_tpu_torch.data import augment as taug
from srbh_tpu_torch.tools import composed_bench, predict_stress, timing
from test_torch_data import _assert_same_sample, _rotates, tiles  # noqa: F401
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

PAIRS = {"s2": (tdata.S2GlobeDataset, JaxS2), "s1": (tdata.S1GlobeDataset, JaxS1)}


def _datasets(root, kind, datastats=None, **kw):
    args = dict(datastats=str(datastats or root), s1dir="s1c", s2dir="s2c",
                heightdir="bhc", preweight=str(root / "bh_stats.txt"), seed=5,
                **kw)
    ours, theirs = PAIRS[kind]
    return (ours(str(root / "list.csv"), str(root), **args),
            theirs(str(root / "list.csv"), str(root), **args))


@pytest.mark.parametrize("kind", sorted(PAIRS))
@pytest.mark.parametrize("isaggre,ishir", [(True, True), (False, False)])
def test_single_sensor_samples_equal_jax(tiles, kind, isaggre, ishir):
    ours, theirs = _datasets(tiles, kind, isaggre=isaggre, ishir=ishir)
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        _assert_same_sample(a, b)
    assert a["image"].shape[-1] == {"s2": 6, "s1": 2}[kind]


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_single_sensor_augmented_samples_equal_jax(tiles, kind):
    ours, theirs = _datasets(tiles, kind, aug=True, isaggre=True, ishir=True)
    compared = 0
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            if not _rotates(ours._sample_rng(i)):
                _assert_same_sample(a, b)
                compared += 1
    assert compared >= 3


def test_s2_takes_the_first_nchans_bands(tiles):
    ours, theirs = _datasets(tiles, "s2", nchans=3)
    _assert_same_sample(ours[0], theirs[0])
    assert ours[0]["image"].shape == (16, 16, 3)


@pytest.mark.parametrize("aug", [False, True])
def test_s1_raises_without_its_table_as_jax(tiles, tmp_path, aug):
    """After the optional augmentation: both datasets draw the same
    augmentation, then raise."""
    ours, theirs = _datasets(tiles, "s1", datastats=tmp_path, aug=aug)
    assert ours.nchans == theirs.nchans == 0
    for ds in (ours, theirs):
        with pytest.raises(FileNotFoundError, match="S1 stats"):
            ds[0]


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_single_sensor_refuses_device_norm(tiles, kind):
    """S2: at the first sample; S1 (no S2 band, so no S2 table): at
    construction, as ``device_norm`` needs both tables."""
    kw = dict(device_aug=True, device_norm=True)
    if kind == "s1":
        for cls in PAIRS["s1"]:
            with pytest.raises(FileNotFoundError, match="both stats tables"):
                cls(str(tiles / "list.csv"), str(tiles), datastats=str(tiles),
                    s1dir="s1c", s2dir="s2c", heightdir="bhc", **kw)
        return
    for ds in _datasets(tiles, kind, **kw):
        with pytest.raises(NotImplementedError, match="S12 main path"):
            ds[0]


def test_hsv_follows_cv2():
    rng = np.random.default_rng(2)
    img = rng.random((32, 24, 3)).astype(np.float32)
    img[0, :4] = [[0.5, 0.5, 0.5], [0.2, 0.2, 0.7], [0, 0, 0], [1, 1, 0]]
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = taug.rgb_to_hsv(img)
    # H in degrees of [0, 360): a few float32 ulps of 360
    np.testing.assert_allclose(got[..., 0], hsv[..., 0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[..., 1:], hsv[..., 1:], atol=1e-6, rtol=0)
    hsv[..., 0] = (hsv[..., 0] + 123.4) % 360.0
    np.testing.assert_allclose(taug.hsv_to_rgb(hsv),
                               cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(16))
def test_color_jitter_equals_jax(seed):
    img = np.random.default_rng(seed + 40).random((24, 20, 3)).astype(np.float32)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    got = taug.color_jitter(ra, img)
    want = jaug.color_jitter(rb, img)
    assert ra.bit_generator.state == rb.bit_generator.state
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _ScriptedRng:
    """A ``Generator`` stand-in with scripted draws (the JAX test's)."""

    def __init__(self, uniforms, perm):
        self._uniforms = list(uniforms)
        self._perm = np.asarray(perm)

    def random(self):
        return 0.0  # always apply

    def uniform(self, lo, hi):
        return self._uniforms.pop(0)

    def permutation(self, n):
        return self._perm


def _img():
    return np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)


def test_saturation_zero_gives_luma_gray():
    img = _img()
    out = taug.color_jitter(_ScriptedRng([1.0, 1.0, 0.0, 0.0], [2, 0, 1, 3]),
                            img, hue=0.0)
    gray = img @ taug._LUMA
    for c in range(3):
        np.testing.assert_allclose(out[..., c], gray, atol=1e-5)


def test_contrast_zero_gives_scalar_luma_mean():
    img = _img()
    out = taug.color_jitter(_ScriptedRng([1.0, 0.0, 1.0, 0.0], [1, 0, 2, 3]),
                            img, contrast=1.0, hue=0.0)
    np.testing.assert_allclose(out, float((img @ taug._LUMA).mean()),
                               atol=1e-5)


def test_op_order_matters():
    img = _img()
    draws = [1.8, 0.3, 1.0, 0.0]  # strong brightness + contrast
    a = taug.color_jitter(_ScriptedRng(list(draws), [0, 1, 2, 3]), img,
                          brightness=1.0, contrast=1.0, hue=0.0)
    b = taug.color_jitter(_ScriptedRng(list(draws), [1, 0, 2, 3]), img,
                          brightness=1.0, contrast=1.0, hue=0.0)
    assert not np.allclose(a, b)


def test_factor_range_clamps_at_zero():
    seen = []

    class Probe(_ScriptedRng):
        def uniform(self, lo, hi):
            seen.append((lo, hi))
            return 1.0

    taug.color_jitter(Probe([], [0, 1, 2, 3]), _img(), brightness=2.0,
                      contrast=0.5, saturation=0.5, hue=0.25)
    assert seen[0] == (0.0, 3.0)
    assert seen[1] == (0.5, 1.5)
    assert seen[3] == (-0.25, 0.25)


@pytest.mark.parametrize("tool", [composed_bench, predict_stress])
@pytest.mark.parametrize("flag", [[], ["--test-scale"]])
def test_test_scale_reaches_run(tool, flag, monkeypatch, tmp_path):
    seen = {}

    def run(*args, **kw):
        seen.update(kw)
        return []

    monkeypatch.setattr(tool, "run", run)
    monkeypatch.setattr(timing, "tool_device", lambda: torch.device("cpu"))
    tool.main(flag + ["--out", str(tmp_path / "out.jsonl")])
    assert seen["tiny"] is bool(flag)
