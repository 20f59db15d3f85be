"""The port's host utilities against the JAX package's: CAMs and the CRF
(``utils/cam.py``), segmentation scores (``eval_seg.py``), ramps
(``ramps.py``), and the profiler helpers (``utils/profiler.py``).

* The rebuilt OpenCV calls against OpenCV itself, on float32 images in
  [0, 1]: ``resize_linear`` against ``cv2.resize`` (INTER_LINEAR; down, up,
  exact halves, odd sizes, 1 and 3 channels) and ``gaussian_blur`` against
  ``cv2.GaussianBlur(BORDER_CONSTANT)``: within 1e-5 absolute.
* ``crf_refine`` (Gaussian and bilateral), the multi-scale CAM drivers,
  ``make_cam``, ``cam_to_label`` and ``compute_seg_label`` against the JAX
  package's (which call OpenCV) on the same seeded inputs and the same
  numpy ``cam_fn``: within 1e-5 absolute, labels equal.
* ``scores`` and the ramps: equal.
* ``StepTimer``, ``trace`` and ``annotate``: a rate, a trace file, and the
  card by default.
"""
import cv2
import numpy as np
import pytest
import torch

from srbh_tpu.utils import cam as jcam
from srbh_tpu.utils import eval_seg as jeval
from srbh_tpu.utils import ramps as jramps
from srbh_tpu_torch.utils import cam, eval_seg, profiler, ramps
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


@pytest.mark.parametrize("shape,size", [
    ((32, 32, 3), (16, 16)), ((32, 32, 3), (48, 48)), ((37, 29, 3), (23, 41)),
    ((16, 20, 1), (40, 30)), ((16, 20), (8, 10)), ((20, 20, 5), (30, 10))])
def test_resize_linear_is_cv2(shape, size):
    im = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    h, w = size
    want = cv2.resize(im, (w, h))
    got = cam.resize_linear(im, h, w)
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ksize,sigma", [(19, 3.0), (7, 1.0)])
def test_gaussian_blur_is_cv2(ksize, sigma):
    a = np.random.default_rng(1).uniform(0, 1, (40, 30)).astype(np.float32)
    want = cv2.GaussianBlur(a, (ksize, ksize), sigma, borderType=cv2.BORDER_CONSTANT)
    np.testing.assert_allclose(cam.gaussian_blur(a, ksize, sigma), want,
                               atol=ATOL, rtol=0)


def _prob_image(seed=2, h=24, w=20, k=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (h, w, k))
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return prob.astype(np.float32), image


@pytest.mark.parametrize("bilateral", [None, (5.0, 13.0, 4.0)])
def test_crf_refine_matches_jax(bilateral):
    prob, image = _prob_image()
    want = jcam.crf_refine(prob, image, bilateral=bilateral, radius=4)
    got = cam.crf_refine(prob, image, bilateral=bilateral, radius=4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


_W = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)


def _cam_fn(x):
    """(N, H, W, 3) -> (N, H/2, W/2, 4) raw maps."""
    return np.tanh(x[:, ::2, ::2, :].astype(np.float32) @ _W)


def _stages(x):
    return [_cam_fn(x), _cam_fn(x) ** 2]


@pytest.mark.parametrize("name", ["multi_scale_cam", "multi_scale_puzzle",
                                  "multi_scale_seam", "multi_scale_cam_multistage",
                                  "multi_scale_cam_multistage_v2"])
def test_multi_scale_cams_match_jax(name):
    image = np.random.default_rng(4).uniform(0, 1, (2, 32, 28, 3)).astype(np.float32)
    fn = {"multi_scale_seam": lambda x: (_cam_fn(x), -_cam_fn(x)),
          "multi_scale_cam_multistage": _stages,
          "multi_scale_cam_multistage_v2": _stages}.get(name, _cam_fn)
    want = getattr(jcam, name)(fn, image)
    got = getattr(cam, name)(fn, image)
    assert got.shape == want.shape == (2, 32, 28, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_labels_match_jax():
    rng = np.random.default_rng(5)
    cams = rng.uniform(0, 1, (2, 16, 16, 4)).astype(np.float32)
    np.testing.assert_array_equal(cam.make_cam(cams - 0.3), jcam.make_cam(cams - 0.3))
    np.testing.assert_array_equal(cam.cam_to_label(cams), jcam.cam_to_label(cams))
    prob, image = _prob_image(6, 24, 20, 3)
    norm_cam = prob.transpose(2, 0, 1)
    cam_label = np.array([1.0, 0.0, 1.0])
    np.testing.assert_array_equal(
        cam.compute_seg_label(image, cam_label, norm_cam, num_classes=4),
        jcam.compute_seg_label(image, cam_label, norm_cam, num_classes=4))


def test_scores_and_ramps_match_jax():
    rng = np.random.default_rng(7)
    trues = [rng.integers(0, 5, (8, 8)) for _ in range(3)]
    preds = [rng.integers(0, 5, (8, 8)) for _ in range(3)]
    got, want = eval_seg.scores(trues, preds, 5), jeval.scores(trues, preds, 5)
    assert got.keys() == want.keys()
    for k in ("Pixel Accuracy", "Mean Accuracy", "Mean IoU"):
        np.testing.assert_equal(got[k], want[k])
    np.testing.assert_equal(got["Class IoU"], want["Class IoU"])
    absent = eval_seg.scores(trues, preds, 6)  # class 5 occurs nowhere
    assert np.isnan(absent["Class IoU"][5])
    assert absent["Mean IoU"] == got["Mean IoU"]
    for cur in (0, 2.5, 10, 12):
        assert ramps.sigmoid_rampup(cur, 10) == jramps.sigmoid_rampup(cur, 10)
        assert ramps.linear_rampup(cur, 10) == jramps.linear_rampup(cur, 10)
    assert ramps.sigmoid_rampup(3, 0) == jramps.sigmoid_rampup(3, 0) == 1.0
    for cur in (0, 3, 10):
        assert ramps.cosine_rampdown(cur, 10) == pytest.approx(
            jramps.cosine_rampdown(cur, 10), abs=1e-15)


def test_profiler_helpers(tmp_path, monkeypatch):
    timer = profiler.StepTimer(8, device="cpu")
    with profiler.trace(str(tmp_path)):
        for _ in range(2):
            with timer.step(), profiler.annotate("matmul"):
                torch.ones(16, 16) @ torch.ones(16, 16)
    assert timer.steps == 2 and timer.rate > 0
    assert list(tmp_path.glob("*.json"))
    with pytest.raises(RuntimeError, match="before start"):
        profiler.StepTimer(1, device="cpu").stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiler.StepTimer(1)
