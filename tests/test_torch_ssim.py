"""The port's SSIM ops, SSIM losses and ``_pt`` metrics against the JAX
package's.

The same seeded images (JAX NHWC, the port NCHW) go through
``srbh_tpu/ops/ssim.py``, ``losses/ssim_loss.py`` and the ``_pt`` metrics
of ``metrics/image.py`` and through the port's twins:

* the Gaussian window: equal to 1e-15;
* SSIM maps, per-image SSIM / PSNR, the Y channel and the ``_pt`` metrics:
  within 1e-4 relative (the port filters in two 1-D passes, the JAX package
  with one 11x11 window);
* loss values: within 1e-5 relative; their input gradients within 1e-4 of
  the largest. LOGSSIM and MS-SSIM run in float64 on both sides: their
  float32 values carry ~1e-5 of rounding (``E[x^2] - mu^2`` on the 255
  scale, a loss of ``1 - 0.958``). Against the float64 value the JAX
  package's float32 MS-SSIM loss was 2.5e-4 relative off, the port's
  1.1e-5; the float32 LOGSSIM 1.5e-5 and 1.1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.losses import ssim_loss as jloss
from srbh_tpu.metrics import image as jimage
from srbh_tpu.ops import ssim as jssim
from srbh_tpu_torch.losses import ssim_loss
from srbh_tpu_torch.metrics import image
from srbh_tpu_torch.ops import ssim
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL, VALUE_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4


def _pair(shape, scale=1.0, seed=0):
    """An image and a noisy copy, both NHWC in [0, scale]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a * scale, b * scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_gaussian_window_matches_jax():
    for k, s in ((11, 1.5), (7, 1.0), (19, 3.0)):
        np.testing.assert_allclose(ssim.gaussian_kernel_1d(k, s),
                                   jssim.gaussian_kernel_1d(k, s), atol=1e-15)


def test_device_ssim_psnr_and_y_match_jax():
    a, b = _pair((2, 24, 24, 3), 255.0)
    _rel(np.moveaxis(ssim.ssim_map(_t(a), _t(b)).numpy(), 1, -1),
         jssim.ssim_map(jnp.asarray(a), jnp.asarray(b)), TOL)
    _rel(ssim.ssim(_t(a), _t(b)).numpy(), jssim.ssim(a, b), TOL)
    _rel(ssim.psnr(_t(a), _t(b)).numpy(), jssim.psnr(a, b), TOL)
    _rel(np.moveaxis(ssim.rgb_to_y(_t(a / 255.0)).numpy(), 1, -1),
         jssim.rgb_to_y(jnp.asarray(a / 255.0)), TOL)


@pytest.mark.parametrize("crop,y", [(0, False), (4, False), (0, True), (2, True)])
def test_pt_metrics_match_jax(crop, y):
    a, b = _pair((3, 32, 32, 3), seed=1)
    kw = dict(crop_border=crop, test_y_channel=y)
    for name in ("calculate_psnr_pt", "calculate_ssim_pt", "calculate_cpsnr_pt"):
        got = getattr(image, name)(_t(a), _t(b), **kw).numpy()
        want = getattr(jimage, name)(jnp.asarray(a), jnp.asarray(b), **kw)
        _rel(got, want, TOL)


def _losses():
    small, big = _pair((2, 24, 24, 1), seed=2), _pair((1, 176, 176, 1), 255.0, 3)
    return {
        "ssim_loss": (small, lambda x, y: jloss.ssim_loss(x, y, 1.0),
                      lambda x, y: ssim_loss.ssim_loss(x, y, 1.0)),
        "ssim_loss_nonnegative": (
            small, lambda x, y: jloss.ssim_loss(x, y, 1.0, nonnegative=True),
            lambda x, y: ssim_loss.ssim_loss(x, y, 1.0, nonnegative=True)),
        "ssim_same": (small, jloss.ssim_same, ssim_loss.ssim_same),
        "log_ssim_loss": (small, jloss.log_ssim_loss, ssim_loss.log_ssim_loss),
        "ms_ssim_loss": (big, jloss.ms_ssim_loss, ssim_loss.ms_ssim_loss),
    }


@pytest.mark.parametrize("name,dtype", [
    ("ssim_loss", np.float32), ("ssim_loss_nonnegative", np.float32),
    ("ssim_same", np.float32), ("log_ssim_loss", np.float64),
    ("ms_ssim_loss", np.float64)])
def test_ssim_losses_and_gradients_match_jax(name, dtype):
    (a, b), jfn, tfn = _losses()[name]
    a, b = a.astype(dtype), b.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want, want_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(a),
                                                        jnp.asarray(b))
    x = _t(a).requires_grad_(True)
    got = tfn(x, _t(b))
    got.backward()
    want = float(want)
    assert abs(float(got.detach()) - want) <= VALUE_TOL * abs(want)
    _rel(np.moveaxis(x.grad.numpy(), 1, -1), want_g, GRAD_TOL)


def test_per_image_ssim_and_ms_ssim_match_jax():
    a, b = _pair((2, 176, 176, 3), 255.0, seed=4)
    _rel(ssim_loss.ssim(_t(a), _t(b)).numpy(), jloss.ssim(a, b), TOL)
    _rel(ssim_loss.ms_ssim(_t(a), _t(b)).numpy(), jloss.ms_ssim(a, b), TOL)
