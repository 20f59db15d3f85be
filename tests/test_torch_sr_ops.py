"""The port's USM and SR losses against the JAX package's.

* ``cv2_gaussian_kernel``: equal; ``usm_sharp`` at gt 32 and 64, three
  channels: within 1e-6 of ``srbh_tpu.ops.usm.usm_sharp``; below 26 pixels
  (51 taps: torch's reflect padding needs padding < side) a clear error.
* Every loss of ``losses/sr.py`` within 1e-6 relative of
  ``srbh_tpu.losses.sr``, the regularisers fed JAX's random draws (the
  interpolation weights, the path-length noise).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.losses import sr as jsr
from srbh_tpu.ops import usm as jusm
from srbh_tpu_torch.losses import sr as tsr
from srbh_tpu_torch.ops import usm as tusm
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rel=1e-6):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-6), (got, want)


@pytest.mark.parametrize("ksize,sigma", [(51, 0.0), (11, 1.5), (21, 3.0), (3, 0.0)])
def test_gaussian_kernel_equals_jax(ksize, sigma):
    np.testing.assert_array_equal(tusm.cv2_gaussian_kernel(ksize, sigma),
                                  jusm.cv2_gaussian_kernel(ksize, sigma))


@pytest.mark.parametrize("side", [32, 64])
def test_usm_sharp_matches_jax(side):
    rng = np.random.default_rng(side)
    img = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    img[0, :, : side // 2] *= 0.2  # an edge for the mask to find
    want = np.asarray(jusm.usm_sharp(jnp.asarray(img)))
    got = _nhwc(tusm.usm_sharp(_nchw(img)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    k = np.outer(*[jusm.cv2_gaussian_kernel(7, 1.2)] * 2)
    np.testing.assert_allclose(
        _nhwc(tusm.filter2d_reflect(_nchw(img), k)),
        np.asarray(jusm.filter2d_reflect(jnp.asarray(img), k)), atol=1e-6, rtol=0)


def test_usm_refuses_images_too_small_for_its_padding():
    with pytest.raises(ValueError, match="reflect padding of 25"):
        tusm.usm_sharp(torch.zeros(1, 3, 25, 40))


def _pair(rng, shape=(2, 16, 16, 3)):
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_pixel_and_feature_losses_match_jax():
    rng = np.random.default_rng(0)
    x, gt = _pair(rng)
    _close(tsr.l1_loss(_nchw(x), _nchw(gt)), jsr.l1_loss(jnp.asarray(x), jnp.asarray(gt)))
    _close(tsr.tv_loss(_nchw(x), 0.5), jsr.tv_loss(jnp.asarray(x), 0.5))
    _close(tsr.charbonnier_loss(_nchw(x), _nchw(gt)),
           jsr.charbonnier_loss(jnp.asarray(x), jnp.asarray(gt)))
    # at a zero residual the loss is sqrt(1e-9) = 3.16227766e-05: the port
    # gives 3.1622771e-05, XLA:CPU's float32 sqrt 3.1623036e-05 (8.4e-6 off)
    _close(tsr.charbonnier_loss(_nchw(x), _nchw(x)), np.sqrt(1e-9))
    _close(jsr.charbonnier_loss(jnp.asarray(x), jnp.asarray(x)), np.sqrt(1e-9),
           rel=1e-5)
    feats = [_pair(rng, (2, s, s, c)) for s, c in ((16, 4), (8, 8), (4, 8), (2, 16),
                                                   (1, 16))]
    for lossfn in ("l1", "l2"):
        _close(tsr.perceptual_loss([_nchw(a) for a, _ in feats],
                                   [_nchw(b) for _, b in feats], lossfn=lossfn,
                                   loss_weight=0.7),
               jsr.perceptual_loss([jnp.asarray(a) for a, _ in feats],
                                   [jnp.asarray(b) for _, b in feats],
                                   lossfn=lossfn, loss_weight=0.7))
    a = _nchw(feats[0][0]).requires_grad_(True)
    b = _nchw(feats[0][1]).requires_grad_(True)
    tsr.perceptual_loss([a], [b], weights=(1.0,)).backward()
    assert a.grad is not None and b.grad is None  # the gt side is detached


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus",
                                      "hinge"])
def test_gan_loss_matches_jax(gan_type):
    pred = np.random.default_rng(1).normal(size=(2, 1, 8, 8)).astype(np.float32)
    for real in (True, False):
        for disc in (True, False):
            _close(tsr.gan_loss(torch.from_numpy(pred), real, gan_type, disc,
                                loss_weight=0.1),
                   jsr.gan_loss(jnp.asarray(pred), real, gan_type, disc,
                                loss_weight=0.1))
    with pytest.raises(NotImplementedError):
        tsr.gan_loss(torch.from_numpy(pred), True, "nope")


# a small discriminator and generator, the same function in both frameworks
W_D = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
W_G = np.random.default_rng(3).normal(size=(6, 48)).astype(np.float32)


def _disc_jax(x):  # NHWC
    return jnp.tanh(x @ jnp.asarray(W_D)) ** 2


def _disc_torch(x):  # NCHW
    return torch.tanh(torch.einsum("nchw,ck->nkhw", x, torch.from_numpy(W_D))) ** 2


def _fake_jax(z):  # (B, L, 6) -> (B, 4, 4, 3)
    return jnp.tanh(z @ jnp.asarray(W_G)).mean(1).reshape(z.shape[0], 4, 4, 3)


def _fake_torch(z):  # (B, L, 6) -> (B, 3, 4, 4)
    img = torch.tanh(z @ torch.from_numpy(W_G)).mean(1).reshape(z.shape[0], 4, 4, 3)
    return img.permute(0, 3, 1, 2)


def test_r1_and_gradient_penalty_match_jax():
    rng = np.random.default_rng(4)
    real, fake = _pair(rng, (3, 8, 8, 3))
    _close(tsr.r1_penalty(_disc_torch, _nchw(real)),
           jsr.r1_penalty(_disc_jax, jnp.asarray(real)))
    key = jax.random.PRNGKey(5)
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (3, 1, 1, 1))))
    weight = rng.uniform(0.5, 2.0, (3, 8, 8, 1)).astype(np.float32)
    for w in (None, weight):
        want = jsr.gradient_penalty_loss(_disc_jax, jnp.asarray(real),
                                         jnp.asarray(fake), key,
                                         None if w is None else jnp.asarray(w))
        got = tsr.gradient_penalty_loss(_disc_torch, _nchw(real), _nchw(fake),
                                        None if w is None else _nchw(w), alpha=alpha)
        _close(got, want)
    # the penalty keeps its graph: it trains what it differentiates
    f = _nchw(fake).requires_grad_(True)
    tsr.gradient_penalty_loss(_disc_torch, _nchw(real), f, alpha=alpha).backward()
    assert f.grad is not None and torch.isfinite(f.grad).all()


@pytest.mark.parametrize("layers", [None, 3])
def test_path_length_regularizer_matches_jax(layers):
    rng = np.random.default_rng(6)
    shape = (4, 6) if layers is None else (4, layers, 6)
    z = rng.normal(size=shape).astype(np.float32)
    fake_j = (lambda v: _fake_jax(v[:, None])) if layers is None else _fake_jax
    fake_t = (lambda v: _fake_torch(v[:, None])) if layers is None else _fake_torch
    key = jax.random.PRNGKey(7)
    want = jsr.g_path_regularize(fake_j, jnp.asarray(z), jnp.float32(0.3), key=key)
    # JAX's per-example noise, drawn as its regulariser draws it
    noise = np.stack([np.asarray(jax.random.normal(k, (1, 4, 4, 3)))[0]
                      for k in jax.random.split(key, 4)])
    got = tsr.g_path_regularize(fake_t, torch.from_numpy(z), 0.3,
                                noise=_nchw(noise))
    for g, w in zip(got, want):
        _close(g, w)
    drawn = tsr.g_path_regularize(fake_t, torch.from_numpy(z), 0.3,
                                  generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(torch.as_tensor(v)) for v in drawn)
