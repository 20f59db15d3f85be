"""The port's segmentation losses against the JAX package's.

Every loss of ``srbh_tpu/losses/segmentation.py`` runs on the same seeded
inputs in both frameworks: continuous random logits (so that Lovasz's sort
and top-k see no ties), random labels, and the host distance maps built by
each side's own ``edts_penalized_map`` / ``one_hot_distance_transform``.
The JAX side takes channel-last logits, the port's NCHW.

* loss values: within 1e-5 relative;
* the input gradient (``jax.grad`` against ``autograd``): within 1e-4 of
  its largest magnitude;
* the host distance maps: equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.losses import segmentation as jseg
from srbh_tpu_torch.losses import segmentation as seg
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
N, H, W, C = 2, 16, 16, 3


def _inputs(seed=0, c=C):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.5, (N, H, W, c)).astype(np.float32)
    labels = rng.integers(0, c, (N, H, W)).astype(np.int32)
    return logits, labels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _multiclass(jfn, tfn, seed=0, c=C):
    """Logits (N, H, W, C) / (N, C, H, W) and labels (N, H, W)."""
    logits, labels = _inputs(seed, c)
    return (logits, lambda x: jfn(x, jnp.asarray(labels)),
            lambda x: tfn(x, _t(labels)))


def _binary(jfn, tfn, seed=0):
    """Logits and a 0/1 target, both (N, H, W, 1) / (N, 1, H, W)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.5, (N, H, W, 1)).astype(np.float32)
    target = rng.integers(0, 2, (N, H, W, 1)).astype(np.float32)
    return (logits, lambda x: jfn(x, jnp.asarray(target)),
            lambda x: tfn(x, _t(_nchw(target))))


def _dist_dice():
    logits, labels = _inputs(1, 2)
    dist = jseg.edts_penalized_map(labels > 0) + 1.0
    tdist = seg.edts_penalized_map(labels > 0) + 1.0
    return (logits, lambda x: jseg.dist_binary_dice_loss(x, jnp.asarray(labels), dist),
            lambda x: seg.dist_binary_dice_loss(x, _t(labels), _t(tdist)))


def _boundary(kind):
    logits, labels = _inputs(2)
    jd = jseg.one_hot_distance_transform(labels, C)
    td = seg.one_hot_distance_transform(labels, C)
    if kind == "bd":
        return (logits, lambda x: jseg.boundary_loss(x, jnp.asarray(jd)),
                lambda x: seg.boundary_loss(x, _t(td)))
    return (logits, lambda x: jseg.dc_and_bd_loss(x, jnp.asarray(labels), jnp.asarray(jd)),
            lambda x: seg.dc_and_bd_loss(x, _t(labels), _t(td)))


def _hausdorff_dt():
    logits, labels = _inputs(3, 2)
    rng = np.random.default_rng(3)
    dp, dg = (rng.uniform(0, 4, (N, H, W)).astype(np.float32) for _ in range(2))
    return (logits, lambda x: jseg.hausdorff_dt_loss(x, jnp.asarray(labels), dp, dg),
            lambda x: seg.hausdorff_dt_loss(x, _t(labels), _t(dp), _t(dg)))


def _nll():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1.5, (64, C)).astype(np.float32)
    labels = rng.integers(0, C, (64,)).astype(np.int32)
    return (logits,
            lambda x: jseg.nll_loss(jax.nn.log_softmax(x, -1), jnp.asarray(labels)),
            lambda x: seg.nll_loss(torch.log_softmax(x, 1), _t(labels)))


def _boundary_maps():
    """A predicted boundary map in [0, 1] and a target raster in 0..255."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(0, 1, (N, H, W, 1)).astype(np.float32)
    target = rng.integers(0, 256, (N, H, W, 1)).astype(np.float32)
    return pred, target


def _ce_mse():
    logits, labels = _inputs(5)
    pred, target = _boundary_maps()
    return (logits,
            lambda x: jseg.ce_mse_loss(x, jnp.asarray(labels), pred, target),
            lambda x: seg.ce_mse_loss(x, _t(labels), _t(_nchw(pred)), _t(_nchw(target))))


def _bce_ssim_iou_bd():
    pred, target = _boundary_maps()
    return _binary(
        lambda x, t: jseg.bce_ssim_iou_bd_loss(x, t, pred, target),
        lambda x, t: seg.bce_ssim_iou_bd_loss(x, t, _t(_nchw(pred)), _t(_nchw(target))),
        seed=6)


def _lovasz():
    return _multiclass(lambda x, y: jseg.lovasz_softmax(jax.nn.softmax(x, -1), y),
                       lambda x, y: seg.lovasz_softmax(torch.softmax(x, 1), y))


CASES = {
    "soft_dice": lambda: _multiclass(jseg.soft_dice_loss, seg.soft_dice_loss),
    "soft_dice_batch_nobg": lambda: _multiclass(
        lambda x, y: jseg.soft_dice_loss(x, y, batch_dice=True, do_bg=False),
        lambda x, y: seg.soft_dice_loss(x, y, batch_dice=True, do_bg=False)),
    "soft_dice_nobg": lambda: _multiclass(
        lambda x, y: jseg.soft_dice_loss(x, y, do_bg=False),
        lambda x, y: seg.soft_dice_loss(x, y, do_bg=False)),
    "iou": lambda: _multiclass(jseg.iou_loss, seg.iou_loss),
    "iou_batch": lambda: _multiclass(
        lambda x, y: jseg.iou_loss(x, y, batch_dice=True, do_bg=False),
        lambda x, y: seg.iou_loss(x, y, batch_dice=True, do_bg=False)),
    "tversky": lambda: _multiclass(jseg.tversky_loss, seg.tversky_loss),
    "focal_tversky": lambda: _multiclass(jseg.focal_tversky_loss,
                                         seg.focal_tversky_loss),
    "asym": lambda: _multiclass(jseg.asym_loss, seg.asym_loss),
    "ss": lambda: _multiclass(jseg.ss_loss, seg.ss_loss),
    "ss_batch": lambda: _multiclass(
        lambda x, y: jseg.ss_loss(x, y, batch_dice=True),
        lambda x, y: seg.ss_loss(x, y, batch_dice=True)),
    "gdice": lambda: _multiclass(jseg.gdice_loss, seg.gdice_loss),
    "gdice_v2": lambda: _multiclass(jseg.gdice_loss_v2, seg.gdice_loss_v2),
    "penalty_gdice": lambda: _multiclass(jseg.penalty_gdice_loss,
                                         seg.penalty_gdice_loss),
    "dist_binary_dice": _dist_dice,
    "focal": lambda: _multiclass(jseg.focal_loss, seg.focal_loss),
    "focal_alpha_list": lambda: _multiclass(
        lambda x, y: jseg.focal_loss(x, y, alpha=[1.0, 2.0, 3.0]),
        lambda x, y: seg.focal_loss(x, y, alpha=[1.0, 2.0, 3.0])),
    "focal_alpha_float": lambda: _multiclass(
        lambda x, y: jseg.focal_loss(x, y, alpha=0.25, balance_index=1),
        lambda x, y: seg.focal_loss(x, y, alpha=0.25, balance_index=1)),
    "lovasz_softmax": _lovasz,
    "topk_ce": lambda: _multiclass(jseg.topk_ce_loss, seg.topk_ce_loss),
    "weighted_ce": lambda: _multiclass(jseg.weighted_ce_loss, seg.weighted_ce_loss),
    "weighted_ce_w": lambda: _multiclass(
        lambda x, y: jseg.weighted_ce_loss(x, y, weight=[0.2, 1.0, 3.0]),
        lambda x, y: seg.weighted_ce_loss(x, y, weight=[0.2, 1.0, 3.0])),
    "dist_penalized_ce": lambda: _multiclass(
        lambda x, y: jseg.dist_penalized_ce(x, y, None),
        lambda x, y: seg.dist_penalized_ce(x, y, None)),
    "nll": _nll,
    "boundary": lambda: _boundary("bd"),
    "hausdorff_dt": _hausdorff_dt,
    "hausdorff_er": lambda: _multiclass(jseg.hausdorff_er_loss,
                                        seg.hausdorff_er_loss, 7, 2),
    "dc_and_ce": lambda: _multiclass(jseg.dc_and_ce_loss, seg.dc_and_ce_loss),
    "dc_and_topk": lambda: _multiclass(jseg.dc_and_topk_loss, seg.dc_and_topk_loss),
    "dc_and_bd": lambda: _boundary("dc"),
    "explog": lambda: _multiclass(jseg.explog_loss, seg.explog_loss),
    "ce_mse": _ce_mse,
    "ce_dice_iou": lambda: _multiclass(jseg.ce_dice_iou_loss, seg.ce_dice_iou_loss,
                                       8, 2),
    "bce_ssim_iou": lambda: _binary(jseg.bce_ssim_iou_loss, seg.bce_ssim_iou_loss),
    "bce_iou": lambda: _binary(jseg.bce_iou_loss, seg.bce_iou_loss),
    "bce_ssim": lambda: _binary(jseg.bce_ssim_loss, seg.bce_ssim_loss),
    "bce_dice": lambda: _binary(jseg.bce_dice_loss, seg.bce_dice_loss),
    "bce_ssim_iou_bd": _bce_ssim_iou_bd,
}


def _port_layout(x):
    return _nchw(x) if x.ndim == 4 else x


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_input_gradient_match_jax(name):
    x, jfn, tfn = CASES[name]()
    want, want_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(x))
    xt = _t(_port_layout(x)).requires_grad_(True)
    got = tfn(xt)
    got.backward()
    want, want_g, got_v = float(want), np.asarray(want_g), float(got.detach())
    assert abs(got_v - want) <= VALUE_TOL * max(abs(want), 1e-12), (got_v, want)
    got_g = xt.grad.numpy()
    if x.ndim == 4:
        got_g = np.moveaxis(got_g, 1, -1)
    scale = float(np.abs(want_g).max())
    assert scale > 0
    assert np.abs(got_g - want_g).max() <= GRAD_TOL * scale


def test_host_distance_maps_match_jax():
    _, labels = _inputs(9)
    np.testing.assert_array_equal(seg.edts_penalized_map(labels > 0),
                                  jseg.edts_penalized_map(labels > 0))
    for signed in (True, False):
        np.testing.assert_array_equal(
            seg.one_hot_distance_transform(labels, C, signed),
            np.moveaxis(jseg.one_hot_distance_transform(labels, C, signed), -1, 1))
