"""The port's adaptive losses against the JAX package's.

Every function of ``srbh_tpu_torch/losses/adaptive.py`` on the same inputs
(numpy, seeded; NHWC logits for JAX, NCHW for the port) as its JAX twin in
``srbh_tpu/losses/adaptive.py``, labels out of range included. Values agree
within 1e-6 relative (float32 sums taken in another order); the gradients
with respect to the prediction or logits and to ``log_var`` agree with
``jax.grad`` within 1e-5 (relative to the largest gradient element).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.losses import adaptive as J
from srbh_tpu.ops.hierarchy import build_hierarchy_lut
from srbh_tpu_torch.losses import adaptive as T
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


N, C, H, W = 2, 7, 8, 8
VAL_RTOL = 1e-6
GRAD_TOL = 1e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        pred=rng.normal(0, 4, (N, H, W)).astype(np.float32),
        target=np.abs(rng.normal(0, 6, (N, H, W))).astype(np.float32),
        weight=rng.uniform(0.5, 2.0, (N, H, W)).astype(np.float32),
        logits=rng.normal(0, 2, (N, H, W, C)).astype(np.float32),
        # -2 and C + 3 are out of range: both sides clamp them
        labels=rng.integers(-2, C + 3, (N, H, W)).astype(np.int32),
        prob=rng.uniform(0, 1, (N, H, W)).astype(np.float32),
        mask=rng.integers(0, 2, (N, H, W)).astype(np.int32),
        log_var=np.float32(rng.normal(0, 0.5)),
        heightweight=rng.uniform(0.5, 3.0, 7).astype(np.float32),
    )


def _nchw(logits):
    return np.ascontiguousarray(logits.transpose(0, 3, 1, 2))


# name -> (key of the differentiated input, call): the call takes the losses
# module (JAX's or the port's), that input x (NHWC logits for JAX, NCHW for
# the port), log_var and the inputs
LUT = build_hierarchy_lut()
CASES = {
    "mse_adapt": ("pred", lambda f, x, lv, d: f.mse_adapt(x, d["target"], lv)),
    "mse_adapt_weight": ("pred", lambda f, x, lv, d: f.mse_adapt_weight(
        x, d["target"], d["weight"], lv)),
    "mse_adapt_weight_hir": ("pred", lambda f, x, lv, d: f.mse_adapt_weight_hir(
        x, d["target"], lv, d["lut"], d["heightweight"])),
    "weighted_mse": ("pred", lambda f, x, lv, d: f.weighted_mse(
        x, d["target"], d["weight"])),
    "smooth_l1": ("pred", lambda f, x, lv, d: f.smooth_l1(x, d["prob"])),
    "dice_binary": ("prob", lambda f, x, lv, d: f.dice_binary(x, d["mask"])),
    "softmax_cross_entropy": ("logits", lambda f, x, lv, d:
                              f.softmax_cross_entropy(x, d["labels"])),
    "softmax_cross_entropy_weighted": ("logits", lambda f, x, lv, d:
                                       f.softmax_cross_entropy(
                                           x, d["labels"], d["weight"])),
    "ce_dice": ("logits", lambda f, x, lv, d: f.ce_dice(x, d["labels"])),
    "ce_dice_adapt": ("logits", lambda f, x, lv, d: f.ce_dice_adapt(
        x, d["labels"], lv)),
    "ce_dice_adapt_weight": ("logits", lambda f, x, lv, d:
                             f.ce_dice_adapt_weight(x, d["labels"],
                                                    d["weight"], lv)),
}


def _jax_side(name, d):
    key, fn = CASES[name]
    dj = {k: jnp.asarray(v) for k, v in d.items()}
    dj["lut"] = jnp.asarray(LUT)
    loss = lambda x, lv: fn(J, x, lv, dj)
    val = loss(dj[key], dj["log_var"])
    gx, glv = jax.grad(loss, argnums=(0, 1))(dj[key], dj["log_var"])
    return float(val), np.asarray(gx), float(glv)


def _port_side(name, d):
    key, fn = CASES[name]
    dt = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    dt["lut"] = torch.from_numpy(LUT)
    x = torch.from_numpy(_nchw(d[key]) if key == "logits" else d[key].copy())
    x.requires_grad_(True)
    lv = torch.tensor(float(d["log_var"]), requires_grad=True)
    val = fn(T, x, lv, dt)
    val.backward()
    gx = x.grad.numpy()
    if key == "logits":
        gx = gx.transpose(0, 2, 3, 1)
    return val.item(), gx, 0.0 if lv.grad is None else lv.grad.item()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(name, seed):
    d = _inputs(seed)
    want, gx_w, glv_w = _jax_side(name, d)
    got, gx_g, glv_g = _port_side(name, d)
    assert got == pytest.approx(want, rel=VAL_RTOL, abs=1e-7)
    scale = max(1.0, np.abs(gx_w).max())
    np.testing.assert_allclose(gx_g, gx_w, atol=GRAD_TOL * scale, rtol=0)
    assert glv_g == pytest.approx(glv_w, abs=GRAD_TOL * max(1.0, abs(glv_w)))


def test_pick_class_clamps_out_of_range_labels():
    d = _inputs(2)
    want = np.asarray(J.pick_class(jnp.asarray(d["logits"]),
                                   jnp.asarray(d["labels"])))
    got = T.pick_class(torch.from_numpy(_nchw(d["logits"])),
                       torch.from_numpy(d["labels"])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (d["labels"] < 0).any() and (d["labels"] >= C).any()


def test_hir_lut_index_rules_match_jax():
    """Negative targets count from the end of the LUT and targets past it
    clamp, as JAX indexing does."""
    target = np.array([-1.0, -3.0, 0.0, 5.0, 255.0, 300.0, 1000.0], np.float32)
    want = np.asarray(jnp.asarray(LUT)[jnp.asarray(target).astype(jnp.int32)])
    got = T._lut(torch.from_numpy(LUT), torch.from_numpy(target)).numpy()
    np.testing.assert_array_equal(got, want)
