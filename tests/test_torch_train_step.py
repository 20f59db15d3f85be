"""The port's height train step against the JAX package's.

Tiny configuration (``efficientnet-test``, decoder widths (32, 24, 16, 12,
8), super_mid 8, 32x32 tiles, batch 2), weights from the JAX model's seeded
init carried across with ``convert.height_model_state_dict``, and fixed SR
features on both sides. Drop-connect is off (rate 0) wherever the two
frameworks are compared: their random bits differ.

(a) The gradients of one forward against ``jax.value_and_grad``: with
    BatchNorm on its running statistics, max abs difference at most
    1e-4 x max |g| per tensor; in training mode (batch statistics), loss and
    log-var gradients within 1e-5, the updated BatchNorm statistics within
    2e-5, and the parameter gradients, taken in float64 on the port's side,
    within 1e-2 x max |g| per tensor plus 1e-6 x the model's largest
    gradient (see the test for why).
(b) The optimizer alone, on 3 fixed gradient sets at lrs 1e-3, 1e-3, 1e-4
    with the log-vars, against ``TrainState.apply_gradients``: within 1e-6;
    and Adam's moments carried across by ``convert.train_state_from_jax``.
(c) Three whole steps against ``make_train_step``: loss, rmse and log-vars
    within 1e-3 relative per step; parameters by sign flips: none beyond
    1e-4 after step 1 (2.5e-3 after steps 2 and 3) where JAX's step-1
    gradient stands clear of the measured float32 noise, and the share of
    all elements beyond those thresholds bounded (see the test). Adam's
    first update is +-lr whatever the gradient's size, so an element whose
    gradient is near zero may move either way in the two frameworks; step-3
    BatchNorm statistics compound such flips and are not compared element by
    element.
(d) ``make_eval_step`` and ``make_predict_step`` within 1e-5; and, on the
    tiny flagship, bit for bit the same models run by hand in their compute
    type (float32 as it is, bfloat16 under ``torch.autocast``).
(e) Drop-connect: per-block rates, survivors scaled by exactly 1/keep, the
    drop rate within 3 sigma, the identity in eval mode, seeded draws.
"""
import contextlib

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from srbh_tpu.losses import adaptive as JL
from srbh_tpu.models import SRRegressClsFeature as JaxModel
from srbh_tpu.models.efficientnet import _B0_STAGES as JAX_STAGES
from srbh_tpu.models.efficientnet import SCALING as JAX_SCALING
from srbh_tpu.models.efficientnet import round_repeats as jax_round_repeats
from srbh_tpu.train.state import TrainState as JaxState
from srbh_tpu.train.steps import make_eval_step as jax_eval_step
from srbh_tpu.train.steps import make_predict_step as jax_predict_step
from srbh_tpu.train.steps import make_train_step as jax_train_step
from srbh_tpu_torch import convert, entry
from srbh_tpu_torch.losses.adaptive import ce_dice_adapt_weight, mse_adapt_weight
from srbh_tpu_torch.models.efficientnet import MBConv
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import (
    make_eval_step,
    make_predict_step,
    make_train_step,
    step_seed,
)
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


ENC = "efficientnet-test"
DEC = (32, 24, 16, 12, 8)
LRS = (1e-3, 1e-3, 1e-4)


class FixedFeatureJax:
    """The frozen RRDBNet's stand-in on the JAX side."""

    def __init__(self, fea):
        self._fea = jnp.asarray(fea)

    def apply(self, params, x, features_only=True):
        return self._fea


class FixedFeature(torch.nn.Module):
    """The frozen RRDBNet's stand-in on the port's side (NCHW)."""

    def __init__(self, fea_nhwc):
        super().__init__()
        self.register_buffer("fea", torch.from_numpy(
            np.ascontiguousarray(fea_nhwc.transpose(0, 3, 1, 2))))

    def forward(self, x, features_only=True):
        return self.fea


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in tree.items()}


def _batch(rng, isaggre=True):
    b = {
        "image": rng.normal(size=(2, 32, 32, 8)).astype(np.float32),
        "height": np.abs(rng.normal(size=(2, 128, 128))).astype(np.float32) * 8,
        "weight": rng.uniform(0.5, 2.0, size=(2, 128, 128)).astype(np.float32),
        "build": rng.integers(0, 7, size=(2, 128, 128)).astype(np.int32),
    }
    if isaggre:
        b["height_aggre"] = np.abs(rng.normal(size=(2, 32, 32))
                                   ).astype(np.float32) * 8
        b["weight_aggre"] = rng.uniform(0.5, 2.0, size=(2, 32, 32)
                                        ).astype(np.float32)
    return b


def _jax_model(isaggre=True, rate=0.0):
    return JaxModel(encoder_name=ENC, super_mid=8, isaggre=isaggre,
                    chans_build=7, decoder_channels=DEC, drop_connect_rate=rate)


def _port_model(variables, isaggre=True, rate=0.0):
    m = SRRegressClsFeature(ENC, super_mid=8, isaggre=isaggre, chans_build=7,
                            sr_chans=8, decoder_channels=DEC,
                            drop_connect_rate=rate)
    m.load_state_dict(convert.height_model_state_dict(variables, ENC, isaggre))
    return m


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    fea = rng.normal(size=(2, 128, 128, 8)).astype(np.float32)
    out = {"fea": fea}
    for isaggre in (True, False):
        v = jax.jit(_jax_model(isaggre).init)(
            jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 8)), jnp.asarray(fea))
        out[isaggre] = jax.device_get(dict(v))
    out["batch"] = _batch(rng)
    out["batch2"] = _batch(rng, isaggre=False)
    return out


def _names(params, batch_stats, isaggre=True):
    """A JAX params tree (or a tree of its shape) under the port's names,
    BatchNorm running stats left out."""
    sd = convert.height_model_state_dict(
        {"params": params, "batch_stats": batch_stats}, ENC, isaggre)
    return {k: v.numpy() for k, v in sd.items()
            if k.rsplit(".", 1)[-1] in ("weight", "bias")}


def _stats(sd):
    return {k: np.asarray(v) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _port_grads(variables, b, fea_nhwc, lv0, train, dtype=torch.float32):
    """(loss, log_var grads, parameter grads, state dict) of one forward of
    the port's model in ``dtype``, BatchNorm on batch statistics if
    ``train`` (else on the running ones)."""
    model = _port_model(variables).to(dtype).train(train)
    log_vars = torch.tensor(lv0, dtype=dtype, requires_grad=True)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t.items()}
    fea = FixedFeature(fea_nhwc).fea.to(dtype)
    h, bl, a = model(t["image"].permute(0, 3, 1, 2), fea)
    loss = (mse_adapt_weight(h[:, 0], t["height"], t["weight"], log_vars[0])
            + mse_adapt_weight(a[:, 0], t["height_aggre"], t["weight_aggre"],
                               log_vars[1])
            + ce_dice_adapt_weight(bl, t["build"], t["weight"], log_vars[2]))
    loss.backward()
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return loss.item(), log_vars.grad.double().numpy(), grads, model.state_dict()


def _jax_grads(setup, lv0, train, isaggre=True):
    """(loss, log_var grads, parameter grads under the port's names, updated
    batch_stats) of the same forward through ``jax.value_and_grad``; with
    ``isaggre=False`` the two-head model of the plain epoch, on ``batch2``
    with its unweighted losses (as ``make_train_step``)."""
    variables = setup[isaggre]
    b = setup["batch"] if isaggre else setup["batch2"]
    jm = _jax_model(isaggre)
    bj = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params, log_vars):
        outs, mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            bj["image"], jnp.asarray(setup["fea"]), train=train,
            mutable=["batch_stats"])
        if isaggre:
            h, bl, a = outs
            loss = (JL.mse_adapt_weight(h[..., 0], bj["height"], bj["weight"],
                                        log_vars[0])
                    + JL.mse_adapt_weight(a[..., 0], bj["height_aggre"],
                                          bj["weight_aggre"], log_vars[1])
                    + JL.ce_dice_adapt_weight(bl, bj["build"], bj["weight"],
                                              log_vars[2]))
        else:
            loss = (JL.mse_adapt(outs[0][..., 0], bj["height"], log_vars[0])
                    + JL.ce_dice_adapt(outs[1], bj["build"], log_vars[1]))
        return loss, mutated["batch_stats"]

    (loss, stats), (g_p, g_lv) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                                jnp.asarray(lv0))
    return (float(loss), np.asarray(g_lv),
            _names(jax.device_get(g_p), variables["batch_stats"], isaggre),
            jax.device_get(stats))


LV0 = np.array([0.1, -0.2, 0.3], np.float32)


def test_gradients_on_running_statistics_match_jax(setup):
    """The whole backward pass but BatchNorm's batch statistics (BatchNorm
    on its running statistics, ``train=False``): every parameter's gradient
    within 1e-4 x max |g| of its tensor."""
    loss_j, glv_j, want, _ = _jax_grads(setup, LV0, train=False)
    loss, glv, grads, _ = _port_grads(setup[True], setup["batch"],
                                      setup["fea"], LV0, train=False)
    assert loss == pytest.approx(loss_j, rel=1e-5)
    np.testing.assert_allclose(glv, glv_j, rtol=1e-5, atol=1e-6)
    assert set(grads) == set(want)
    for name, g in want.items():
        assert np.abs(grads[name] - g).max() <= 1e-4 * np.abs(g).max(), name


def test_gradients_of_one_training_forward(setup):
    """One forward in training mode (BatchNorm on batch statistics, which it
    updates): loss and log-var gradients within 1e-5 and the updated
    statistics within 2e-5, the port in float32 as JAX.

    The parameter gradients of this configuration are ill-conditioned in
    float32 (BatchNorm's backward subtracts batch means of nearly constant
    gradients, and the identity blocks' ``_bn2.bias`` have a true gradient
    of 0). The port's float32 gradients on the CPU lie 1e-3 (eight threads)
    to 4e-2 (one thread) from its float64 ones in relative L2 norm, while
    JAX's float32 gradients lie 2e-4 from them. So the port's gradients are
    taken in float64, where rounding leaves the semantics to compare. Each
    tensor is held to its own size: JAX's gradient within 1e-2 x the
    tensor's max |g| (measured: at most 7.0e-3, in ``decoder2``), plus 1e-6
    x the model's largest gradient for float32 rounding, which is all the
    identity blocks' ``_bn2.bias`` carry (exactly 0 in float64; JAX's at
    most 6.2e-6, against 2.9e-5)."""
    variables, b = setup[True], setup["batch"]
    loss_j, glv_j, want, stats_j = _jax_grads(setup, LV0, train=True)
    loss, glv, _, sd = _port_grads(variables, b, setup["fea"], LV0, True)
    _, _, exact, _ = _port_grads(variables, b, setup["fea"], LV0, True,
                                 torch.float64)
    assert loss == pytest.approx(loss_j, rel=1e-5)
    np.testing.assert_allclose(glv, glv_j, rtol=1e-5, atol=1e-6)
    assert set(exact) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        bound = 1e-2 * np.abs(exact[name]).max() + 1e-6 * scale
        assert np.abs(exact[name] - g).max() <= bound, name
    want_stats = _stats(convert.height_model_state_dict(
        {"params": variables["params"], "batch_stats": stats_j}, ENC, True))
    got_stats = _stats(sd)
    assert set(got_stats) == set(want_stats)
    for name, st in want_stats.items():
        np.testing.assert_allclose(got_stats[name], st, atol=2e-5, rtol=0,
                                   err_msg=name)


def _grad_sets(variables, n, seed=5):
    rng = np.random.default_rng(seed)
    like = lambda t: jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, np.shape(a)).astype(np.float32), t)
    return [(like(variables["params"]),
             rng.normal(0, 0.1, 3).astype(np.float32)) for _ in range(n)]


def _apply_port_grads(state, gp, glv, batch_stats):
    named = dict(state.model.named_parameters())
    for name, g in _names(gp, batch_stats).items():
        named[name].grad = torch.from_numpy(np.ascontiguousarray(g))
    state.log_vars.grad = torch.from_numpy(glv)


def test_optimizer_matches_jax_apply_gradients(setup):
    variables = setup[True]
    jstate = JaxState.create(variables, n_log_vars=3, lr=1e-3,
                             weight_decay=1e-4, log_var_lr=1e-3,
                             log_vars=jnp.array([0.1, -0.2, 0.3]))
    state = TrainState(_port_model(variables), n_log_vars=3,
                       log_vars=torch.tensor([0.1, -0.2, 0.3]))
    apply = jax.jit(lambda s, gp, glv, lr: s.apply_gradients(gp, glv, lr))
    grads = _grad_sets(variables, 4)
    for (gp, glv), lr in zip(grads, LRS):
        jstate = apply(jstate, gp, jnp.asarray(glv), jnp.float32(lr))
        _apply_port_grads(state, gp, glv, variables["batch_stats"])
        state.apply_gradients(lr)
        want = _names(jax.device_get(jstate.params), variables["batch_stats"])
        got = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=1e-6, rtol=0,
                                       err_msg=name)
        np.testing.assert_allclose(state.log_vars.detach().numpy(),
                                   np.asarray(jstate.log_vars), atol=1e-6)
    assert state.step == int(jstate.step) == 3

    # Adam's moments carried across: a fresh port state from the JAX state
    # takes a 4th step as the JAX state does
    sd, lv, moments = convert.train_state_from_jax(
        jax.device_get(jstate.params), variables["batch_stats"],
        np.asarray(jstate.log_vars),
        jax.device_get(serialization.to_state_dict(jstate.opt_state)),
        ENC, True)
    fresh = _port_model(variables)
    fresh.load_state_dict(sd)
    carried = TrainState(fresh, n_log_vars=3, log_vars=lv)
    carried.load_moments(moments)
    assert moments["model"]["step"] == moments["log_vars"]["step"] == 3
    gp, glv = grads[3]
    jstate = apply(jstate, gp, jnp.asarray(glv), jnp.float32(1e-4))
    _apply_port_grads(carried, gp, glv, variables["batch_stats"])
    carried.apply_gradients(1e-4)
    want = _names(jax.device_get(jstate.params), variables["batch_stats"])
    for name, p in carried.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(carried.log_vars.detach().numpy(),
                               np.asarray(jstate.log_vars), atol=1e-6)


def _differ(got, want, thresh):
    """Per tensor, the elements more than ``thresh`` apart."""
    return {name: np.abs(got[name].astype(np.float64)
                         - w.astype(np.float64)) > thresh
            for name, w in want.items()}


# Largest float32 error of a training gradient, per tensor, as a share of the
# tensor's max |g| (against the port's float64 gradient, torch at 1, 2, 4 and
# 8 threads on the CPU): JAX's plus the port's, rounded up. The plain
# epoch's two-head model is ten times worse conditioned (JAX's float32
# gradient lies 1.1e-2 from float64 in relative L2, the aggregated model's
# 2.4e-4).
F32_GRAD_NOISE = {True: 0.02, False: 0.2}
# the share of all parameter elements beyond the thresholds: the worst value
# measured at those thread counts (and under pytest-xdist) times two at least
STEP1_SHARE, LATER_SHARE = 0.013, 0.003


@pytest.mark.parametrize("isaggre", [True, False])
def test_three_steps_match_jax_make_train_step(setup, isaggre):
    """Three whole steps against JAX's. Adam's first update is +-lr whatever
    the gradient's size, so a gradient near 0 whose sign differs between
    the two frameworks' float32 rounding gives a 2 x lr difference that is
    no fault of the port. A difference is a fault where JAX's step-1
    gradient stands clear of float32 noise: above twice
    ``F32_GRAD_NOISE`` x its tensor's max |g| (plus 1e-6 x the model's
    largest gradient, for tensors whose true gradient is 0). None may differ
    there, after step 1 by more than 1e-4 and after steps 2 and 3 by more
    than 2.5e-3; the share of all elements beyond those thresholds is
    printed and bounded."""
    variables = setup[isaggre]
    b = setup["batch"] if isaggre else setup["batch2"]
    n_lv = 3 if isaggre else 2
    jstate = JaxState.create(variables, n_log_vars=n_lv, lr=1e-3,
                             weight_decay=1e-4, log_var_lr=1e-3)
    *_, grads, _ = _jax_grads(setup, np.zeros(n_lv, np.float32), True, isaggre)
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    clear = {name: np.abs(g) > 2 * F32_GRAD_NOISE[isaggre] * np.abs(g).max()
             + floor for name, g in grads.items()}
    jstep = jax_train_step(_jax_model(isaggre), FixedFeatureJax(setup["fea"]),
                           isaggre=isaggre, seed=0)
    state = TrainState(_port_model(variables, isaggre), n_log_vars=n_lv)
    step = make_train_step(state.model, FixedFeature(setup["fea"]),
                           isaggre=isaggre, seed=0, device="cpu")
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    total = sum(g.size for g in grads.values())
    for i, lr in enumerate(LRS):
        jstate, jm = jstep(jstate, {}, bj, jnp.float32(lr))
        m = step(state, b, lr)
        for key in ("loss", "rmse"):
            assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-3), \
                f"{key} step {i}"
        np.testing.assert_allclose(m["log_vars"].numpy(),
                                   np.asarray(jm["log_vars"]), rtol=1e-3,
                                   atol=1e-6, err_msg=f"log_vars step {i}")
        want = _names(jax.device_get(jstate.params), variables["batch_stats"],
                      isaggre)
        got = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
        thresh, bound = (1e-4, STEP1_SHARE) if i == 0 else (2.5e-3, LATER_SHARE)
        differ = _differ(got, want, thresh)
        share = sum(int(d.sum()) for d in differ.values()) / total
        print(f"step {i + 1}: {share:.4%} of params beyond {thresh:g} "
              f"(bound {bound:.2%})")
        faults = {n: int((d & clear[n]).sum()) for n, d in differ.items()}
        assert not any(faults.values()), \
            f"step {i + 1}: {sum(faults.values())} clear-gradient elements " \
            f"beyond {thresh:g}: {[n for n, k in faults.items() if k][:5]}"
        assert share < bound, f"step {i + 1}: {share:.4%} beyond {thresh:g}"
    assert state.step == 3


def test_train_step_without_sr_model(setup):
    """``sr_model=None`` (the nosuper form) feeds the model the image only:
    a model that adds fixed features itself trains exactly as the model fed
    by a fixed-feature SR model."""
    variables, b = setup[True], setup["batch"]
    fea = FixedFeature(setup["fea"])

    class WithFeatures(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, generator=None):
            return self.inner(x, fea.fea, generator=generator)

    a = TrainState(_port_model(variables))
    bare = TrainState(WithFeatures(_port_model(variables)))
    step_a = make_train_step(a.model, fea, device="cpu")
    step_b = make_train_step(bare.model, None, device="cpu")
    for lr in LRS[:2]:
        ma, mb = step_a(a, b, lr), step_b(bare, b, lr)
        assert ma["loss"].item() == mb["loss"].item()
        torch.testing.assert_close(ma["log_vars"], mb["log_vars"], rtol=0,
                                   atol=0)


def test_eval_and_predict_steps_match_jax(setup):
    rng = np.random.default_rng(7)
    variables = {"params": setup[True]["params"],
                 "batch_stats": _random_stats(setup[True]["batch_stats"], rng)}
    b = setup["batch"]
    jstate = JaxState.create(variables, n_log_vars=3)
    sr_j = FixedFeatureJax(setup["fea"])
    want = jax_eval_step(_jax_model(), sr_j)(jstate, {}, {
        "image": jnp.asarray(b["image"]), "height": jnp.asarray(b["height"])})
    model = _port_model(variables)
    got = make_eval_step(model, FixedFeature(setup["fea"]), device="cpu")(b)
    for key in ("loss", "rmse"):
        assert got[key].item() == pytest.approx(float(want[key]), rel=1e-5)
    wh, wb = jax_predict_step(_jax_model(), sr_j)(jstate, {},
                                                  jnp.asarray(b["image"]))
    gh, gb = make_predict_step(model, FixedFeature(setup["fea"]),
                               device="cpu")(b["image"])
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_and_predict_steps_run_in_their_compute_type(dtype):
    """The steps' compute type is the one rule of the package root: in
    bfloat16 the steps equal, bit for bit, the frozen SR features and the
    height model run by hand under ``torch.autocast("cpu", bfloat16)``; in
    float32 the models run without autocast."""
    dtype = getattr(torch, dtype)
    model, sr, _ = entry.flagship(tiny=True, device="cpu")
    rng = np.random.default_rng(11)
    batch = {"image": rng.random((2, 64, 64, 8), np.float32),
             "height": rng.random((2, 256, 256), np.float32) * 30}
    x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    scope = (torch.autocast("cpu", dtype=dtype) if dtype != torch.float32
             else contextlib.nullcontext())
    with torch.no_grad(), scope:
        outs = model(x, sr(x[:, [0, 1, 2]], features_only=True))
    assert outs[0].dtype == dtype
    mse = torch.mean((outs[0][:, 0].float()
                      - torch.from_numpy(batch["height"])) ** 2)
    got = make_eval_step(model, sr, dtype=dtype, device="cpu")(batch)
    assert torch.equal(got["loss"], mse)
    assert torch.equal(got["rmse"], torch.sqrt(mse))
    h, b = make_predict_step(model, sr, dtype=dtype,
                             device="cpu")(batch["image"])
    assert torch.equal(h, outs[0][:, 0])
    assert torch.equal(b, outs[1].permute(0, 2, 3, 1))


# ---------------------------------------------------------------- (e)


def test_drop_connect_block_rates_follow_the_jax_formula():
    model = SRRegressClsFeature("efficientnet-b4", drop_connect_rate=0.2)
    blocks = list(model.encoder._blocks)
    _, depth, _ = JAX_SCALING["efficientnet-b4"]
    repeats = [jax_round_repeats(r, depth) for *_, r in JAX_STAGES]
    total = sum(repeats)
    assert len(blocks) == total == 32
    for i, blk in enumerate(blocks):
        assert blk.drop_rate == 0.2 * i / total  # srbh_tpu efficientnet.py:167


def _identity_block(rate):
    torch.manual_seed(0)
    blk = MBConv(8, 8, 6, 3, 1, drop_rate=rate)
    assert blk.identity
    return blk


def _run_capturing_h(blk, x, generator):
    """The block's output, and ``h`` before drop-connect (``_bn2``'s)."""
    seen = {}
    hook = blk._bn2.register_forward_hook(
        lambda m, i, o: seen.__setitem__("h", o))
    out = blk(x, generator)
    hook.remove()
    return out, seen["h"]


def test_drop_connect_scales_survivors_and_drops_at_its_rate():
    rate, n = 0.3, 20000
    blk = _identity_block(rate).train()
    x = torch.randn(n, 8, 1, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, h = _run_capturing_h(blk, x, torch.Generator().manual_seed(2))
    keep = 1.0 - rate
    survivor = (out == h / keep + x).flatten(1).all(1)
    dropped = (out == x).flatten(1).all(1)
    assert bool((survivor ^ dropped).all())  # every sample is one or other
    frac = dropped.double().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(frac - rate) < 3 * sigma, (frac, rate, sigma)


def test_drop_connect_is_the_identity_in_eval_mode():
    x = torch.randn(64, 8, 4, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = _identity_block(0.3).eval()(x, torch.Generator().manual_seed(4))
        want = _identity_block(0.0).eval()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_drop_connect_draws_are_seeded(setup):
    """Through ``make_train_step``: the same seed gives the same steps, and
    another seed other drop-connect masks. ``efficientnet-b0`` (the test
    encoder has a single identity block, at rate 0)."""
    b = setup["batch"]
    model = SRRegressClsFeature("efficientnet-b0", super_mid=8, isaggre=True,
                                chans_build=7, sr_chans=8, decoder_channels=DEC,
                                drop_connect_rate=0.5)
    init_weights(model, torch.Generator().manual_seed(0))
    assert sum(blk.identity and blk.drop_rate > 0
               for blk in model.encoder._blocks) >= 5
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def run(seed):
        model.load_state_dict(init)
        state = TrainState(model)
        step = make_train_step(model, FixedFeature(setup["fea"]), seed=seed,
                               device="cpu")
        return [step(state, b, lr)["loss"].item() for lr in LRS[:2]]

    assert run(3) == run(3)
    assert run(3) != run(4)
    assert len({step_seed(3, 0), step_seed(3, 1), step_seed(4, 0)}) == 3


def test_drop_connect_generator_reproduces():
    blk = _identity_block(0.5).train()
    x = torch.randn(32, 8, 4, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        a = blk(x, torch.Generator().manual_seed(6))
        b = blk(x, torch.Generator().manual_seed(6))
        c = blk(x, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
