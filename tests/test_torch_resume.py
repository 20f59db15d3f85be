"""A resumed height training run against the JAX package's resume.

As in the reference (train.py:163-164, 207), the JAX package writes no
optimizer state into a checkpoint unless ``save_opt_state=True``
(``srbh_tpu/train/checkpoint.py``), so a run resumed from a default
checkpoint starts a fresh Adam. The port does the same:

* two tiny ``trainer.main`` runs (the configuration of
  ``tests/test_torch_trainer.py``), one by default and one with
  ``save_opt_state``, each stopped after epoch 1 and resumed once: the
  default checkpoint has no ``optimizer`` entry and the resumed Adam counts
  only the resumed epoch's steps; with ``save_opt_state`` the entry is there,
  it restores bit for bit, and Adam counts every step;
* the first step after a resume from the default checkpoint against the
  JAX package's (its ``restore_into_state`` of the same weights, log-vars
  and step, then its ``make_train_step``): loss and log-vars within 1e-3
  relative, parameters by the gradient-noise rule of
  ``tests/test_torch_train_step.py`` (a fresh Adam's first update is +-lr
  whatever the gradient's size, so only elements whose JAX gradient stands
  clear of float32 noise must agree within 1e-4; the gradient Adam sees
  includes the coupled weight decay). The noise is measured
  here, per tensor, for this configuration: the largest distance of JAX's
  and of the port's float32 gradient from the port's float64 one. An Adam
  that kept its moments moves those elements by other amounts.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbh_tpu.losses import adaptive as JL
from srbh_tpu.models import SRRegressClsFeature as JaxModel
from srbh_tpu.train.checkpoint import restore_into_state as jax_restore
from srbh_tpu.train.convert import convert_height_model
from srbh_tpu.train.state import TrainState as JaxState
from srbh_tpu.train.steps import make_train_step as jax_train_step
from srbh_tpu_torch.losses.adaptive import ce_dice_adapt_weight, mse_adapt_weight
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.train import checkpoint
from srbh_tpu_torch.train.schedule import step_decay_lr
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import (
    STEP1_SHARE,
    FixedFeature,
    FixedFeatureJax,
    _batch,
    _differ,
    _names,
)
from test_torch_trainer import data, make_cfg  # noqa: F401 (fixture)
from srbh_tpu_torch.train.trainer import main

EPOCH_STEPS = 2  # 8 tiles at batch 4


@pytest.fixture(scope="module")
def resumed(data):  # noqa: F811
    """For each setting, the epoch-1 checkpoint's payload and the state of
    the run resumed from it for epoch 2."""
    out = {}
    for save_opt_state in (False, True):
        logdir = f"resume_opt_{save_opt_state}"
        main(make_cfg(data, logdir, 1, save_opt_state=save_opt_state),
             device="cpu")
        payload = checkpoint.load_checkpoint(
            os.path.join(data, logdir, "checkpoint"))
        state = main(make_cfg(data, logdir, 2, save_opt_state=save_opt_state),
                     device="cpu")
        out[save_opt_state] = payload, state
    return out


@pytest.mark.parametrize("save_opt_state", [False, True])
def test_checkpoint_holds_the_optimizer_only_when_asked(data, resumed,  # noqa: F811
                                                        save_opt_state):
    payload, state = resumed[save_opt_state]
    assert ("optimizer" in payload) == save_opt_state
    assert payload["epoch"] == 1 and payload["step"] == EPOCH_STEPS
    assert state.step == 2 * EPOCH_STEPS
    # Adam's own count: the resumed epoch alone after a fresh start, every
    # step after an exact resume
    counts = {float(st["step"]) for st in state.optimizer.state.values()}
    assert counts == {float(2 * EPOCH_STEPS if save_opt_state
                            else EPOCH_STEPS)}

    fresh = _port_state(make_cfg(data, "unused", 2))
    checkpoint.restore_into_state(fresh, payload)
    assert fresh.step == EPOCH_STEPS
    if not save_opt_state:
        assert not fresh.optimizer.state  # a fresh Adam
        return
    saved = payload["optimizer"]["state"]
    restored = fresh.optimizer.state_dict()["state"]
    assert restored.keys() == saved.keys()
    for i, st in saved.items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(restored[i][k]),
                               torch.as_tensor(v)), (i, k)


def _port_state(cfg) -> TrainState:
    """``trainer.main``'s model and state, drop-connect off (its random
    bits differ between the frameworks)."""
    model = SRRegressClsFeature(cfg.encoder_name, super_mid=cfg.super_mid,
                                isaggre=cfg.isaggre,
                                chans_build=cfg.chans_build,
                                sr_chans=cfg.sr_num_feat,
                                drop_connect_rate=0.0)
    return TrainState(model, n_log_vars=3, lr=cfg.lr,
                      weight_decay=cfg.weight_decay)


def _port_gradient(payload, cfg, b, fea, dtype):
    """The port's gradient of the training loss at the resumed state in
    ``dtype``."""
    state = _port_state(cfg)
    checkpoint.restore_into_state(state, payload)
    model = state.model.to(dtype).train()
    log_vars = payload["log_vars"].to(dtype)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t.items()}
    h, bl, a = model(t["image"].permute(0, 3, 1, 2),
                     FixedFeature(fea).fea.to(dtype))
    loss = (mse_adapt_weight(h[:, 0], t["height"], t["weight"], log_vars[0])
            + mse_adapt_weight(a[:, 0], t["height_aggre"], t["weight_aggre"],
                               log_vars[1])
            + ce_dice_adapt_weight(bl, t["build"], t["weight"], log_vars[2]))
    loss.backward()
    return {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def _jax_gradient(jm, variables, log_vars, b, fea):
    """JAX's gradient of the training loss at the resumed state, under the
    port's names."""
    bj = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        (h, bl, a), _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            bj["image"], jnp.asarray(fea), train=True,
            mutable=["batch_stats"])
        return (JL.mse_adapt_weight(h[..., 0], bj["height"], bj["weight"],
                                    log_vars[0])
                + JL.mse_adapt_weight(a[..., 0], bj["height_aggre"],
                                      bj["weight_aggre"], log_vars[1])
                + JL.ce_dice_adapt_weight(bl, bj["build"], bj["weight"],
                                          log_vars[2]))

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return _names(jax.device_get(grads), variables["batch_stats"])


def test_first_resumed_step_matches_the_jax_resume(data, resumed):  # noqa: F811
    payload, _ = resumed[False]
    cfg = make_cfg(data, "unused", 2)
    lr = step_decay_lr(cfg.lr, payload["epoch"] + 1)
    rng = np.random.default_rng(31)
    fea = rng.normal(size=(2, 128, 128, cfg.sr_num_feat)).astype(np.float32)
    b = _batch(rng)

    state = _port_state(cfg)
    checkpoint.restore_into_state(state, payload)
    step = make_train_step(state.model, FixedFeature(fea), isaggre=True,
                           seed=0, device="cpu")

    # the JAX package's resume of the same checkpoint: a fresh state, then
    # weights, BatchNorm statistics, log-vars and step from the payload
    variables = convert_height_model(
        {k: v.numpy() for k, v in payload["model"].items()}, isaggre=True,
        encoder_name=cfg.encoder_name)
    log_vars = payload["log_vars"].numpy()
    jm = JaxModel(encoder_name=cfg.encoder_name, super_mid=cfg.super_mid,
                  isaggre=True, chans_build=cfg.chans_build,
                  drop_connect_rate=0.0)
    jstate = jax_restore(
        JaxState.create(variables, n_log_vars=3, lr=cfg.lr,
                        weight_decay=cfg.weight_decay),
        {**variables, "log_vars": log_vars, "step": payload["step"]})
    grads = _jax_gradient(jm, variables, log_vars, b, fea)
    jstep = jax_train_step(jm, FixedFeatureJax(fea), isaggre=True, seed=0)

    jstate, jm_out = jstep(jstate, {}, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.float32(lr))
    m = step(state, b, lr)
    for key in ("loss", "rmse"):
        assert m[key].item() == pytest.approx(float(jm_out[key]), rel=1e-3), key
    np.testing.assert_allclose(m["log_vars"].numpy(),
                               np.asarray(jm_out["log_vars"]), rtol=1e-3,
                               atol=1e-6)
    assert state.step == int(jstate.step) == EPOCH_STEPS + 1

    exact = _port_gradient(payload, cfg, b, fea, torch.float64)
    single = _port_gradient(payload, cfg, b, fea, torch.float32)
    noise = {n: np.abs(g - exact[n]).max() + np.abs(single[n] - exact[n]).max()
             for n, g in grads.items()}
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    # Adam's input: the gradient plus the coupled weight decay
    seen = {n: g + cfg.weight_decay * payload["model"][n].double().numpy()
            for n, g in grads.items()}
    clear = {n: np.abs(g) > 2 * noise[n] + floor for n, g in seen.items()}
    want = _names(jax.device_get(jstate.params), variables["batch_stats"])
    got = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
    differ = _differ(got, want, 1e-4)
    faults = {n: int((d & clear[n]).sum()) for n, d in differ.items()}
    assert sum(int(c.sum()) for c in clear.values()) > 0
    assert not any(faults.values()), \
        f"{sum(faults.values())} clear-gradient elements beyond 1e-4: " \
        f"{[n for n, k in faults.items() if k][:5]}"
    total = sum(g.size for g in grads.values())
    share = sum(int(d.sum()) for d in differ.values()) / total
    assert share < STEP1_SHARE, share
