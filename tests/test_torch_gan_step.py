"""The port's Real-ESRGAN GAN step against ``RealESRGANTrainer.make_step``.

NF 8, GC 4, one RRDB, discriminator width 8, batch 2, lq 8x8 -> gt 32x32,
perceptual loss on (full-width VGG19 at random weights). The JAX trainer's
seeded state comes across through ``convert.gan_state_from_jax``.

* Over 3 steps: the eight metrics within 1e-4 x (1 + |b|); every spectral
  norm's stored ``u`` and ``sigma`` within 1e-5; the EMA within 1e-6.
* Step 1's G and D gradients (the port's ``.grad`` after the step against
  ``jax.grad`` of the JAX step's two losses) within 1e-4 x the tensor's
  max |g|. The gradients are well conditioned here: in float32 JAX's lie
  within 8.1e-5 of the port's float64 ones (D's ``conv9.bias``) and the
  port's within 6.9e-5-8.1e-5, as a share of the tensor's max |g|, at 1 and
  8 torch threads; JAX against the port in float32 1.6e-6-1.2e-5.
* Parameters by the rule of the height step's test: Adam's first update is
  +-lr whatever the gradient's size, so an element may differ where JAX's
  step-1 gradient lies within float32 noise of 0. A difference beyond 1e-4
  (step 1; 2.5e-4 after steps 2 and 3) is a fault where that gradient
  exceeds twice the measured noise (1e-4 x the tensor's max |g|, plus 1e-6
  x the largest gradient). The share of all elements beyond is printed and
  bounded.
* Each USM ground-truth switch, ``warmup_iter=2`` (the first update is
  zero), the one-channel adaptation, ``ema_apply_fn`` with
  ``features_only``, Adam's moments carried from a JAX state, a bfloat16
  step (finite, float32 state), the ``remat`` refusal and the scope of
  the step's cuDNN autotuning.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.losses.sr import gan_loss as jgan_loss
from srbh_tpu.losses.sr import l1_loss as jl1_loss
from srbh_tpu.losses.sr import perceptual_loss as jperceptual_loss
from srbh_tpu.ops.usm import usm_sharp as jusm_sharp
from srbh_tpu.train.sr_trainer import RealESRGANTrainer as JaxTrainer
from srbh_tpu.train.sr_trainer import adapt_weights_to_1ch as jax_adapt_1ch
from srbh_tpu_torch import convert
from srbh_tpu_torch.train.sr_trainer import (
    RealESRGANTrainer,
    adapt_weights_to_1ch,
    load_adam_moments,
)
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

NF, GC, NB, DNF = 8, 4, 1, 8
METRIC_TOL, SN_TOL, EMA_TOL = 1e-4, 1e-5, 1e-6
GRAD_TOL = 1e-4  # x the tensor's max |g|
F32_GRAD_NOISE = 1e-4  # x the tensor's max |g|: measured at most 8.1e-5
# share of all G and D elements beyond the thresholds: the worst measured at
# 1, 2, 4 and 8 torch threads (0 at each) has no room to double, so the
# bound is one element in ten thousand
SHARE_BOUND = 1e-4


def _kw(**kw):
    return dict(dict(num_block=NB, num_feat=NF, num_grow_ch=GC, disc_feat=DNF), **kw)


def _batches(n, ch=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (2, 8, 8, ch)).astype(np.float32),
             rng.uniform(0, 1, (2, 32, 32, ch)).astype(np.float32)) for _ in range(n)]


def _pair(ch=3, g_params=None, **kw):
    """A JAX trainer and state, and the port's, from the same weights."""
    jt = JaxTrainer(out_ch=ch, **_kw(**kw))
    js = jt.init(jax.random.PRNGKey(0), (2, 8, 8, ch), g_params=g_params)
    g, ema, d, _, _ = convert.gan_state_from_jax(
        jax.device_get(js.g_params), jax.device_get(js.g_ema),
        jax.device_get(js.d_vars), num_block=NB)
    pt = RealESRGANTrainer(out_ch=ch, **_kw(**kw))
    vgg = (convert.vgg19_state_dict(jax.device_get(jt.vgg_variables))
           if jt.vgg is not None else None)
    ps = pt.init(0, (2, 8, 8, ch), g_state=g, d_state=d, vgg_state=vgg, device="cpu")
    ps.g_ema.load_state_dict(ema)
    return jt, js, pt, ps


def _check_metrics(pm, jm, label):
    assert set(pm) == set(jm)
    for k, v in jm.items():
        b = float(v)
        assert abs(pm[k].item() - b) <= METRIC_TOL * (1 + abs(b)), f"{label} {k}"


def _sigmas(d_vars):
    """The JAX discriminator's stored sigma of each spectral norm."""
    stats = d_vars["batch_stats"]
    return {f"conv{i}": float(stats[f"conv{i}_sn"][f"conv{i}/kernel/sigma"])
            for i in range(1, 9)}


def _sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _jax_grads(jt, js, lq, gt):
    """Step 1's G and D gradients, by ``jax.grad`` of the JAX step's losses
    (sr_trainer.py:166-205), under the port's names."""
    gt_usm = jusm_sharp(jnp.asarray(gt))
    d_params, d_stats = js.d_vars["params"], js.d_vars["batch_stats"]

    def g_loss(gp):
        out = jt.net_g.apply({"params": gp}, jnp.asarray(lq))
        fake = jt.net_d.apply({"params": d_params, "batch_stats": d_stats}, out,
                              train=False)
        return (jl1_loss(out, gt_usm)
                + jperceptual_loss(jt.vgg.apply(jt.vgg_variables, out),
                                   jt.vgg.apply(jt.vgg_variables, gt_usm))
                + jgan_loss(fake, True, "vanilla", False, loss_weight=0.1)), out

    def d_loss(dp, out):
        real, m = jt.net_d.apply({"params": dp, "batch_stats": d_stats},
                                 jnp.asarray(gt), train=True, mutable=["batch_stats"])
        fake, _ = jt.net_d.apply({"params": dp, "batch_stats": m["batch_stats"]},
                                 out, train=True, mutable=["batch_stats"])
        return (jgan_loss(real, True, "vanilla", True)
                + jgan_loss(fake, False, "vanilla", True))

    @jax.jit
    def both(gp, dp):
        (_, out), gg = jax.value_and_grad(g_loss, has_aux=True)(gp)
        return gg, jax.grad(d_loss)(dp, out)

    gg, dg = both(js.g_params, d_params)
    g_sd = convert.rrdbnet_state_dict({"params": jax.device_get(gg)}, NB)
    d_sd = convert.unet_discriminator_sn_state_dict({"params": jax.device_get(dg)})
    return ({k: v.numpy() for k, v in g_sd.items()},
            {k: v.numpy() for k, v in d_sd.items()})


def _adam_state(opt):
    from flax import serialization

    return jax.device_get(serialization.to_state_dict(opt))


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of both; after step 1 the JAX state (Adam's moments
    included) also goes across to a fresh port state, which takes step 2."""
    jt, js, pt, ps = _pair()
    g0 = jax.device_get(js.g_params)
    batches = _batches(3)
    grads = _jax_grads(jt, js, *batches[0])
    jstep, pstep = jt.make_step(), pt.make_step()
    rows = []
    for i, (lq, gt) in enumerate(batches):
        if i == 1:
            g, ema, d, gm, dm = convert.gan_state_from_jax(
                jax.device_get(js.g_params), jax.device_get(js.g_ema),
                jax.device_get(js.d_vars), _adam_state(js.g_opt),
                _adam_state(js.d_opt), NB)
            carried = pt.init(0, (2, 8, 8, 3), g_state=g, d_state=d, device="cpu")
            carried.g_ema.load_state_dict(ema)
            load_adam_moments(carried.opt_g, carried.net_g, gm)
            load_adam_moments(carried.opt_d, carried.net_d, dm)
            carried.step = gm["step"]
            carried_m = (gm["step"], dm["step"], pstep(carried, lq, gt))
        js, jm = jstep(js, jnp.asarray(lq), jnp.asarray(gt))
        pm = pstep(ps, lq, gt)
        if i == 0:
            port_grads = tuple({n: p.grad.numpy().copy() for n, p in m.named_parameters()}
                               for m in (ps.net_g, ps.net_d))
        g, ema, d, _, _ = convert.gan_state_from_jax(
            jax.device_get(js.g_params), jax.device_get(js.g_ema),
            jax.device_get(js.d_vars), num_block=NB)
        rows.append(dict(jm=jax.device_get(jm), pm=pm,
                         sigmas=_sigmas(jax.device_get(js.d_vars)),
                         want=({k: v.numpy() for k, v in g.items()},
                               {k: v.numpy() for k, v in ema.items()},
                               {k: v.numpy() for k, v in d.items()}),
                         got=(_sd(ps.net_g), _sd(ps.g_ema), _sd(ps.net_d)),
                         sn={f"conv{i}": getattr(ps.net_d, f"conv{i}").sigma.item()
                             for i in range(1, 9)}))
        if i == 1:
            rows[-1]["carried"] = carried_m + (_sd(carried.net_g), _sd(carried.net_d))
    return dict(grads=grads, port_grads=port_grads, rows=rows, g0=g0,
                final=(jt, js, pt, ps))


def test_metrics_and_spectral_norms_match_over_three_steps(three_steps):
    rows, ps = three_steps["rows"], three_steps["final"][3]
    for i, r in enumerate(rows):
        _check_metrics(r["pm"], r["jm"], f"step {i + 1}")
        g_want, ema_want, d_want = r["want"]
        for c in range(1, 9):
            np.testing.assert_allclose(r["got"][2][f"conv{c}.weight_u"],
                                       d_want[f"conv{c}.weight_u"], atol=SN_TOL,
                                       rtol=0, err_msg=f"step {i + 1} conv{c} u")
            assert r["sn"][f"conv{c}"] == pytest.approx(r["sigmas"][f"conv{c}"],
                                                        abs=SN_TOL, rel=SN_TOL)
        for k, v in ema_want.items():
            np.testing.assert_allclose(r["got"][1][k], v, atol=EMA_TOL, rtol=0,
                                       err_msg=f"step {i + 1} ema {k}")
    assert ps.step == 3


def test_step_one_gradients_match_jax(three_steps):
    (jg, jd), (pg, pd) = three_steps["grads"], three_steps["port_grads"]
    for want, got in ((jg, pg), (jd, pd)):
        assert set(want) == set(got)
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= GRAD_TOL * np.abs(w).max(), k


def test_parameters_over_three_steps_by_their_gradients(three_steps):
    (jg, jd), rows = three_steps["grads"], three_steps["rows"]
    grads = {**{("g", k): v for k, v in jg.items()}, **{("d", k): v for k, v in jd.items()}}
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    clear = {k: np.abs(g) > 2 * F32_GRAD_NOISE * np.abs(g).max() + floor
             for k, g in grads.items()}
    total = sum(g.size for g in grads.values())
    for i, r in enumerate(rows):
        thresh = 1e-4 if i == 0 else 2.5e-4
        beyond = faults = 0
        for (net, k), c in clear.items():
            got = r["got"][0 if net == "g" else 2][k]
            want = r["want"][0 if net == "g" else 2][k]
            d = np.abs(got.astype(np.float64) - want) > thresh
            beyond += int(d.sum())
            faults += int((d & c).sum())
        print(f"step {i + 1}: {beyond / total:.4%} of G and D params beyond "
              f"{thresh:g} (bound {SHARE_BOUND:.2%})")
        assert faults == 0, f"step {i + 1}: {faults} clear-gradient elements differ"
        assert beyond / total <= SHARE_BOUND


def test_adam_moments_carried_from_jax_take_the_same_step(three_steps):
    """A port state made from the JAX state after step 1 (weights, EMA,
    spectral norms and both Adams' moments and counts) takes step 2 as the
    JAX step does."""
    row = three_steps["rows"][1]
    g_step, d_step, m, g_got, d_got = row["carried"]
    assert g_step == d_step == 1
    _check_metrics(m, row["jm"], "carried step 2")
    for got, want in ((g_got, row["want"][0]), (d_got, row["want"][2])):
        for k, w in want.items():
            if not k.endswith("weight_v"):  # the converter's v is n(W^T u)
                assert np.abs(got[k] - w).max() <= 2.5e-4, k


def test_usm_switches_match_jax():
    """Every switch flipped from the recipe's (l1 and perceptual on USM
    ground truths, GAN on the plain one)."""
    jt, js, pt, ps = _pair(l1_gt_usm=False, percep_gt_usm=False, gan_gt_usm=True)
    (lq, gt), = _batches(1, seed=1)
    _, jm = jt.make_step()(js, jnp.asarray(lq), jnp.asarray(gt))
    _check_metrics(pt.make_step()(ps, lq, gt), jax.device_get(jm), "usm switches")


def test_warmup_makes_the_first_update_zero():
    jt, js, pt, ps = _pair(warmup_iter=2, perceptual=False)
    init = (_sd(ps.net_g), _sd(ps.net_d))
    jstep, pstep = jt.make_step(), pt.make_step()
    for i, (lq, gt) in enumerate(_batches(2, seed=2)):
        js, jm = jstep(js, jnp.asarray(lq), jnp.asarray(gt))
        _check_metrics(pstep(ps, lq, gt), jax.device_get(jm), f"warm-up step {i + 1}")
        if i == 0:
            for before, net in zip(init, (ps.net_g, ps.net_d)):
                for k, v in net.named_parameters():
                    np.testing.assert_array_equal(v.detach().numpy(), before[k])
    assert pt.schedule(0) == 0.0 and pt.schedule(1) == pytest.approx(5e-5)
    moved = [k for k, v in ps.net_g.named_parameters()
             if not np.array_equal(v.detach().numpy(), init[0][k])]
    assert moved  # the second update is not zero


def test_one_channel_adaptation_matches_jax(three_steps):
    g3 = three_steps["g0"]
    want = jax_adapt_1ch(g3)
    got = adapt_weights_to_1ch(convert.rrdbnet_state_dict({"params": g3}, NB))
    for k, v in convert.rrdbnet_state_dict({"params": jax.device_get(want)}, NB).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-7, rtol=0, err_msg=k)
    assert got["conv_first.weight"].shape[1] == got["conv_last.weight"].shape[0] == 1
    jt, js, pt, ps = _pair(ch=1, g_params=want, perceptual=False)
    (lq, gt), = _batches(1, ch=1, seed=3)
    _, jm = jt.make_step()(js, jnp.asarray(lq), jnp.asarray(gt))
    _check_metrics(pt.make_step()(ps, lq, gt), jax.device_get(jm), "1 channel")


def test_ema_apply_fn_matches_jax(three_steps):
    jt, js, pt, ps = three_steps["final"]
    (lq, _), = _batches(1, seed=4)
    apply_j, apply_p = jt.ema_apply_fn(), pt.ema_apply_fn()
    for features_only in (False, True):
        want = np.asarray(apply_j(js, jnp.asarray(lq), features_only=features_only))
        got = apply_p(ps, lq, features_only=features_only).numpy()
        assert got.shape == want.shape == ((2, 32, 32, NF) if features_only
                                           else (2, 32, 32, 3))
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_bfloat16_step_keeps_a_float32_state():
    (lq, gt), = _batches(1, seed=5)
    bf = RealESRGANTrainer(dtype=torch.bfloat16, **_kw(perceptual=False))
    state = bf.init(0, (2, 8, 8, 3), device="cpu")
    m = bf.make_step()(state, lq, gt)
    assert all(torch.isfinite(v) for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.net_d.parameters())
    assert state.net_d.conv1.sigma.dtype == torch.float32
    assert bf.ema_apply_fn()(state, lq).dtype == torch.float32


def test_cudnn_autotuning_holds_only_inside_a_card_step():
    """The step's autotuning scope: on a card it turns cuDNN's benchmark on
    and restores the flag after the block, an exception included; on the
    CPU it leaves the flag alone."""
    before = torch.backends.cudnn.benchmark
    with RealESRGANTrainer._autotuned(torch.device("cuda")):
        assert torch.backends.cudnn.benchmark
    assert torch.backends.cudnn.benchmark == before
    with pytest.raises(RuntimeError, match="inside"):
        with RealESRGANTrainer._autotuned(torch.device("cuda")):
            raise RuntimeError("inside")
    assert torch.backends.cudnn.benchmark == before
    with RealESRGANTrainer._autotuned(torch.device("cpu")):
        assert torch.backends.cudnn.benchmark == before
