"""``remat``: the port's recomputed fusion stack and RRDBs against the plain
port and against the JAX package's ``remat`` (``tests/test_remat.py``).

* ``SRRegressClsFeature(remat=True)`` in training mode against the plain
  model on the same weights: loss within 1e-6 relative, every gradient
  within rtol 1e-5, atol 1e-7, and BatchNorm buffers equal, each
  ``num_batches_tracked`` 1 (the recompute's second training forward
  updates nothing); the eval forward within 1e-6; one state dict.
* The same model against the JAX ``remat=True`` model on the JAX
  variables (``convert.py``), BatchNorm on its running statistics: the
  loss over the outputs within 1e-5 relative and the gradients within 1e-4
  x each tensor's max |g| (as ``tests/test_torch_train_step.py`` holds the
  plain model; training mode's parameter gradients are ill-conditioned in
  float32 there).
* ``RRDBNet(remat=True)`` against the plain port (the JAX test's bounds)
  and against JAX ``remat=True`` (gradients within 1e-4 x max |g|).
* The height train step (``make_train_step`` over ``build_models`` with
  ``TrainConfig.remat``) and the GAN step (``RealESRGANTrainer(remat=True)``)
  against the plain port steps: metrics within 1e-6 relative, the updated
  parameters and buffers equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbh_tpu.models import RRDBNet as JaxRRDBNet
from srbh_tpu.models import SRRegressClsFeature as JaxModel
from srbh_tpu.train.convert import convert_rrdbnet
from srbh_tpu_torch import convert
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step
from srbh_tpu_torch.train.trainer import build_models
from srbh_tpu_torch.tools.train_bench import host_batches, train_config
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

ENC, DEC = "efficientnet-test", (32, 24, 16, 12, 8)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-7


def _jax_model(remat):
    return JaxModel(encoder_name=ENC, super_mid=8, isaggre=True, chans_build=7,
                    decoder_channels=DEC, drop_connect_rate=0.0, remat=remat)


def _port_model(variables, remat):
    m = SRRegressClsFeature(ENC, super_mid=8, isaggre=True, chans_build=7,
                            sr_chans=8, decoder_channels=DEC,
                            drop_connect_rate=0.0, remat=remat)
    m.load_state_dict(convert.height_model_state_dict(variables, ENC, True))
    return m


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 32, 32, 8)).astype(np.float32)
    fea = rng.normal(size=(2, 128, 128, 8)).astype(np.float32)
    target = rng.normal(size=(2, 128, 128)).astype(np.float32)
    model = init_weights(SRRegressClsFeature(
        ENC, super_mid=8, isaggre=True, chans_build=7, sr_chans=8,
        decoder_channels=DEC), torch.Generator().manual_seed(0))
    variables = convert.height_model_variables(model.state_dict(), True, ENC)
    return x, fea, target, variables


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_step(model, setup, train=True):
    """(loss, grads by name, buffers by name) of the JAX test's loss."""
    x, fea, target, _ = setup
    model.train(train)
    model.zero_grad()
    h, b, a = model(_nchw(x), _nchw(fea))
    loss = (((h[:, 0] - torch.from_numpy(target)) ** 2).mean()
            + (b ** 2).mean() + (a ** 2).mean())
    loss.backward()
    return (loss.item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: v.clone() for n, v in model.named_buffers()})


def test_remat_step_equals_the_plain_step(setup):
    plain, remat = (_port_model(setup[3], r) for r in (False, True))
    assert plain.state_dict().keys() == remat.state_dict().keys()
    loss_p, grads_p, bufs_p = _port_step(plain, setup)
    loss_r, grads_r, bufs_r = _port_step(remat, setup)
    assert loss_r == pytest.approx(loss_p, rel=LOSS_RTOL)
    for name, g in grads_p.items():
        torch.testing.assert_close(grads_r[name], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=name)
    for name, v in bufs_p.items():
        assert torch.equal(bufs_r[name], v), name
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name
    fusion = [n for n in bufs_r if n.startswith(("hrfeat.", "reg.", "seg."))
              and n.endswith("num_batches_tracked")]
    assert fusion and all(int(bufs_r[n]) == 1 for n in fusion)


def test_remat_eval_forward_equals_the_plain_one(setup):
    x, fea = _nchw(setup[0]), _nchw(setup[1])
    plain, remat = (_port_model(setup[3], r).eval() for r in (False, True))
    for a, b in zip(plain(x, fea), remat(x, fea)):  # grad on: remat runs
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def _jax_remat_loss(setup):
    """(loss, gradients under the port's names) of the JAX remat model with
    BatchNorm on its running statistics."""
    x, fea, target, variables = setup
    m = _jax_model(True)

    def f(params):
        h, b, a = m.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), jnp.asarray(fea), train=False)
        return (jnp.mean((h[..., 0] - target) ** 2) + jnp.mean(b ** 2)
                + jnp.mean(a ** 2))

    loss, grads = jax.jit(jax.value_and_grad(f))(variables["params"])
    sd = convert.height_model_state_dict(
        {"params": jax.device_get(grads),
         "batch_stats": variables["batch_stats"]}, ENC, True)
    return float(loss), {k: v for k, v in sd.items()
                         if k.rsplit(".", 1)[-1] in ("weight", "bias")}


def test_remat_matches_the_jax_remat_model(setup):
    """BatchNorm on its running statistics: the loss over the eval outputs
    and every parameter's gradient."""
    loss_j, grads_j = _jax_remat_loss(setup)
    loss, grads, _ = _port_step(_port_model(setup[3], True), setup,
                                train=False)
    assert loss == pytest.approx(loss_j, rel=1e-5)
    assert set(grads_j) <= set(grads)
    for name, g in grads_j.items():
        g = g.numpy()
        assert np.abs(grads[name].numpy() - g).max() <= 1e-4 * np.abs(g).max(), name


def test_rrdbnet_remat_equals_plain_and_jax():
    rng = np.random.default_rng(37)
    x = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    kw = dict(num_feat=16, num_block=2, num_grow_ch=8)
    seeded = init_weights(RRDBNet(**kw), torch.Generator().manual_seed(0))
    variables = convert_rrdbnet(
        {k: v.numpy() for k, v in seeded.state_dict().items()}, 2)
    jrem = JaxRRDBNet(**kw, remat=True)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(jrem.apply({"params": p}, jnp.asarray(x)) ** 2)))(
            variables["params"])
    want = convert.rrdbnet_state_dict({"params": jax.device_get(grads_j)}, 2)
    runs = []
    for remat in (False, True):
        m = RRDBNet(**kw, remat=remat)
        m.load_state_dict(seeded.state_dict())
        loss = (m(_nchw(x)) ** 2).mean()
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in m.named_parameters()}))
    (loss_p, grads_p), (loss_r, grads_r) = runs
    assert loss_r == pytest.approx(loss_p, rel=LOSS_RTOL)
    assert loss_r == pytest.approx(float(loss_j), rel=1e-5)
    for name, g in grads_p.items():
        torch.testing.assert_close(grads_r[name], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=name)
        w = want[name].numpy()
        assert np.abs(grads_r[name].numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_height_train_step_with_remat_equals_the_plain_step():
    """The trainer's step (``build_models`` honours ``TrainConfig.remat``)."""
    batch = host_batches(1, 2, 32, 5, "cpu")[0]
    runs = []
    for remat in (False, True):
        cfg = train_config(True, seed=1337, remat=remat)
        model, sr = build_models(cfg)
        assert model.remat is remat
        state = TrainState(model, sr_model=sr)
        step = make_train_step(model, sr, seed=cfg.seed, device="cpu")
        metrics = step(state, batch, 1e-3)
        runs.append((metrics, model.state_dict()))
    (mp, sdp), (mr, sdr) = runs
    for k in ("loss", "rmse"):
        assert mr[k].item() == pytest.approx(mp[k].item(), rel=LOSS_RTOL)
    torch.testing.assert_close(mr["log_vars"], mp["log_vars"], rtol=0, atol=0)
    for name, v in sdp.items():
        assert torch.equal(sdr[name], v), name
        if name.endswith("num_batches_tracked"):
            assert int(sdr[name]) == 1, name


def test_gan_step_with_remat_equals_the_plain_step():
    rng = np.random.default_rng(3)
    lq = torch.as_tensor(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    gt = torch.as_tensor(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    runs = []
    for remat in (False, True):
        trainer = RealESRGANTrainer(num_block=2, num_feat=8, num_grow_ch=4,
                                    disc_feat=8, remat=remat)
        state = trainer.init(0, (2, 8, 8, 3), device="cpu")
        assert state.net_g.remat is remat
        metrics = trainer.make_step()(state, lq, gt)
        runs.append((metrics, copy.deepcopy(state.net_g.state_dict()),
                     copy.deepcopy(state.net_d.state_dict())))
    (mp, gp, dp), (mr, gr, dr) = runs
    assert set(mp) == set(mr)
    for k, v in mp.items():
        assert mr[k].item() == pytest.approx(v.item(), rel=LOSS_RTOL), k
    for want, got in ((gp, gr), (dp, dr)):
        for name, v in want.items():
            assert torch.equal(got[name], v), name
