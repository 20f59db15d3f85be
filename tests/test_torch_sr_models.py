"""The port's VGG19 features and GAN discriminators against the JAX package's.

Weights come from the JAX modules' seeded init through the port's
converters (``convert.vgg19_state_dict``,
``unet_discriminator_sn_state_dict``, ``vgg_style_discriminator_state_dict``).

* VGG19 features at torchvision indices 2, 7, 16, 25 and 34: within 1e-5
  relative to each feature's largest magnitude.
* UNetDiscriminatorSN (num_feat 8): logits with ``train=False`` and
  ``train=True``, and the stored ``u`` and ``sigma`` after each, within
  1e-5: ``train=False`` iterates the power method but stores nothing,
  ``train=True`` stores.
* VGGStyleDiscriminator at 128: logits in both modes and the BatchNorm
  statistics it updates, within 1e-5.
* The converters round-trip through ``srbh_tpu.train.convert.
  convert_unet_discriminator_sn`` and ``srbh_tpu.models.vgg.
  load_torchvision_vgg19``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.models.discriminators import UNetDiscriminatorSN as JaxUNet
from srbh_tpu.models.discriminators import VGGStyleDiscriminator as JaxVGGStyle
from srbh_tpu.models.vgg import VGG19Features as JaxVGG
from srbh_tpu.models.vgg import load_torchvision_vgg19 as jax_load_tv_vgg19
from srbh_tpu.train.convert import convert_unet_discriminator_sn
from srbh_tpu_torch import convert
from srbh_tpu_torch.models.discriminators import (
    UNetDiscriminatorSN,
    VGGStyleDiscriminator,
)
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.vgg import VGG19Features, load_torchvision_vgg19
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel_close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def test_vgg19_features_match_jax():
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JaxVGG()
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    model = VGG19Features()
    model.load_state_dict(convert.vgg19_state_dict(variables))
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert _nhwc(g).shape == w.shape
        _rel_close(_nhwc(g), np.asarray(w))


def _unet_pair(seed=0):
    jm = JaxUNet(num_feat=8)
    x = jnp.zeros((1, 32, 32, 3))
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed), x))
    model = UNetDiscriminatorSN(num_feat=8)
    model.load_state_dict(convert.unet_discriminator_sn_state_dict(variables))
    return jm, variables, model


def _sn_state(model):
    return {f"conv{i}": (getattr(model, f"conv{i}").weight_u.numpy().copy(),
                         getattr(model, f"conv{i}").sigma.item())
            for i in range(1, 9)}


def _jax_sn_state(stats):
    return {f"conv{i}": (np.asarray(stats[f"conv{i}_sn"][f"conv{i}/kernel/u"])[0],
                         float(stats[f"conv{i}_sn"][f"conv{i}/kernel/sigma"]))
            for i in range(1, 9)}


def test_unet_discriminator_sn_matches_jax_in_both_modes():
    jm, variables, model = _unet_pair()
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    stats = variables["batch_stats"]
    u0 = _sn_state(model)
    # train=False: the power iteration runs (sigma differs from the stored
    # one) but nothing is stored
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    want = apply({"params": variables["params"], "batch_stats": stats},
                 jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(_nchw(x), train=False)
    _rel_close(_nhwc(got), np.asarray(want))
    for k, (u, sigma) in _sn_state(model).items():
        np.testing.assert_array_equal(u, u0[k][0])
    # train=True, twice (as the D step): each stores, the second starts from
    # the first's u
    for _ in range(2):
        want, mut = apply({"params": variables["params"], "batch_stats": stats},
                          jnp.asarray(x), train=True, mutable=("batch_stats",))
        stats = jax.device_get(mut["batch_stats"])
        with torch.no_grad():
            got = model(_nchw(x), train=True)
        _rel_close(_nhwc(got), np.asarray(want))
        jstate = _jax_sn_state(stats)
        for k, (u, sigma) in _sn_state(model).items():
            np.testing.assert_allclose(u, jstate[k][0], atol=1e-5, rtol=0, err_msg=k)
            assert sigma == pytest.approx(jstate[k][1], rel=1e-5, abs=1e-5), k
            assert not np.array_equal(u, u0[k][0]), k


def test_unet_discriminator_sn_iterates_in_eval_unlike_torch_spectral_norm():
    """torch.nn.utils.spectral_norm skips the iteration in eval mode; the
    port's norm iterates from the stored u on every call, as flax does."""
    gen = torch.Generator().manual_seed(3)
    conv = init_weights(UNetDiscriminatorSN(num_feat=8), gen).conv2
    conv.reset_from(gen)
    w = conv.weight_orig.detach().reshape(conv.weight_orig.shape[0], -1)
    u = conv.weight_u
    v = w.t() @ u
    v = v / torch.sqrt((v * v).sum() + 1e-12)
    u2 = w @ v
    u2 = u2 / torch.sqrt((u2 * u2).sum() + 1e-12)
    with torch.no_grad():
        got = conv.normalized_weight(update_stats=False)
    torch.testing.assert_close(got, conv.weight_orig / (u2 @ (w @ v)),
                               rtol=1e-6, atol=0)
    assert not torch.allclose(got, conv.weight_orig / (u @ (w @ v)), rtol=1e-6,
                              atol=0)


def test_vgg_style_discriminator_matches_jax_at_128():
    jm = JaxVGGStyle(num_feat=4, input_size=128)
    x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    model = VGGStyleDiscriminator(num_feat=4, input_size=128)
    model.load_state_dict(convert.vgg_style_discriminator_state_dict(variables, 128))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(_nchw(x), train=False)
    _rel_close(got.numpy(), np.asarray(want))
    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model(_nchw(x), train=True)
    _rel_close(got.numpy(), np.asarray(want))
    stats = convert.vgg_style_discriminator_state_dict(
        {"params": variables["params"], "batch_stats": jax.device_get(
            mut["batch_stats"])}, 128)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="128"):
        model(torch.zeros(1, 3, 64, 64))


def test_converters_round_trip_through_the_jax_converters():
    gen = torch.Generator().manual_seed(4)
    model = init_weights(UNetDiscriminatorSN(num_feat=8), gen)
    for conv in model.sn_convs():
        conv.reset_from(gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert.unet_discriminator_sn_state_dict(convert_unet_discriminator_sn(sd))
    assert set(back) == set(sd)
    for k, v in back.items():
        if not k.endswith("weight_v"):  # flax keeps no v: n(W^T u) comes back
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    vgg = init_weights(VGG19Features(), gen)
    tv = {k: v.numpy() for k, v in vgg.state_dict().items()}
    tv["classifier.0.weight"] = np.zeros((4, 4), np.float32)  # torchvision's head
    back = convert.vgg19_state_dict(jax_load_tv_vgg19(tv))
    assert set(back) == set(vgg.state_dict())
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), tv[k], err_msg=k)
    fresh = VGG19Features()
    load_torchvision_vgg19(fresh, tv)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tv[k], err_msg=k)
