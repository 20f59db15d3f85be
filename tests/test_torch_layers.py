"""The port's ops and shared layers against the JAX package's.

Layout ops are exact (reshape / permute / repeat). Layers carry the JAX
weights across and agree within 1e-5 (float32, small convolutions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.models import layers as jlayers
from srbh_tpu.ops import resize as jresize
from srbh_tpu.ops import shuffle as jshuffle
from srbh_tpu_torch import convert
from srbh_tpu_torch.models import layers as tlayers
from srbh_tpu_torch.ops import resize as tresize
from srbh_tpu_torch.ops import shuffle as tshuffle

TOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_pixel_shuffle_matches_jax(r):
    x = rand(2, 5, 3, 4 * r * r)
    want = np.asarray(jshuffle.pixel_shuffle(jnp.asarray(x), r))
    got = tshuffle.pixel_shuffle(nchw(x), r)
    np.testing.assert_array_equal(nhwc(got), want)
    # torch's own PixelShuffle has the same channel order
    torch.testing.assert_close(got, torch.nn.functional.pixel_shuffle(nchw(x), r),
                               rtol=0, atol=0)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_unshuffle_matches_jax(r):
    x = rand(2, 4 * r, 2 * r, 3)
    want = np.asarray(jshuffle.pixel_unshuffle(jnp.asarray(x), r))
    got = tshuffle.pixel_unshuffle(nchw(x), r)
    np.testing.assert_array_equal(nhwc(got), want)
    np.testing.assert_array_equal(nhwc(tshuffle.pixel_shuffle(got, r)), x)


def test_shuffle_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tshuffle.pixel_shuffle(torch.zeros(1, 6, 2, 2), 2)
    with pytest.raises(ValueError):
        tshuffle.pixel_unshuffle(torch.zeros(1, 3, 5, 4), 2)


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_nearest_matches_jax(scale):
    x = rand(2, 3, 5, 4)
    want = np.asarray(jresize.upsample_nearest(jnp.asarray(x), scale))
    np.testing.assert_array_equal(nhwc(tresize.upsample_nearest(nchw(x), scale)),
                                  want)


@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.99, 1e-3)])
def test_batchnorm_train_update_matches_jax(momentum, eps):
    """Flax momentum m is torch momentum 1 - m; both keep the unbiased
    (Bessel-corrected) batch variance in the running average."""
    x = rand(4, 5, 6, 3, seed=1) * 2 + 1
    jbn = jlayers.TorchBatchNorm(use_running_average=False, momentum=momentum,
                                 epsilon=eps)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, upd = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tbn = tlayers.TorchBatchNorm(3, momentum=momentum, eps=eps).train()
    got = tbn(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL, rtol=TOL)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]),
                               atol=TOL, rtol=TOL)


def _random_bn_stats(tree, rng):
    return {k: _random_bn_stats(v, rng) if isinstance(v, dict) else
            rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("cin,planes,stride", [(8, 8, 1), (8, 4, 1),
                                               (4, 8, 2)])
def test_basic_block_matches_jax(cin, planes, stride):
    x = rand(2, 8, 8, cin, seed=2)
    jb = jlayers.BasicBlock(planes, stride)
    v = jax.device_get(jb.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v = {"params": v["params"],
         "batch_stats": _random_bn_stats(v["batch_stats"],
                                         np.random.default_rng(3))}
    want = jb.apply(v, jnp.asarray(x))
    sd = {}
    convert._basic_block(sd, "b", v["params"], v["batch_stats"])
    tb = tlayers.BasicBlock(cin, planes, stride).eval()
    tb.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tb(nchw(x))), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_conv_bn_act_matches_jax():
    x = rand(2, 6, 6, 5, seed=4)
    jm = jlayers.ConvBNAct(7)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    stats = _random_bn_stats(v["batch_stats"], np.random.default_rng(5))
    want = jm.apply({"params": v["params"], "batch_stats": stats},
                    jnp.asarray(x))
    sd = {}
    convert._conv(sd, "0", v["params"]["conv"])
    convert._bn(sd, "1", v["params"]["bn"], stats["bn"])
    tm = tlayers.ConvBNAct(5, 7).eval()
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(want),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_pixel_shuffle_upsampler_matches_jax(scale):
    x = rand(1, 5, 4, 6, seed=6)
    jm = jlayers.PixelShuffleUpsampler(scale, 6)
    v = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    want = jm.apply(v, jnp.asarray(x))
    sd = {}
    for k in range(len(v["params"])):
        convert._conv(sd, str(2 * k), v["params"][f"conv_{k}"])
    tm = tlayers.PixelShuffleUpsampler(scale, 6)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_init_weights_is_seeded():
    def make(seed):
        m = tlayers.BasicBlock(4, 8)
        return tlayers.init_weights(m, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
        if k.endswith("conv1.weight"):
            assert not torch.equal(x, z)
            assert x.abs().max().item() <= (4 * 9) ** -0.5
