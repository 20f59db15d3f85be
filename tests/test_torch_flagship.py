"""The port's flagship height step against the JAX package's.

The tiny flagship of ``__graft_entry__._flagship(tiny=True)`` (RRDBNet-2 of
width 16, ``efficientnet-test``) is carried into ``srbh_tpu_torch`` with the
port's converters; BatchNorm running stats are random and non-trivial so the
eval-mode BN is really tested, and the height head's bias is lifted so that
heights survive the clamp at 0. Float outputs: tolerance 1e-4 absolute and
relative (float32 sums taken in another order). ``make_city_step`` in
float32 on both sides: quantised outputs at most 1 LSB apart on at most
0.1 % of pixels (a value on a rounding edge may round either way).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from srbh_tpu.predict.predictor import make_city_step as jax_city_step
from srbh_tpu_torch import convert, entry
from srbh_tpu_torch.models.efficientnet import Conv2dSame, same_padding
from srbh_tpu_torch.predict.predictor import make_city_step
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-4
TILE, BATCH = 32, 2


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in tree.items()}


@pytest.fixture(scope="module")
def pair():
    jm, jsr, variables, sr_params, _ = graft._flagship(tile=TILE, batch=BATCH,
                                                       tiny=True)
    rng = np.random.default_rng(0)
    params = jax.device_get(variables["params"])
    params["reg"]["conv_last"]["bias"] = np.full((1,), 2.0, np.float32)
    variables = {"params": params, "batch_stats": _random_stats(
        jax.device_get(variables["batch_stats"]), rng)}
    sr_params = jax.device_get(sr_params)
    tm, tsr, _ = entry.flagship(tiny=True, device="cpu")
    tm.load_state_dict(convert.height_model_state_dict(
        variables, "efficientnet-test", isaggre=True), strict=True)
    tsr.load_state_dict(convert.rrdbnet_state_dict(sr_params, 2), strict=True)
    img = rng.uniform(0, 1, (BATCH, TILE, TILE, 8)).astype(np.float32)
    fea = jax.jit(functools.partial(jsr.apply, features_only=True))(
        sr_params, jnp.asarray(img)[..., :3])
    return dict(jm=jm, jsr=jsr, variables=variables, sr_params=sr_params,
                tm=tm, tsr=tsr, img=img, fea=np.asarray(fea))


def jax_heads(pair, **kw):
    """The JAX height model's outputs on the fixture's image and features."""
    fn = jax.jit(functools.partial(pair["jm"].apply, train=False, **kw))
    return fn(pair["variables"], jnp.asarray(pair["img"]),
              jnp.asarray(pair["fea"]))


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_sr_features_match(pair):
    with torch.no_grad():
        got = pair["tsr"](nchw(pair["img"])[:, :3], features_only=True)
    assert got.shape == (BATCH, 16, 4 * TILE, 4 * TILE)
    np.testing.assert_allclose(nhwc(got), pair["fea"], atol=TOL, rtol=TOL)


def test_sr_image_path_matches(pair):
    want = jax.jit(pair["jsr"].apply)(pair["sr_params"],
                                      jnp.asarray(pair["img"])[..., :3])
    with torch.no_grad():
        got = pair["tsr"](nchw(pair["img"])[:, :3])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_build,with_aggre", [(True, None),
                                                   (False, None),
                                                   (False, False)])
def test_height_model_outputs_match(pair, with_build, with_aggre):
    want = jax_heads(pair, with_build=with_build, with_aggre=with_aggre)
    with torch.no_grad():
        got = pair["tm"](nchw(pair["img"]), nchw(pair["fea"]),
                         with_build=with_build, with_aggre=with_aggre)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert nhwc(g).shape == w.shape
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=TOL, rtol=TOL)


def test_entry_forward_matches(pair):
    """``entry.forward`` against the body of the JAX ``entry`` forward."""
    h, b, a = jax_heads(pair)
    got = entry.forward(pair["tm"], pair["tsr"], torch.from_numpy(pair["img"]))
    for g, w in zip(got, (h[..., 0], b, a[..., 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_city_step_matches(pair):
    jh, jb = jax_city_step(pair["jm"], pair["jsr"], dtype=jnp.float32)(
        pair["variables"], pair["sr_params"], jnp.asarray(pair["img"]))
    th, tb = make_city_step(pair["tm"], pair["tsr"], dtype=torch.float32,
                            device="cpu")(pair["img"])
    assert th.dtype == torch.uint16 and tuple(th.shape) == (BATCH, 128, 128)
    assert tb.dtype == torch.uint8 and tuple(tb.shape) == (BATCH, 128, 128, 7)
    jh, jb = np.asarray(jh).astype(np.int64), np.asarray(jb).astype(np.int64)
    assert jh.max() > 0  # heights survive the clamp
    for got, want in ((th, jh), (tb, jb)):
        diff = np.abs(got.to(torch.int64).numpy() - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3


def test_city_step_bf16_runs_on_cpu(pair):
    th, tb = make_city_step(pair["tm"], pair["tsr"], device="cpu")(pair["img"])
    assert th.dtype == torch.uint16 and tb.dtype == torch.uint8
    sums = tb.to(torch.int64).sum(-1)
    assert (sums - 255).abs().max().item() <= 4  # 7 classes, each +-0.5


@pytest.mark.parametrize("size,kernel,stride,want", [(64, 3, 2, (0, 1)),
                                                     (16, 5, 2, (1, 2)),
                                                     (32, 5, 1, (2, 2)),
                                                     (4, 3, 2, (0, 1))])
def test_tf_same_padding(size, kernel, stride, want):
    """flax ``padding="SAME"`` pads the odd pixel after; torch's symmetric
    ``k//2`` would be wrong at stride 2."""
    import flax.linen as nn

    assert same_padding(size, kernel, stride) == want
    rng = np.random.default_rng(size + kernel)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 4)).astype(np.float32)
    conv = nn.Conv(4, (kernel, kernel), strides=(stride, stride),
                   padding="SAME", use_bias=False)
    want_y = conv.apply({"params": {"kernel": w}}, jnp.asarray(x))
    tconv = Conv2dSame(3, 4, kernel, stride)
    tconv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        got = tconv(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
