"""The space-to-depth compute mode and the grouped dual head against the
port's literal forms and the JAX package's (``tests/test_s2d.py``,
``tests/test_dual_head.py``).

* Every case of ``tests/test_s2d.py`` on the port, with its bounds: the
  primitives (pack / unpack, the parity-0 conv, a chain of parities, the
  1x1 conv, ``concat_perm``, ``ps_to_pack_perm``, ``tile_channel_param``)
  against the literal ``F.conv2d`` (1e-4 / 1e-5 / exact), and the packed
  ``BasicBlock`` (inference only), ``HRFeature``, ``HRFuseResidual`` and
  upsampler (``packed_output=True``) against the literal modules on the
  same weights (1e-5 / 1e-6). Each also against the JAX function on the
  same inputs (NHWC <-> NCHW): the packed layouts, the transformed kernel
  and the halo mask equal, the outputs within the same bounds.
* ``SRRegressClsFeature(compute_mode="packed")``: one state dict with the
  literal model; outputs within 1e-5 of the literal port and of JAX's
  packed model on the JAX variables; it raises in training mode.
* ``dual_head_apply`` within 1e-5 of ``model.reg`` / ``model.seg`` and of
  the JAX ``dual_head_apply``, from the model or its state dict.
* The city CLI with ``SRBH_PACKED=1``: the literal run's mosaics within the
  quantised-output limit (bfloat16: <= 1 LSB on <= 0.1 % of pixels,
  classes differing on <= 0.1 %).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srbh_tpu import models as jmodels
from srbh_tpu.models import hrfuse as jhrfuse
from srbh_tpu.models import layers as jlayers
from srbh_tpu.models.dual_head import dual_head_apply as jax_dual_head
from srbh_tpu.ops import s2d as js2d
from srbh_tpu.ops.shuffle import pixel_shuffle as jpixel_shuffle
from srbh_tpu_torch import convert
from srbh_tpu_torch.data.tiff import read_tiff
from srbh_tpu_torch.models.dual_head import dual_head_apply
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.hrfuse import HRFeature, HRFuseResidual
from srbh_tpu_torch.models.layers import (
    BasicBlock,
    PixelShuffleUpsampler,
    init_weights,
)
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.ops import s2d
from srbh_tpu_torch.ops.shuffle import pixel_shuffle
from srbh_tpu_torch.predict import __main__ as cli
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_predict import write_city
from test_torch_train_step import _random_stats


def _t(a):
    """NHWC numpy / JAX -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _w(a):
    """HWIO -> OIHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _lit(x, w, b=None):
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def test_pack_unpack_roundtrip():
    x = np.random.RandomState(0).randn(2, 8, 10, 3).astype(np.float32)
    xp = s2d.pack(_t(x))
    np.testing.assert_array_equal(s2d.unpack(xp).numpy(), _t(x).numpy())
    np.testing.assert_array_equal(_n(xp), np.asarray(js2d.pack(jnp.asarray(x))))


def test_pack_rejects_odd():
    with pytest.raises(ValueError):
        s2d.pack(torch.zeros(1, 3, 7, 8))


@pytest.mark.parametrize("ci,co", [(3, 5), (1, 1), (16, 16)])
def test_conv_parity0(ci, co):
    r = np.random.RandomState(ci * 17 + co)
    x = r.randn(2, 8, 10, ci).astype(np.float32)
    w = r.randn(3, 3, ci, co).astype(np.float32)
    b = r.randn(co).astype(np.float32)
    packed = s2d.conv3x3_packed(s2d.pack(_t(x)), 0, _w(w), torch.from_numpy(b))
    got = s2d.unpack(packed, parity=1)
    np.testing.assert_allclose(got.numpy(), _lit(_t(x), _w(w), torch.from_numpy(b)).numpy(),
                               atol=1e-4, rtol=1e-4)
    want = js2d.conv3x3_packed(js2d.pack(jnp.asarray(x)), 0, jnp.asarray(w),
                               jnp.asarray(b))
    np.testing.assert_allclose(_n(packed), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_transform_weight_and_halo_mask_equal_jax():
    w = np.random.RandomState(2).randn(3, 3, 4, 6).astype(np.float32)
    want = np.asarray(js2d.transform_weight(jnp.asarray(w)))
    np.testing.assert_array_equal(s2d.transform_weight(_w(w)).numpy(),
                                  want.transpose(3, 2, 0, 1))
    mask = np.asarray(js2d._halo_mask(5, 6, 3, jnp.float32))
    np.testing.assert_array_equal(s2d.halo_mask(5, 6, 3).numpy(),
                                  mask.transpose(2, 0, 1))
    with pytest.raises(ValueError):
        s2d.transform_weight(torch.zeros(2, 2, 1, 1))


def test_conv_chain_alternating_parity():
    """p0 -> p1 -> p0 -> p1: the halo masking reproduces the literal zero
    padding at every step."""
    r = np.random.RandomState(7)
    x = r.randn(2, 12, 8, 4).astype(np.float32)
    ws = [r.randn(3, 3, c1, c2).astype(np.float32)
          for c1, c2 in [(4, 6), (6, 5), (5, 3)]]
    ref, xp, jxp, parity = _t(x), s2d.pack(_t(x)), js2d.pack(jnp.asarray(x)), 0
    for w in ws:
        ref = _lit(ref, _w(w))
        xp = s2d.conv3x3_packed(xp, parity, _w(w))
        jxp = js2d.conv3x3_packed(jxp, parity, jnp.asarray(w))
        parity = 1 - parity
    np.testing.assert_allclose(s2d.unpack(xp, parity=parity).numpy(),
                               ref.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_n(xp), np.asarray(jxp), atol=1e-4, rtol=1e-4)


def test_conv1x1():
    r = np.random.RandomState(3)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    w = r.randn(1, 1, 3, 6).astype(np.float32)
    got = s2d.conv1x1_packed(s2d.pack(_t(x)), _w(w))
    np.testing.assert_allclose(s2d.unpack(got).numpy(), _lit(_t(x), _w(w)).numpy(),
                               atol=1e-5, rtol=1e-5)
    want = js2d.conv1x1_packed(js2d.pack(jnp.asarray(x)), jnp.asarray(w))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_concat_perm():
    """A conv over a concatenation of packs == over the pack of the
    concatenation."""
    r = np.random.RandomState(11)
    a = r.randn(2, 8, 10, 3).astype(np.float32)
    b = r.randn(2, 8, 10, 4).astype(np.float32)
    w = r.randn(3, 3, 7, 5).astype(np.float32)
    np.testing.assert_array_equal(s2d.concat_perm([3, 4]),
                                  np.asarray(js2d.concat_perm([3, 4])))
    cat_p = torch.cat([s2d.pack(_t(a)), s2d.pack(_t(b))], 1)
    got = s2d.unpack(s2d.conv3x3_packed(cat_p, 0, _w(w),
                                        kin_perm=s2d.concat_perm([3, 4])), parity=1)
    ref = _lit(torch.cat([_t(a), _t(b)], 1), _w(w))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError):
        s2d.conv3x3_packed(cat_p, 1, _w(w), kin_perm=s2d.concat_perm([3, 4]))


def test_ps_to_pack_perm():
    z = np.random.RandomState(5).randn(2, 4, 5, 16).astype(np.float32)
    perm = s2d.ps_to_pack_perm(4)
    np.testing.assert_array_equal(perm, np.asarray(js2d.ps_to_pack_perm(4)))
    np.testing.assert_array_equal(_t(z)[:, perm].numpy(),
                                  s2d.pack(pixel_shuffle(_t(z), 2)).numpy())
    np.testing.assert_array_equal(
        _n(s2d.pack(pixel_shuffle(_t(z), 2))),
        np.asarray(js2d.pack(jpixel_shuffle(jnp.asarray(z), 2))))


def test_tile_channel_param():
    got = s2d.tile_channel_param(torch.arange(3.0))
    assert got.shape == (12,)
    np.testing.assert_array_equal(got.numpy(), np.tile(np.arange(3.0), 4))


def _sd(fn, p, s=None):
    """A state dict from one of ``convert``'s private helpers, unprefixed."""
    sd = {}
    fn(sd, "m", p, s) if s is not None else fn(sd, "m", p)
    return {k[2:]: v for k, v in sd.items()}


def _init(module, *shapes, stats_seed=None):
    args = [jax.random.uniform(jax.random.PRNGKey(i), s)
            for i, s in enumerate(shapes)]
    v = jax.device_get(dict(jax.jit(module.init)(jax.random.PRNGKey(0), *args)))
    if stats_seed is not None and "batch_stats" in v:
        v["batch_stats"] = _random_stats(v["batch_stats"],
                                         np.random.default_rng(stats_seed))
    return v, [np.asarray(a) for a in args]


def test_basicblock_packed_matches():
    jm = jlayers.BasicBlock(16, packed=True)
    v, (x,) = _init(jlayers.BasicBlock(16), (2, 8, 8, 24), stats_seed=0)
    blk = BasicBlock(24, 16)
    blk.load_state_dict(_sd(convert._basic_block, v["params"], v["batch_stats"]))
    blk.eval()
    with torch.no_grad():
        ref = blk(_t(x))
        got = blk.forward_packed(s2d.pack(_t(x)))
    np.testing.assert_allclose(s2d.unpack(got).numpy(), ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        v, js2d.pack(jnp.asarray(x)))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_basicblock_packed_rejects_train():
    blk = BasicBlock(64, 16)
    with pytest.raises(ValueError):
        blk.forward_packed(torch.zeros(1, 256, 2, 2))
    with pytest.raises(ValueError):
        BasicBlock(16, 16, stride=2).eval().forward_packed(torch.zeros(1, 64, 2, 2))


def test_hrfeature_packed_matches():
    jm = jhrfuse.HRFeature(16, 16, packed=True)
    v, (x,) = _init(jhrfuse.HRFeature(16, 16), (2, 16, 16, 64), stats_seed=1)
    m = HRFeature(64, 16, 16)
    sd = {}
    convert._blocks(sd, "m", v["params"], v["batch_stats"], "block")
    m.load_state_dict({k[2:]: t for k, t in sd.items()})
    m.eval()
    with torch.no_grad():
        ref, got = m(_t(x)), m.forward_packed(_t(x))
    np.testing.assert_allclose(s2d.unpack(got).numpy(), ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(v, jnp.asarray(x))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_hrfuse_residual_packed_matches():
    jm = jhrfuse.HRFuseResidual(16, 7, upscale=4, packed=True)
    v, (lr, hr) = _init(jhrfuse.HRFuseResidual(16, 7, upscale=4),
                        (2, 8, 8, 16), (2, 32, 32, 16), stats_seed=2)
    m = HRFuseResidual(16, 16, 16, 7, 4)
    m.load_state_dict(_sd(convert._hrfuse_residual, v["params"], v["batch_stats"]))
    m.eval()
    with torch.no_grad():
        ref = m(_t(lr), _t(hr))
        got = m.forward_packed(_t(lr), s2d.pack(_t(hr)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, False))(
        v, jnp.asarray(lr), js2d.pack(jnp.asarray(hr)))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_upsampler_packed_output(scale):
    up = PixelShuffleUpsampler(scale, 16)
    torch.manual_seed(scale)
    x = torch.rand(2, 16, 8, 8)
    with torch.no_grad():
        ref, got = up(x), up(x, packed_output=True)
    np.testing.assert_allclose(s2d.unpack(got).numpy(), ref.numpy(),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        PixelShuffleUpsampler(3, 4)(torch.zeros(1, 4, 2, 2), packed_output=True)


KW = dict(encoder_name="efficientnet-test", super_mid=16, isaggre=True,
          chans_build=7)  # the JAX model of _random_model's


def _random_model(mode="literal", seed=0):
    """The tiny flagship (``efficientnet-test``, super_mid 16, 7 classes)
    and its RRDBNet, weights and BatchNorm statistics drawn from ``seed``."""
    model = SRRegressClsFeature("efficientnet-test", super_mid=16, isaggre=True,
                                chans_build=7, sr_chans=16, compute_mode=mode)
    sr = RRDBNet(num_block=2, num_feat=16, num_grow_ch=8)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    init_weights(sr, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
    return model.eval(), sr.eval()


@pytest.fixture(scope="module")
def flagship():
    """The port's literal and packed models on one set of weights, the JAX
    variables of those weights (``convert.height_model_variables``), and
    seeded inputs."""
    lit, _ = _random_model()
    packed, _ = _random_model("packed")
    packed.load_state_dict(lit.state_dict())
    v = convert.height_model_variables(lit.state_dict(), True,
                                       "efficientnet-test")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 8)).astype(np.float32)
    fea = rng.uniform(0, 1, (2, 128, 128, 16)).astype(np.float32)
    return v, x, fea, {"literal": lit, "packed": packed}


def test_flagship_packed_mode_matches_literal_and_jax(flagship):
    v, x, fea, ports = flagship
    assert ports["literal"].state_dict().keys() == ports["packed"].state_dict().keys()
    with torch.no_grad():
        lit = ports["literal"](_t(x), _t(fea))
        got = ports["packed"](_t(x), _t(fea))
    pk = jmodels.SRRegressClsFeature(compute_mode="packed", **KW)
    want = jax.jit(lambda v, a, f: pk.apply(v, a, f, train=False))(
        v, jnp.asarray(x), jnp.asarray(fea))
    for a, b, w in zip(got, lit, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_n(a), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_flagship_packed_mode_refuses_training(flagship):
    _, x, fea, ports = flagship
    with pytest.raises(ValueError, match="inference-only"):
        ports["packed"].train()(_t(x), _t(fea))
    ports["packed"].eval()
    with pytest.raises(ValueError, match="compute_mode"):
        SRRegressClsFeature("efficientnet-test", compute_mode="s2d")


def test_dual_head_matches_the_heads_and_jax(flagship):
    v, _, _, ports = flagship
    model = ports["literal"]
    rs = [jax.random.uniform(jax.random.PRNGKey(k), s) for k, s in
          ((2, (2, 32, 32, 16)), (3, (2, 32, 32, 16)), (4, (2, 128, 128, 16)))]
    hf, bf, hr = (_t(a) for a in rs)
    with torch.no_grad():
        want = model.reg(hf, hr), model.seg(bf, hr)
        got = dual_head_apply(model, hf, bf, hr)
        got_sd = dual_head_apply(model.state_dict(), hf, bf, hr)
    jh, jb = jax.jit(lambda v, a, b, c: jax_dual_head(
        v["params"], v["batch_stats"], a, b, c))(v, *rs)
    for g, g2, w, j in zip(got, got_sd, want, (jh, jb)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(g.numpy(), g2.numpy())
        np.testing.assert_allclose(_n(g), np.asarray(j), atol=1e-5, rtol=1e-5)


def _cli_tree(root, model, sr):
    """The CLI's inputs: a city of one urban-center group, its min-max
    tables, ``checkpoint20.npz`` of ``model`` and the SR weights."""
    region = os.path.join(root, "data", "urban", "input_data", "s2chn_large")
    write_city(region, "alpha", seed=1, w=140, h=120)
    logdir = os.path.join(root, "logs")
    os.makedirs(logdir)
    v = convert.height_model_variables(model.state_dict(), True,
                                       "efficientnet-test")
    convert.save_tree_npz(os.path.join(logdir, "checkpoint20.npz"), dict(
        v, log_vars=np.array([0.1, -0.2, 0.3], np.float32),
        epoch=np.array(20)))
    torch.save(sr.state_dict(), os.path.join(root, "sr.pt"))
    return ["--datapath", os.path.join(root, "data"), "--logdir", logdir,
            "--logdirhr", os.path.join(root, "sr.pt"),
            "--datastats", os.path.join(region, "stats"), "--s1dir", "s1x",
            "--s2dir", "s2x", "--encoder_name", "efficientnet-test",
            "--super_mid", "16", "--sr_num_block", "2", "--sr_num_feat", "16",
            "--sr_num_grow", "8"]


def test_cli_maps_in_the_packed_mode(tmp_path, monkeypatch):
    """``SRBH_PACKED=1`` maps the same cities as the literal CLI, within the
    quantised-output limit of bfloat16 outputs."""
    model, sr = _random_model(seed=4)
    runs = []
    for packed in ("", "1"):
        monkeypatch.setenv("SRBH_PACKED", packed)
        argv = _cli_tree(str(tmp_path / f"run{packed}"), model, sr)
        runs.append(cli.main(argv, device="cpu"))
    assert len(runs[0]) == len(runs[1]) == 1
    for (b0, h0), (b1, h1) in zip(*runs):
        hl, hp = read_tiff(h0).astype(np.int64), read_tiff(h1).astype(np.int64)
        bl, bp = read_tiff(b0), read_tiff(b1)
        diff = np.abs(hl - hp)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert (bl != bp).mean() <= 1e-3
