"""The port's remaining models against the JAX package's.

Each port model is built at a small width with seeded random weights (and
random BatchNorm statistics, BN affines and conv biases, so that every
mapped tensor matters), its ``state_dict`` goes through the JAX package's
torch -> JAX converters (``srbh_tpu.train.convert``: ``convert_espcn``,
``convert_edsr``, ``convert_rrdbnet_simple``, and for the height variants
and fusion blocks the converters' own pieces), and both models run on one
seeded input. Outputs agree within 1e-4 of the output's largest magnitude.
The port's JAX -> torch carry (``srbh_tpu_torch.convert``) of that JAX tree
gives back the same ``state_dict``: same keys, equal tensors.

The full-size RRDBNet-23 check is marked ``slow``: at nf 64, gc 32 and 23
blocks the JAX model's compile and both forwards take minutes on a CPU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.models import edsr as jedsr
from srbh_tpu.models import height_model as jhm
from srbh_tpu.models import hrfuse as jhr
from srbh_tpu.models import rrdbnet as jrrdb
from srbh_tpu.models import sr_regress as jsrr
from srbh_tpu.models.espcn import ESPCN as JaxESPCN
from srbh_tpu.train import convert as jconv
from srbh_tpu_torch import convert
from srbh_tpu_torch.models import edsr, height_model, hrfuse, rrdbnet, sr_regress
from srbh_tpu_torch.models.espcn import ESPCN
from srbh_tpu_torch.models.layers import init_weights
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4  # relative to the output's largest magnitude
ENC, DEC = "efficientnet-test", (32, 24, 16, 12, 8)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_model(model, seed):
    """Seeded weights; BN statistics and affines and all biases random."""
    init_weights(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_var") or (k.endswith("weight") and v.ndim == 1):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith(("running_mean", "bias")):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
    model.load_state_dict(sd)
    return model.eval()


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _same_state_dict(got, model):
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k].to(v.dtype), v), k


def _jax_apply(module, variables, *xs):
    fn = jax.jit(lambda v, *a: module.apply(v, *a))
    out = fn(variables, *(jnp.asarray(x) for x in xs))
    return out if isinstance(out, tuple) else (out,)


def _run_port(model, *xs):
    with torch.no_grad():
        out = model(*(_nchw(x) for x in xs))
    return out if isinstance(out, tuple) else (out,)


def _compare(model, jmodule, variables, *xs):
    got, want = _run_port(model, *xs), _jax_apply(jmodule, variables, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


# --- torch -> JAX trees from the JAX converters' pieces ---------------------

def _jax_trunk(sd, decoders=("decoder1", "decoder2")):
    params, stats = {}, {}
    params["encoder"], stats["encoder"] = jconv._convert_encoder(sd, "encoder.", ENC)
    for dname in decoders:
        dp, ds = {}, {}
        for bi in range(len(DEC)):
            dp[f"block{bi}"], ds[f"block{bi}"] = {}, {}
            for ci in (1, 2):
                base = f"{dname}.blocks.{bi}.conv{ci}"
                bp, bs = jconv._bn(sd, f"{base}.1")
                dp[f"block{bi}"][f"conv{ci}"] = {"conv": jconv._conv(sd, f"{base}.0"),
                                                 "bn": bp}
                ds[f"block{bi}"][f"conv{ci}"] = {"bn": bs}
        params[dname], stats[dname] = dp, ds
    return params, stats


def _jax_blocks(sd, prefix, name):
    p, s = {}, {}
    for i in range(3):
        p[f"{name}{i}"], s[f"{name}{i}"] = jconv.convert_basic_block(sd, f"{prefix}.{i}")
    return p, s


def _jax_hrfuse_conv_bn(sd, prefix):
    p, s = {}, {}
    for j, name in ((0, "fuse0"), (3, "fuse1")):
        bp, bs = jconv._bn(sd, f"{prefix}fuse.{j + 1}")
        p[name] = {"conv": jconv._conv(sd, f"{prefix}fuse.{j}"), "bn": bp}
        s[name] = {"bn": bs}
    p["upsampler"] = {f"conv_{k}": jconv._conv(sd, f"{prefix}upsampler.{2 * k}")
                      for k in range(2)}
    p["conv_last"] = jconv._conv(sd, f"{prefix}conv_last")
    return p, s


def _jax_heads(sd, params, stats, isaggre):
    params["hrfeat"], stats["hrfeat"] = _jax_blocks(sd, "hrfeat", "block")
    for head in ("reg", "seg"):
        params[head], stats[head] = jconv.convert_hrfuse_residual(sd, head)
    if isaggre:
        params["aggre_height"] = jconv._conv(sd, "aggre_height")


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _carried(helper, variables, *args):
    """One fusion block's carry alone: ``helper`` under a prefix, stripped."""
    sd = {}
    helper(sd, "m", variables["params"], variables["batch_stats"], *args)
    return _sub(sd, "m.")


# --- the fusion blocks ------------------------------------------------------

@pytest.mark.parametrize("x2", [False, True])
def test_hrfuse_conv_bn_blocks_match_jax(x2):
    rng = np.random.default_rng(0)
    if x2:
        model = hrfuse.HRFuseX2(hr_chans=8, mid_chans=16, out_chans=3)
        x_lr = rng.uniform(0, 1, (2, 8, 8, 16)).astype(np.float32)
        x_hr = rng.uniform(0, 1, (2, 32, 32, 8)).astype(np.float32)
    else:
        model = hrfuse.HRFuse(in_chans=24, mid_chans=16, out_chans=3)
        x_lr = rng.uniform(0, 1, (2, 8, 8, 16)).astype(np.float32)
        x_hr = rng.uniform(0, 1, (2, 8, 8, 8)).astype(np.float32)
    _random_model(model, 1)
    p, s = _jax_hrfuse_conv_bn(_np_sd(model), "")
    variables = {"params": p, "batch_stats": s}
    jm = (jhr.HRFuseX2 if x2 else jhr.HRFuse)(mid_chans=16, out_chans=3, upscale=4)
    _compare(model, jm, variables, x_lr, x_hr)
    _same_state_dict(_carried(convert._hrfuse_conv_bn, variables), model)


def test_geonet_matches_jax():
    model = _random_model(hrfuse.GeoNet(in_chans=3, mid_chans=8), 2)
    p, s = _jax_blocks({f"g.{k}": v for k, v in _np_sd(model).items()}, "g",
                       "block")
    variables = {"params": p, "batch_stats": s}
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(np.float32)
    _compare(model, jhr.GeoNet(mid_chans=8), variables, x)
    _same_state_dict(_carried(convert._blocks, variables, "block"), model)


def test_refine_residual_matches_jax():
    model = _random_model(hrfuse.RefineResidual(in_chans=24, mid_chans=8,
                                                out_chans=3), 3)
    sd = _np_sd(model)
    p, s = _jax_blocks(sd, "fuse", "fuse")
    p["conv_last"] = jconv._conv(sd, "conv_last")
    variables = {"params": p, "batch_stats": s}
    rng = np.random.default_rng(3)
    x_lr = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    x_hr = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    _compare(model, jhr.RefineResidual(mid_chans=8, out_chans=3), variables,
             x_lr, x_hr)
    _same_state_dict(_carried(convert._refine_residual, variables), model)


# --- the height variants ----------------------------------------------------

@pytest.mark.parametrize("isaggre", [False, True])
def test_geo_variant_matches_jax(isaggre):
    model = _random_model(height_model.SRRegressClsFeatureGeo(
        ENC, in_chans=8, geo_chans=3, super_mid=8, geo_mid=4, isaggre=isaggre,
        chans_build=7, sr_chans=8, decoder_channels=DEC), 4)
    sd = _np_sd(model)
    params, stats = _jax_trunk(sd)
    _jax_heads(sd, params, stats, isaggre)
    params["geoprior"], stats["geoprior"] = _jax_blocks(sd, "geoprior", "block")
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 32, 32, 11)).astype(np.float32)  # 8 + 3 geo planes
    fea = rng.normal(size=(1, 128, 128, 8)).astype(np.float32)
    jm = jhm.SRRegressClsFeatureGeo(encoder_name=ENC, in_chans=8, super_mid=8,
                                    geo_mid=4, isaggre=isaggre, chans_build=7,
                                    decoder_channels=DEC)
    _compare(model, jm, variables, x, fea)
    _same_state_dict(convert.height_model_state_dict(variables, ENC, isaggre),
                     model)


@pytest.mark.parametrize("isaggre", [False, True])
def test_refine_variant_matches_jax(isaggre):
    model = _random_model(height_model.SRRegressClsFeatureRefine(
        ENC, super_mid=8, isaggre=isaggre, chans_build=7, sr_chans=8,
        decoder_channels=DEC), 5)
    sd = _np_sd(model)
    params, stats = _jax_trunk(sd)
    _jax_heads(sd, params, stats, isaggre)
    params["refine"], stats["refine"] = _jax_blocks(sd, "refine.fuse", "fuse")
    params["refine"]["conv_last"] = jconv._conv(sd, "refine.conv_last")
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 32, 32, 8)).astype(np.float32)
    fea = rng.normal(size=(1, 128, 128, 8)).astype(np.float32)
    jm = jhm.SRRegressClsFeatureRefine(encoder_name=ENC, super_mid=8,
                                       isaggre=isaggre, chans_build=7,
                                       decoder_channels=DEC)
    got, want = _run_port(model, x, fea), _jax_apply(jm, variables, x, fea)
    assert len(got) == len(want) == (4 if isaggre else 3)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    _same_state_dict(
        convert.height_model_state_dict(variables, ENC, isaggre), model)


# --- the SR networks --------------------------------------------------------

@pytest.mark.parametrize("scale,mode", [(4, None), (4, "lr"), (4, "hr"), (2, None)])
def test_edsr_matches_jax(scale, mode):
    model = _random_model(edsr.EDSR(in_chans=4, n_resblocks=2, n_feats=8,
                                    n_out=3, up_scale=scale,
                                    return_features=mode), 6)
    variables = jconv.convert_edsr(_np_sd(model), n_resblocks=2)
    x = np.random.default_rng(6).uniform(0, 1, (2, 8, 8, 4)).astype(np.float32)
    jm = jedsr.EDSR(n_resblocks=2, n_feats=8, n_out=3, up_scale=scale,
                    return_features=mode)
    _compare(model, jm, variables, x)
    _same_state_dict(convert.edsr_state_dict(variables), model)


def test_espcn_matches_jax():
    model = _random_model(ESPCN(upscale_factor=4), 7)
    variables = jconv.convert_espcn(_np_sd(model))
    x = np.random.default_rng(7).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _compare(model, JaxESPCN(upscale_factor=4), variables, x)
    _same_state_dict(convert.espcn_state_dict(variables), model)


def test_rrdbnet_simple_matches_jax():
    model = _random_model(rrdbnet.RRDBNetSimple(num_in_ch=4, num_feat=8,
                                                num_block=2, num_grow_ch=8), 8)
    variables = jconv.convert_rrdbnet_simple(_np_sd(model), num_block=2)
    x = np.random.default_rng(8).uniform(0, 1, (1, 8, 8, 4)).astype(np.float32)
    jm = jrrdb.RRDBNetSimple(num_block=2, num_feat=8, num_grow_ch=8)
    _compare(model, jm, variables, x)
    _same_state_dict(convert.rrdbnet_simple_state_dict(variables, 2), model)


# --- the trainable-SR ablations ---------------------------------------------

def _sr_regress_tree(sd, kind):
    decoders = ("decoder",) if kind == "regress" else ("decoder1", "decoder2")
    params, stats = _jax_trunk(sd, decoders)
    params["super_res"] = jconv.convert_edsr(_sub(sd, "super_res."))["params"]
    if kind == "regress":
        params["head"] = jconv._conv(sd, "head")
    elif kind == "edsr":
        for name in ("super_out", "seg1", "seg2"):
            params[name] = jconv._conv(sd, name)
    else:
        for name in ("seg1", "seg2"):
            params[name], stats[name] = _jax_hrfuse_conv_bn(sd, f"{name}.")
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("kind", ["regress", "edsr", "decision"])
def test_sr_regress_ablations_match_jax(kind):
    if kind == "regress":
        model = sr_regress.SRRegress(ENC, in_chans=8, super_channels=4,
                                     decoder_channels=DEC)
        jm = jsrr.SRRegress(encoder_name=ENC, super_channels=4,
                            decoder_channels=DEC)
        side = 8
    elif kind == "edsr":
        model = sr_regress.SRRegressClsEDSR(ENC, in_chans=8, super_channels=4,
                                            decoder_channels=DEC)
        jm = jsrr.SRRegressClsEDSR(encoder_name=ENC, super_channels=4,
                                   decoder_channels=DEC)
        side = 8
    else:
        model = sr_regress.SRRegressClsDecision(ENC, in_chans=8, super_in=4,
                                                super_mid=8, decoder_channels=DEC)
        jm = jsrr.SRRegressClsDecision(encoder_name=ENC, super_in=4, super_mid=8,
                                       decoder_channels=DEC)
        side = 32
    _random_model(model, 9)
    variables = _sr_regress_tree(_np_sd(model), kind)
    x = np.random.default_rng(9).uniform(0, 1, (1, side, side, 8)).astype(np.float32)
    got, want = _run_port(model, x), _jax_apply(jm, variables, x)
    assert len(got) == len(want) == (1 if kind == "regress" else 3)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    _same_state_dict(convert.sr_regress_state_dict(variables, ENC), model)


# --- item 3's slow check: the full-size RRDBNet-23 --------------------------

@pytest.mark.slow
def test_full_size_rrdbnet_matches_jax():
    jm = jrrdb.RRDBNet(num_block=23, num_feat=64, num_grow_ch=32)
    x = np.random.default_rng(10).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(10), jnp.asarray(x)))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.01, a.shape).astype(np.float32), params)
    model = rrdbnet.RRDBNet(num_block=23).eval()
    model.load_state_dict(convert.rrdbnet_state_dict(params, 23), strict=True)
    for features_only in (False, True):
        want = jax.jit(functools.partial(jm.apply, features_only=features_only))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got = model(_nchw(x), features_only=features_only)
        _close(_nhwc(got), want)
    back = jconv.convert_rrdbnet(_np_sd(model), num_block=23)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), back, params))
