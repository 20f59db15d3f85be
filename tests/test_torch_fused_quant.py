"""The fused dense block and the int8 trunk against the port's literal forms
and the JAX package's (``tests/test_models.py:103``, ``tests/test_quant.py``).

* ``fused=True`` (``RRDBNet`` at scales 4 and 2, ``RRDBNetSimple``): the
  image and the ``features_only`` output within 1e-5 of max |out| of the
  literal port and of JAX ``fused=True`` on the same weights (carried to
  JAX by its converter); one state dict in both modes.
* ``ops/quant.py``: ``quantize_weight`` / ``quantize_activation`` equal the
  JAX ones; ``int8_conv_sums`` equals JAX's int32 ``conv_general_dilated``
  (padded reduction axis, stride 2, odd widths); ``int8_conv`` within 1e-6
  relative of JAX's; the JAX test's own bounds on the port: the weight
  round trip within scale / 2, the activation's full range, the conv within
  0.02 x max |ref| + 0.01 of the float conv.
* ``RRDBNet(quantize=True)``: the same state dict as the float trunk, its
  features within 1e-6 relative of JAX's quantised trunk, and more than
  25 dB of SNR against the float features, with bits that differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbh_tpu import models as jmodels
from srbh_tpu.ops import quant as jquant
from srbh_tpu.train.convert import convert_rrdbnet, convert_rrdbnet_simple
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSimple
from srbh_tpu_torch.ops import quant
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

KW = dict(num_block=2, num_feat=16, num_grow_ch=8)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _seeded(model, seed=3):
    """``model`` with weights drawn from ``seed``, and the JAX variables of
    the same weights (the JAX package's converter; no JAX init to
    compile)."""
    init_weights(model, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    num_block = len(getattr(model, "body", getattr(model, "RRDB_trunk", [])))
    to_jax = convert_rrdbnet if isinstance(model, RRDBNet) else convert_rrdbnet_simple
    return model, to_jax(sd, num_block)


@pytest.mark.parametrize("scale,num_block", [(4, 2), (2, 1)])
def test_fused_rrdbnet_matches_literal_and_jax(scale, num_block):
    x = np.random.default_rng(3).uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    kw = dict(KW, num_block=num_block, scale=scale)
    jm = jmodels.RRDBNet(fused=True, **kw)
    lit, variables = _seeded(RRDBNet(**kw))
    fused = RRDBNet(fused=True, **kw)
    assert lit.state_dict().keys() == fused.state_dict().keys()
    fused.load_state_dict(lit.state_dict())
    wants = jax.jit(lambda v, a: (jm.apply(v, a), jm.apply(
        v, a, features_only=True)))(variables, x)
    for kw, want in zip(({}, {"features_only": True}), wants):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        with torch.no_grad():
            a, b = lit(_nchw(x), **kw).numpy(), fused(_nchw(x), **kw).numpy()
        assert _rel(b, a) <= 1e-5 and _rel(b, want) <= 1e-5, kw


def test_fused_rrdbnet_simple_matches_literal_and_jax():
    x = np.random.default_rng(4).uniform(0, 1, (1, 8, 8, 4)).astype(np.float32)
    lit, variables = _seeded(RRDBNetSimple(**KW), seed=4)
    want = np.asarray(jax.jit(jmodels.RRDBNetSimple(fused=True, **KW).apply)(
        variables, x)).transpose(0, 3, 1, 2)
    outs = []
    for fused in (False, True):
        m = RRDBNetSimple(fused=fused, **KW)
        m.load_state_dict(lit.state_dict())
        with torch.no_grad():
            outs.append(m(_nchw(x)).numpy())
    assert _rel(outs[1], outs[0]) <= 1e-5 and _rel(outs[1], want) <= 1e-5


def test_fused_block_gradients_match_literal():
    """The regrouped block is the same function for autograd too."""
    x = torch.rand(1, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    grads = []
    for fused in (False, True):
        torch.manual_seed(0)
        m = RRDBNet(fused=fused, **KW)
        (m(x) ** 2).mean().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, g in grads[0].items():
        assert (grads[1][name] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-9, name


def test_quantize_ops_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    x = rng.uniform(-2, 2, (2, 8, 8, 5)).astype(np.float32)
    jw, js = jquant.quantize_weight(jnp.asarray(w))
    tw, ts = quant.quantize_weight(_oihw(w))
    assert tw.dtype == torch.int8 and ts.shape == (8, 1, 1, 1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.numpy().reshape(-1), np.asarray(js).reshape(-1))
    jx, jxs = jquant.quantize_activation(jnp.asarray(x))
    tx, txs = quant.quantize_activation(_nchw(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).transpose(0, 3, 1, 2))
    assert txs.item() == float(jxs)


@pytest.mark.parametrize("ci,co,k,stride,shape", [
    (3, 64, 3, 1, (2, 10, 12)),   # K = 27: padded to 32
    (8, 16, 3, 1, (2, 16, 16)),
    (5, 7, 3, 2, (1, 9, 7)),      # odd widths, stride 2
    (16, 8, 1, 1, (1, 6, 6)),     # 1x1
])
def test_int8_conv_sums_equal_jax(ci, co, k, stride, shape):
    rng = np.random.default_rng(ci * 31 + co)
    b, h, w = shape
    xq = rng.integers(-127, 128, (b, h, w, ci)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride),
        ((k // 2, k // 2), (k // 2, k // 2)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = quant.int8_conv_sums(_nchw(xq), _oihw(wq), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_int8_conv_matches_jax_and_the_float_conv():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 16, 16, 8)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32)
    b = rng.normal(0, 0.01, (16,)).astype(np.float32)
    want = np.asarray(jquant.int8_conv(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), out_dtype=jnp.float32))
    got = quant.int8_conv(_nchw(x), _oihw(w), torch.from_numpy(b),
                          out_dtype=torch.float32).numpy()
    assert _rel(got, want.transpose(0, 3, 1, 2)) <= 1e-6
    ref = torch.nn.functional.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b),
                                     padding=1).numpy()
    err, top = np.abs(got - ref).max(), np.abs(ref).max()
    assert err < 0.02 * top + 0.01, (err, top)


def test_quantised_weight_round_trip_and_activation_range():
    rng = np.random.default_rng(0)
    w = _oihw(rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32))
    w_q, s = quant.quantize_weight(w)
    back = w_q.float() * s
    assert (back - w).abs().max().item() <= s.max().item() / 2 + 1e-9
    x_q, s = quant.quantize_activation(torch.tensor([[-2.0, 0.5, 1.0]]))
    assert int(x_q.min()) == -127 and s.item() == pytest.approx(2.0 / 127.0)


def test_quantised_trunk_matches_jax_and_stays_faithful():
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    jq = jmodels.RRDBNet(quantize=True, **KW)
    flt, variables = _seeded(RRDBNet(**KW), seed=0)
    q = RRDBNet(quantize=True, **KW)
    assert flt.state_dict().keys() == q.state_dict().keys()
    q.load_state_dict(flt.state_dict())
    want = np.asarray(jax.jit(lambda v, a: jq.apply(v, a, features_only=True))(
        variables, x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        fea_q = q(_nchw(x), features_only=True).numpy()
        fea_f = flt(_nchw(x), features_only=True).numpy()
        img = q(_nchw(x))
    assert fea_q.dtype == np.float32 and img.shape == (1, 3, 64, 64)
    assert _rel(fea_q, want) <= 1e-6
    num = float(((fea_f - fea_q) ** 2).sum())
    snr_db = 10 * np.log10(float((fea_f ** 2).sum()) / max(num, 1e-12))
    assert snr_db > 25, snr_db
    assert num > 0
