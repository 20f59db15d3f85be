"""The port's SwinIR and its harness against the JAX package's.

Weights go from the JAX model to the port with ``swinir_state_dict``; inputs
are made with numpy from a seed and go through both. Whole-model tolerance
1e-4 (absolute and relative): float32 sums taken in another order through
the blocks. The 30x30 input is reflect-padded to 32x32 (a window multiple),
and with ``img_size`` 64 > window 8 the odd blocks shift, so the shift mask
fires.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.models import swinir as jswin
from srbh_tpu.tools import swinir_harness as jharness
from srbh_tpu_torch.convert import swinir_state_dict
from srbh_tpu_torch.models import swinir as tswin
from srbh_tpu_torch.tools import swinir_harness as tharness
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-4
HEADS_CASES = [  # upsampler, upscale, resi_connection, RSTB depths
    ("pixelshuffle", 2, "1conv", (2, 2)),
    ("", 1, "1conv", (2,)),
    ("pixelshuffledirect", 2, "1conv", (2,)),
    ("nearest+conv", 4, "3conv", (2,)),
]


@functools.lru_cache(maxsize=None)
def tiny_pair(upsampler, upscale, resi, depths):
    """A tiny JAX SwinIR, its variables and the port's twin with the same
    weights (made once per module run; tests only read them)."""
    kw = dict(embed_dim=12, depths=depths, num_heads=(2,) * len(depths),
              window_size=8,
              mlp_ratio=2, upscale=upscale, upsampler=upsampler,
              resi_connection=resi, num_feat=16)
    jm = jswin.SwinIR(**kw)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32, 32, 3))))
    tm = tswin.SwinIR(**kw).eval()
    tm.load_state_dict(swinir_state_dict(v, depths, upsampler), strict=True)
    return jm, v, tm


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("upsampler,upscale,resi,depths", HEADS_CASES)
def test_tiny_swinir_matches_jax(upsampler, upscale, resi, depths):
    jm, v, tm = tiny_pair(upsampler, upscale, resi, depths)
    x = np.random.default_rng(0).uniform(0, 1, (2, 30, 30, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, 30 * upscale, 30 * upscale, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_use_kernel_flag_reaches_every_block():
    tm = tswin.SwinIR(embed_dim=12, depths=(2, 2), num_heads=(2, 2),
                      window_size=8, upsampler="", use_kernel=False)
    attns = [m for m in tm.modules() if isinstance(m, tswin.WindowAttention)]
    assert len(attns) == 4 and not any(m.use_kernel for m in attns)
    blocks = [m for m in tm.modules()
              if isinstance(m, tswin.SwinTransformerBlock)]
    assert [b.shift_size for b in blocks] == [0, 4, 0, 4]


@pytest.mark.parametrize("h,w,ws,shift", [(32, 32, 8, 4), (72, 72, 8, 4),
                                          (70, 70, 7, 3), (16, 24, 8, 4)])
def test_shift_mask_and_index_match_jax(h, w, ws, shift):
    np.testing.assert_array_equal(tswin.shift_attn_mask(h, w, ws, shift),
                                  jswin.shift_attn_mask(h, w, ws, shift))
    np.testing.assert_array_equal(tswin.relative_position_index(ws),
                                  jswin.relative_position_index(ws))


@pytest.mark.parametrize("ws", [7, 8])
def test_window_partition_reverse_match_jax(ws):
    x = np.random.default_rng(1).normal(size=(2, 4 * ws, 2 * ws, 5)).astype(
        np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), ws))
    got = tswin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, ws, 4 * ws, 2 * ws)
    np.testing.assert_array_equal(back.numpy(), x)


def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)


@pytest.mark.parametrize("task,scale", [("classical_sr", 4),
                                        ("lightweight_sr", 2),
                                        ("jpeg_car", 1)])
def test_preset_parameter_shapes_match_jax(task, scale):
    """The full-width presets: same parameter names (through the converter)
    and shapes; the JAX side costs shapes only (``jax.eval_shape``)."""
    jm = jharness.define_model(task, scale)
    chans = 1 if task == "jpeg_car" else 3
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, chans)))
    depths = (6,) * (4 if task == "lightweight_sr" else 6)
    want = {k: tuple(v.shape) for k, v in swinir_state_dict(
        _zeros_like_shapes(shapes), depths, jm.upsampler).items()}
    tm = tharness.define_model(task, scale, device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


@pytest.mark.parametrize("task", jharness.TASKS)
@pytest.mark.parametrize("scale", [1, 4])
def test_setup_matches_jax(task, scale):
    assert tharness.setup(task, scale) == jharness.setup(task, scale)


@pytest.mark.parametrize("shape,ws", [((30, 41, 3), 8), ((64, 64, 1), 7),
                                      ((16, 16, 3), 8)])
def test_pad_to_window_multiple_matches_jax(shape, ws):
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_array_equal(tharness.pad_to_window_multiple(img, ws),
                                  jharness.pad_to_window_multiple(img, ws))


@pytest.mark.parametrize("tile", [None, 16])
def test_tiled_inference_matches_jax(tile):
    jm, v, tm = tiny_pair(*HEADS_CASES[0])
    img = np.random.default_rng(4).uniform(0, 1, (24, 40, 3)).astype(np.float32)
    want = jharness.tiled_inference(jax.jit(lambda x: jm.apply(v, x)), img, 2,
                                    tile=tile, tile_overlap=8)
    got = tharness.tiled_inference(lambda x: tharness.apply(tm, x), img, 2,
                                   tile=tile, tile_overlap=8)
    assert got.shape == want.shape == (48, 80, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# drop-path (stochastic depth): the JAX package draws its masks from a JAX
# key, so train mode is held to the JAX output at rate 0 and, above it, to
# the rule itself: each sample's branch zeroed or scaled by 1 / keep
DROP_KW = dict(embed_dim=12, depths=(2, 3), num_heads=(2, 2), window_size=8,
               mlp_ratio=2, upscale=1, upsampler="", num_feat=16)


def _jax_block_rates(jm, v, x):
    """The drop-path rate of each JAX block, read as the blocks are called."""
    import flax.linen as fnn

    rates = []

    def record(f, args, kwargs, context):
        if (isinstance(context.module, jswin.SwinTransformerBlock)
                and context.method_name == "__call__"):
            rates.append(context.module.drop_path)
        return f(*args, **kwargs)

    with fnn.intercept_methods(record):
        jm.apply(v, x)
    return rates


@pytest.mark.parametrize("rate", [0.1, 0.37])
def test_drop_path_rates_equal_jax_dpr(rate):
    jm = jswin.SwinIR(**DROP_KW, drop_path_rate=rate)
    x = jnp.zeros((1, 16, 16, 3))
    want = _jax_block_rates(jm, jm.init(jax.random.PRNGKey(0), x), x)
    tm = tswin.SwinIR(**DROP_KW, drop_path_rate=rate)
    got = [b.drop_path for m in tm.layers for b in m.residual_group.blocks]
    assert len(want) == 5 and got == want


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_modes_match_jax(mode):
    """Eval mode at the default rate 0.1 against JAX ``train=False``; train
    mode at rate 0 against JAX ``train=True``: no draw in either."""
    rate = 0.1 if mode == "eval" else 0.0
    jm = jswin.SwinIR(**DROP_KW, drop_path_rate=rate)
    x = np.random.default_rng(7).uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = tswin.SwinIR(**DROP_KW, drop_path_rate=rate, use_kernel=False)
    tm.load_state_dict(swinir_state_dict(v, DROP_KW["depths"], ""), strict=True)
    tm.train(mode == "train")
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=mode == "train"))
    with torch.no_grad():
        got = nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_drop_path_zeroes_or_scales_each_sample():
    """Each sample all zero or all ``x / keep``; the kept share within five
    binomial standard deviations of ``keep``."""
    n, rate = 20000, 0.25
    keep = 1 - rate
    x = torch.rand(n, 2, 2, 3, generator=torch.Generator().manual_seed(0)) + 0.5
    out = tswin.drop_path(x, rate, torch.Generator().manual_seed(1))
    kept = (out != 0).flatten(1).all(1)
    dropped = (out == 0).flatten(1).all(1)
    assert bool((kept | dropped).all())
    assert torch.equal(out[kept], x[kept] / keep)
    share = kept.double().mean().item()
    assert abs(share - keep) <= 5 * (keep * rate / n) ** 0.5, share


def _block_with_masks(blk, x, m1, m2, keep):
    """A Swin block's forward with given drop-path masks of its two branches."""
    b, h, w, c = x.shape
    ws, shift = blk.window_size, blk.shift_size
    y, mask = blk.norm1(x), None
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = torch.from_numpy(tswin.shift_attn_mask(h, w, ws, shift))
    a = tswin.window_reverse(blk.attn(tswin.window_partition(y, ws), mask), ws, h, w)
    if shift:
        a = torch.roll(a, (shift, shift), dims=(1, 2))
    x = x + a / keep * m1
    return x + blk.mlp(blk.norm2(x)) / keep * m2


@pytest.mark.parametrize("shift", [0, 4])
def test_block_drops_both_branches_per_sample(shift):
    rate, n = 0.5, 16
    keep = 1 - rate
    blk = tswin.SwinTransformerBlock(12, 2, 8, shift_size=shift, mlp_ratio=2,
                                     use_kernel=False, drop_path=rate)
    x = torch.randn(n, 16, 16, 12, generator=torch.Generator().manual_seed(2))
    replay = torch.Generator().manual_seed(3)
    m1, m2 = (torch.empty(n, 1, 1, 1).bernoulli_(keep, generator=replay)
              for _ in range(2))
    assert 0 < m1.sum() < n and 0 < m2.sum() < n
    with torch.no_grad():
        got = blk.train()(x, torch.Generator().manual_seed(3))
        want = _block_with_masks(blk, x, m1, m2, keep)
        assert torch.equal(got, want)
        assert not torch.equal(blk.eval()(x), got)


def test_train_mode_draws_from_its_generator():
    tm = tswin.SwinIR(**DROP_KW, drop_path_rate=0.3, use_kernel=False).train()
    x = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        with pytest.raises(ValueError, match="torch.Generator"):
            tm(x)
        a = tm(x, torch.Generator().manual_seed(5))
        b = tm(x, torch.Generator().manual_seed(5))
        c = tm(x, torch.Generator().manual_seed(6))
        e = tm.eval()(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, e)
