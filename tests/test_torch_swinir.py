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
