"""The port's host and device stitchers against the JAX package's.

Mirrors ``tests/test_device_stitcher.py``: random overlapping and
edge-clipped windows, zero-count windows, ragged ``xcount / ycount``, uint8
and uint16 build tiles. The device stitcher runs here on CPU tensors (on a
CUDA tensor the same code runs on the card). Sums, weights and the
finalized mosaics must be equal exactly (tolerance 0): integers throughout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srbh_tpu.predict.device_stitcher import finalize_mosaic as jax_finalize
from srbh_tpu.predict.device_stitcher import stitch_tiles as jax_stitch
from srbh_tpu.predict.sliding import predict_whole_image as jax_whole
from srbh_tpu.predict.sliding import window_anchors as jax_anchors
from srbh_tpu.predict.stitcher import MosaicAccumulator as JaxAccumulator
from srbh_tpu_torch.predict.device_stitcher import (
    DeviceMosaicAccumulator,
    finalize_mosaic,
    stitch_tiles,
)
from srbh_tpu_torch.predict.sliding import predict_whole_image, window_anchors
from srbh_tpu_torch.predict.stitcher import MosaicAccumulator

SRC_W, SRC_H, WIN, UP, C = 24, 20, 8, 4, 3
T = WIN * UP


def _random_batch(rng, n, build_dtype=np.uint16):
    height = rng.randint(0, 2000, (n, T, T)).astype(np.uint16)
    build = rng.randint(0, 256, (n, T, T, C)).astype(build_dtype)
    pos = np.zeros((n, 4), np.int32)
    for i in range(n):
        # overlapping windows, some clipped at the right or bottom edge
        pos[i, 0] = rng.randint(0, SRC_W - 4)
        pos[i, 1] = rng.randint(0, SRC_H - 4)
        pos[i, 2] = min(WIN, SRC_W - pos[i, 0])
        pos[i, 3] = min(WIN, SRC_H - pos[i, 1])
    pos[n // 2, 2:] = 0  # a zero-count window (a padded slot) adds nothing
    return height, build, pos


def _jax_host(height, build, pos):
    acc = JaxAccumulator(SRC_W, SRC_H, C, upscale=UP)
    for lo in range(0, len(pos), 5):  # the JAX accumulator, batch by batch
        acc.add_batch(height[lo: lo + 5], build[lo: lo + 5], pos[lo: lo + 5])
    return acc


@pytest.mark.parametrize("build_dtype", [np.uint16, np.uint8])
def test_host_accumulator_equals_jax(build_dtype):
    height, build, pos = _random_batch(np.random.RandomState(0), 13,
                                       build_dtype)
    want = _jax_host(height, build, pos)
    got = MosaicAccumulator(SRC_W, SRC_H, C, upscale=UP)
    for lo in range(0, 13, 4):
        got.add_batch(height[lo: lo + 4], build[lo: lo + 4], pos[lo: lo + 4])
    np.testing.assert_array_equal(got.height_sum, want.height_sum)
    np.testing.assert_array_equal(got.build_sum, want.build_sum)
    np.testing.assert_array_equal(got.weight, want.weight)
    assert got.weight.dtype == want.weight.dtype == np.uint16
    for a, b in zip(got.finalize(), want.finalize()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("build_dtype", [np.uint16, np.uint8])
def test_stitch_tiles_equals_jax(build_dtype):
    height, build, pos = _random_batch(np.random.RandomState(1), 13,
                                       build_dtype)
    want = jax_stitch(jnp.asarray(height), jnp.asarray(build.astype(np.uint16)),
                      jnp.asarray(pos), (SRC_H * UP, SRC_W * UP), UP)
    got = stitch_tiles(torch.from_numpy(height), torch.from_numpy(build), pos,
                       (SRC_H * UP, SRC_W * UP), UP)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(finalize_mosaic(*got), jax_finalize(*want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    host = _jax_host(height, build, pos)
    np.testing.assert_array_equal(got[1].permute(2, 0, 1).numpy(),
                                  host.build_sum)


def test_device_accumulator_equals_jax_host_accumulator():
    height, build, pos = _random_batch(np.random.RandomState(2), 19, np.uint8)
    want = _jax_host(height, build, pos)
    acc = DeviceMosaicAccumulator(SRC_W, SRC_H, C, upscale=UP, device="cpu")
    for lo in range(0, 19, 8):  # a short last batch, as the predictor's
        acc.add_batch(torch.from_numpy(height[lo: lo + 8]),
                      torch.from_numpy(build[lo: lo + 8]),
                      torch.from_numpy(pos[lo: lo + 8]))
    np.testing.assert_array_equal(acc.hs.numpy(), want.height_sum)
    np.testing.assert_array_equal(acc.bs.permute(2, 0, 1).numpy(),
                                  want.build_sum)
    np.testing.assert_array_equal(acc.wt.numpy(), want.weight)
    for a, b in zip(acc.finalize(), want.finalize()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_zero_count_window_is_a_noop():
    height = np.full((1, T, T), 7, np.uint16)
    build = np.full((1, T, T, C), 9, np.uint16)
    pos = np.array([[3, 2, 0, 0]], np.int32)
    for t in stitch_tiles(torch.from_numpy(height), torch.from_numpy(build),
                          pos, (SRC_H * UP, SRC_W * UP), UP):
        assert int(t.abs().sum()) == 0


def test_finalize_ties_and_rounding_equal_jax():
    """Equal class sums (and uncovered pixels) pick the first class; sums
    at half a unit round to even; the host divides in float64 and the
    device in float32, and they agree."""
    rng = np.random.default_rng(3)
    h, w = 40, 50
    weight = rng.integers(0, 9, (h, w)).astype(np.int32)
    # every quotient of k / weight near the top of uint16, halves included
    height_sum = weight * rng.integers(0, 65535, (h, w)) + \
        rng.integers(0, 9, (h, w)) * (weight > 0)
    height_sum[0, :8] = np.array([1, 3, 5, 7, 2 * 65534 + 1, 9, 11, 13])
    weight[0, :8] = 2
    height_sum = np.minimum(height_sum, 65535 * weight).astype(np.int32)
    build_sum = rng.integers(0, 3, (h, w, C)).astype(np.int32) * 255  # ties
    build_sum[weight == 0] = 0
    want = jax_finalize(jnp.asarray(height_sum), jnp.asarray(build_sum),
                        jnp.asarray(weight))
    got = finalize_mosaic(torch.from_numpy(height_sum),
                          torch.from_numpy(build_sum), torch.from_numpy(weight))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.uint16 and got[1].dtype == torch.uint8
    np.testing.assert_array_equal(got[0][0, :4].numpy(), [0, 2, 2, 4])
    host = MosaicAccumulator(w, h, C, upscale=1)
    host.height_sum[:] = height_sum
    host.build_sum[:] = build_sum.transpose(2, 0, 1)
    host.weight[:] = weight
    for a, b in zip(host.finalize(), got):
        np.testing.assert_array_equal(a, b.numpy())


def test_window_anchors_equal_jax():
    for size, grid, stride in ((200, 64, 60), (64, 64, 60), (129, 32, 16)):
        assert window_anchors(size, grid, stride) == \
            jax_anchors(size, grid, stride)
    with pytest.raises(ValueError, match="smaller than the window"):
        window_anchors(10, 64, 60)


def test_predict_whole_image_equals_jax():
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 1, (70, 90, 3)).astype(np.float32)
    weights = rng.normal(size=(3, 2)).astype(np.float32)

    def predict_fn(batch):  # (N, 32, 32, 3) -> (N, 64, 64, 2)
        return np.repeat(np.repeat(batch @ weights, 2, axis=1), 2, axis=2)

    kw = dict(grid=32, stride=28, out_scale=2, out_channels=2, batch_size=5)
    got = predict_whole_image(image, predict_fn, **kw)
    want = jax_whole(image, predict_fn, **kw)
    assert got.shape == (140, 180, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
