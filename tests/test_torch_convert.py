"""Weight round trip: reference torch state dict -> JAX variables -> port.

A random state dict with the reference's torch names (taken from the port's
modules) goes through the JAX package's ``convert_rrdbnet``,
``convert_height_model`` and ``convert_swinir``, then through the port's
inverse converters, and must come back with the same names, shapes and
values (the conversions are transposes, so exactly). It must also load into
the port's module with ``strict=True``.
"""
import numpy as np
import pytest
import torch

from srbh_tpu.train import convert as jconvert
from srbh_tpu_torch import convert
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.models.swinir import SwinIR
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def random_state_dict(module, seed=0):
    """The module's names and shapes with random values;
    ``num_batches_tracked`` stays 0 (the JAX package does not keep it)."""
    rng = np.random.default_rng(seed)
    return {k: v if k.endswith("num_batches_tracked") else torch.from_numpy(
        rng.normal(size=tuple(v.shape)).astype(np.float32))
        for k, v in module.state_dict().items()}


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("num_block,num_feat,grow", [(2, 16, 8), (1, 64, 32)])
def test_rrdbnet_round_trip(num_block, num_feat, grow):
    model = RRDBNet(num_block=num_block, num_feat=num_feat, num_grow_ch=grow)
    sd = random_state_dict(model)
    back = convert.rrdbnet_state_dict(
        jconvert.convert_rrdbnet(numpy_sd(sd), num_block), num_block)
    assert_same(back, sd)
    model.load_state_dict(back, strict=True)


@pytest.mark.parametrize("encoder,super_mid,sr_chans,isaggre", [
    ("efficientnet-test", 8, 16, True),
    ("efficientnet-test", 8, 16, False),
    ("efficientnet-b4", 16, 64, True),
])
def test_height_model_round_trip(encoder, super_mid, sr_chans, isaggre):
    model = SRRegressClsFeature(encoder, super_mid=super_mid, isaggre=isaggre,
                                chans_build=7, sr_chans=sr_chans)
    sd = random_state_dict(model, seed=1)
    back = convert.height_model_state_dict(
        jconvert.convert_height_model(numpy_sd(sd), isaggre=isaggre,
                                      encoder_name=encoder),
        encoder, isaggre)
    assert_same(back, sd)
    model.load_state_dict(back, strict=True)


@pytest.mark.parametrize("upsampler,upscale", [("pixelshuffle", 4),
                                               ("pixelshuffle", 3),
                                               ("pixelshuffledirect", 2),
                                               ("nearest+conv", 4),
                                               ("", 1)])
def test_swinir_round_trip(upsampler, upscale):
    depths = (2, 2)
    model = SwinIR(embed_dim=12, depths=depths, num_heads=(2, 2),
                   window_size=8, upscale=upscale, upsampler=upsampler,
                   num_feat=16)
    sd = random_state_dict(model, seed=2)
    back = convert.swinir_state_dict(
        jconvert.convert_swinir(numpy_sd(sd), depths, upsampler), depths,
        upsampler)
    assert_same(back, sd)
    model.load_state_dict(back, strict=True)
