"""``python -m srbh_tpu_torch.convert``: a JAX npz -> a torch file.

For ``height``, ``rrdbnet``, ``edsr``, ``swinir`` and ``unet-sn`` at tiny
width: JAX variables (a random port model's weights through the JAX
package's own converter, ``srbh_tpu/train/convert.py``), written with the
JAX package's ``save_tree_npz``, go through the port's CLI; the file it
writes loads with ``load_state_dict(strict=True)`` into a model of other
weights, whose outputs then equal the JAX model's within 1e-5 x (1 + |b|).
``--arch height`` writes the reference's checkpoint dict, whose
``log_vars``, ``epoch`` and ``best_acc`` survive, and which
``trainer.main_test`` reads and names its acc files by. The port's own
npz writer and JAX-tree converter (``convert.save_tree_npz``,
``convert.height_model_variables``) give the JAX package's file key for
key; one run goes through the module's ``__main__``, as ``python -m`` runs
it.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu import models as jmodels
from srbh_tpu.train import convert as jconvert
from srbh_tpu_torch import convert, entry
from srbh_tpu_torch.models.discriminators import UNetDiscriminatorSN
from srbh_tpu_torch.models.edsr import EDSR
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.models.swinir import SwinIR
from srbh_tpu_torch.tools.loader_bench import build_synthetic
from srbh_tpu_torch.train import trainer
from srbh_tpu_torch.train.config import TrainConfig
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
SWIN = dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2, upscale=2, upsampler="pixelshuffle", num_feat=16)


def _random(module, seed):
    init_weights(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for name, t in module.state_dict().items():
        if name.endswith("running_mean"):
            t.normal_(0, 0.1, generator=gen)
        elif name.endswith("running_var"):
            t.uniform_(0.5, 1.5, generator=gen)
    return module.eval()


def _np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _height():
    tm, tsr, _ = entry.flagship(tiny=True, device="cpu", seed=3)
    _random(tm, 3)
    jm = jmodels.SRRegressClsFeature(encoder_name="efficientnet-test",
                                     super_mid=8, isaggre=True, chans_build=7)
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 8)).astype(np.float32)
    fea = np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 16)).astype(np.float32)
    variables = jconvert.convert_height_model(_np(tm), True, "efficientnet-test")
    fresh = entry.modules(tiny=True)[0].eval()
    return (variables, fresh, (x, fea),
            lambda v, x, f: jm.apply(v, x, f, train=False))


def _rrdbnet():
    kw = dict(num_block=2, num_feat=8, num_grow_ch=4)
    x = np.random.default_rng(2).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    return (jconvert.convert_rrdbnet(_np(_random(RRDBNet(**kw), 4)), 2),
            RRDBNet(**kw).eval(), (x,), jmodels.RRDBNet(**kw).apply)


def _edsr():
    from srbh_tpu.models.edsr import EDSR as JaxEDSR

    kw = dict(n_resblocks=2, n_feats=8, n_out=3, up_scale=2)
    x = np.random.default_rng(3).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    return (jconvert.convert_edsr(_np(_random(EDSR(in_chans=3, **kw), 5)), 2),
            EDSR(in_chans=3, **kw).eval(), (x,), JaxEDSR(**kw).apply)


def _swinir():
    from srbh_tpu.models.swinir import SwinIR as JaxSwinIR

    x = np.random.default_rng(4).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    return (jconvert.convert_swinir(_np(_random(SwinIR(**SWIN), 6)), SWIN["depths"]),
            SwinIR(**SWIN).eval(), (x,), JaxSwinIR(**SWIN).apply)


def _unet_sn():
    from srbh_tpu.models.discriminators import UNetDiscriminatorSN as JaxUNet

    x = np.random.default_rng(5).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    d = _random(UNetDiscriminatorSN(num_feat=8), 7)
    for conv in d.sn_convs():
        conv.reset_from(torch.Generator().manual_seed(8))
    return (jconvert.convert_unet_discriminator_sn(_np(d)),
            UNetDiscriminatorSN(num_feat=8), (x,),
            lambda v, x: JaxUNet(num_feat=8).apply(v, x, train=False))


CASES = {"height": _height, "rrdbnet": _rrdbnet, "edsr": _edsr,
         "swinir": _swinir, "unet-sn": _unet_sn}
ARGS = {"height": ["--encoder-name", "efficientnet-test"]}


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _close(got, want):
    got = got.detach().permute(0, 2, 3, 1).numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= TOL, err


@pytest.mark.parametrize("arch", sorted(CASES))
def test_cli_output_loads_strictly_and_matches_jax(arch, tmp_path):
    variables, fresh, inputs, jax_apply = CASES[arch]()
    tree = dict(variables)
    if arch == "height":
        tree["log_vars"] = {"w1": np.float32(0.5), "w2": np.float32(-0.25),
                            "w3": np.float32(0.125)}
        tree["meta"] = {"epoch": np.int32(20), "best_acc": np.float32(2.5)}
    npz, out = str(tmp_path / "in.npz"), str(tmp_path / "out.pt")
    jconvert.save_tree_npz(npz, tree)
    convert.main([npz, out, "--arch", arch, *ARGS.get(arch, [])])
    payload = torch.load(out, map_location="cpu", weights_only=True)
    if arch == "height":
        assert set(payload) == {"epoch", "state_dict", "log_vars", "best_acc"}
        assert payload["epoch"] == 20 and payload["best_acc"] == 2.5
        assert torch.cat(payload["log_vars"]).tolist() == [0.5, -0.25, 0.125]
        payload = payload["state_dict"]
    fresh.load_state_dict(payload, strict=True)
    want = jax.jit(jax_apply)(variables, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        if arch == "unet-sn":
            got = fresh(*(_nchw(a) for a in inputs), train=False)
        else:
            got = fresh(*(_nchw(a) for a in inputs))
    got, want = ((got, want) if isinstance(want, tuple) else ((got,), (want,)))
    for g, w in zip(got, want):
        _close(g, w)


def test_port_writer_and_tree_match_the_jax_converter(tmp_path):
    tm, _, _ = entry.flagship(tiny=True, device="cpu", seed=4)
    want = jconvert.convert_height_model(_np(tm), True, "efficientnet-test")
    got = convert.height_model_variables(tm.state_dict(), True, "efficientnet-test")
    jconvert.save_tree_npz(str(tmp_path / "jax.npz"), want)
    convert.save_tree_npz(str(tmp_path / "port.npz"), got)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_converted_height_checkpoint_drives_main_test(tmp_path, monkeypatch):
    """The CLI's file, as ``checkpoint20`` of a log directory, through the
    module's ``__main__`` (as ``python -m srbh_tpu_torch.convert`` runs it):
    ``main_test`` reads it and names its acc files by the converted epoch
    (``acc20{suffix}_{num}.txt``)."""
    data, logdir = tmp_path / "data", tmp_path / "logs"
    data.mkdir()
    logdir.mkdir()
    build_synthetic(str(data), 2)
    tm, _, _ = entry.flagship(tiny=True, device="cpu", seed=5)
    tree = convert.height_model_variables(tm.state_dict(), True, "efficientnet-test")
    tree["meta"] = {"epoch": np.int32(20), "best_acc": np.float32(1.5)}
    tree["log_vars"] = {"w1": np.float32(0.0), "w2": np.float32(0.0),
                        "w3": np.float32(0.0)}
    convert.save_tree_npz(str(tmp_path / "height.npz"), tree)
    monkeypatch.setattr(sys, "argv", [
        "convert", str(tmp_path / "height.npz"), str(logdir / "checkpoint20"),
        "--arch", "height", "--encoder-name", "efficientnet-test"])
    runpy.run_module("srbh_tpu_torch.convert", run_name="__main__")
    cfg = TrainConfig(datapath=str(data), testlist="dl.csv", logdir=str(logdir),
                      logdirhr=str(tmp_path / "none"), datastats=str(data),
                      preweight=str(data / "bh_stats.txt"), s1dir="s1c",
                      s2dir="s2c", bhdir="bhc", num_workers=0,
                      encoder_name="efficientnet-test", super_mid=8,
                      sr_num_block=2, sr_num_feat=16, sr_num_grow=8,
                      checkpoint="checkpoint20")
    res = trainer.main_test(cfg, num_sample=0, suffix="globe", device="cpu")
    assert res["txtpath"] == str(logdir / "acc20globe_0.txt")
    assert np.isfinite(res["rmse"]) and os.path.isfile(res["txtpath"])
