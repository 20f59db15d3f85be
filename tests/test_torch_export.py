"""The port's serving export against the JAX package's (twin of
``tests/test_export.py``).

A tiny flagship (RRDBNet-1 of width 8, ``efficientnet-test``, random
BatchNorm statistics) is exported with ``torch.export`` by
``tools/export_model.py`` and saved to disk:

* with a symbolic batch, the loaded program gives the eager serving
  forward's outputs exactly at batch 2 and 3, and its float outputs match
  the JAX ``make_serving_fn`` on the same weights (carried by the JAX
  package's own converter) within 1e-4 x (1 + |b|);
* with a fixed batch, in bfloat16 (autocast captured in the program), its
  module gives the eager bfloat16 forward's outputs and ``make_city_step``'s
  quantised ones exactly, and refuses another batch size;
* the CLI refuses half a checkpoint.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu import models
from srbh_tpu.tools.export_model import make_serving_fn
from srbh_tpu.train.convert import convert_height_model, convert_rrdbnet
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.predict.predictor import make_city_step
from srbh_tpu_torch.tools import export_model
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TILE = 32


@pytest.fixture(scope="module")
def tiny():
    sr = RRDBNet(num_block=1, num_feat=8, num_grow_ch=8)
    model = SRRegressClsFeature("efficientnet-test", super_mid=8, isaggre=True,
                                chans_build=7, sr_chans=8)
    gen = torch.Generator().manual_seed(0)
    init_weights(sr, gen)
    init_weights(model, gen)
    for name, t in model.state_dict().items():
        if name.endswith("running_mean"):
            t.normal_(0, 0.1, generator=gen)
        elif name.endswith("running_var"):
            t.uniform_(0.5, 1.5, generator=gen)
    with torch.no_grad():
        model.reg.conv_last.bias.fill_(2.0)  # heights survive the clamp
    return model.eval(), sr.eval()


@pytest.fixture(scope="module")
def symbolic(tiny, tmp_path_factory):
    model, sr = tiny
    path = str(tmp_path_factory.mktemp("export") / "flagship.pt2")
    program = export_model.export_flagship(model, sr, tile=TILE,
                                           dtype=torch.float32, device="cpu")
    torch.export.save(program, path)
    return export_model.load_exported(path)


def _x(b):
    return torch.rand(b, TILE, TILE, 8, generator=torch.Generator().manual_seed(b))


def test_roundtrip_symbolic_batch(tiny, symbolic):
    eager = export_model.Serving(*tiny, dtype=torch.float32)
    for b in (2, 3):
        x = _x(b)
        with torch.no_grad():
            got, want = symbolic(x), eager(x)
        assert tuple(got[0].shape) == (b, 4 * TILE, 4 * TILE)
        assert tuple(got[1].shape) == (b, 4 * TILE, 4 * TILE, 7)
        assert got[2].dtype == torch.uint16 and got[3].dtype == torch.uint8
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_float_outputs_match_jax_serving_fn(tiny, symbolic):
    model, sr = tiny
    numpy = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    jm = models.SRRegressClsFeature(encoder_name="efficientnet-test", super_mid=8,
                                    isaggre=True, chans_build=7,
                                    dtype=jnp.float32)
    jsr = models.RRDBNet(num_block=1, num_feat=8, num_grow_ch=8,
                         dtype=jnp.float32)
    fn = jax.jit(make_serving_fn(
        jm, jsr, convert_height_model(numpy(model), True, "efficientnet-test"),
        convert_rrdbnet(numpy(sr), 1), dtype=jnp.float32))
    x = _x(3)
    want = fn(jnp.asarray(x.numpy()))
    with torch.no_grad():
        got = symbolic(x)
    assert np.asarray(want[0]).max() > 0
    for g, w in zip(got[:2], want):
        w = np.asarray(w, np.float64)
        err = (np.abs(g.numpy().astype(np.float64) - w) / (1 + np.abs(w))).max()
        assert err <= 1e-4, err


def test_fixed_batch_bf16_rejects_other_sizes(tiny):
    model, sr = tiny
    fn = export_model.export_flagship(model, sr, tile=TILE, batch=2,
                                      dtype=torch.bfloat16, device="cpu").module()
    x = _x(2)
    with torch.no_grad():
        got = fn(x)
        want = export_model.Serving(model, sr, dtype=torch.bfloat16)(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got[2:], make_city_step(model, sr, dtype=torch.bfloat16,
                                            device="cpu")(x)):
        assert torch.equal(g, w)
    with pytest.raises(Exception):
        fn(_x(3))


def test_main_refuses_half_a_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit):
        export_model.main([str(tmp_path / "out.pt2"), "--ckpt", "model.pt"])
    assert "together" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
