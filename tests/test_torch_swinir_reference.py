"""The port's SwinIR against the benchmark's plain reference
(``benchmark/reference/swinir.py``: SwinIR's eval forward written from the
published description in plain torch, importing nothing of the port).

Both load one seeded state dict, drawn by the benchmark's rules for the
configuration ``swinir_x4`` (``benchmark/drivers/sr_serve.py:swin_weights``)
at small widths: the real-world x4 head (``nearest+conv``) over two RSTBs
of two blocks each, so that every case runs an unshifted and a shifted
block (``img_size`` 64 > window 8). Cases: ``3conv`` tails with 8 heads,
``1conv`` with 6 heads, and an input that needs reflect padding. Tolerance
1e-4 (absolute and relative), as ``test_torch_swinir.py`` holds the port to
the JAX package: float32 sums taken in another order through the blocks.
"""
import json
import os

import pytest
import torch

from benchmark.drivers.sr_serve import swin_weights
from benchmark.reference import swinir as ref
from srbh_tpu_torch.models import swinir as tswin
from srbh_tpu_torch.tools import swinir_harness
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "tests", "data", "swinir_tiny.json")
CASES = [  # resi_connection, heads, input side
    ("3conv", 8, 32),
    ("1conv", 6, 32),
    ("3conv", 8, 30),
]


def _config(resi, heads):
    with open(TINY) as f:
        cfg = json.load(f)
    cfg["model"].update(resi_connection=resi, num_heads=[heads, heads])
    if resi == "1conv":
        cfg["weights"]["gains"] = {k.replace("conv.4", "conv"): g for k, g in
                                   cfg["weights"]["gains"].items()}
    return cfg


def _port(cfg):
    m = cfg["model"]
    return tswin.SwinIR(
        in_chans=m["in_chans"], out_chans=m["out_chans"],
        embed_dim=m["embed_dim"], depths=tuple(m["depths"]),
        num_heads=tuple(m["num_heads"]), window_size=m["window_size"],
        mlp_ratio=m["mlp_ratio"], upscale=m["upscale"],
        img_range=m["img_range"], upsampler=m["upsampler"],
        resi_connection=m["resi_connection"], num_feat=m["num_feat"],
        img_size=m["img_size"]).eval()


@pytest.mark.parametrize("resi,heads,side", CASES)
def test_port_matches_the_reference(resi, heads, side):
    cfg = _config(resi, heads)
    state = swin_weights(cfg, 2**31 + 97, "cpu")
    port, plain = _port(cfg), ref.build(cfg).eval()
    port.load_state_dict(state)
    plain.load_state_dict(state)
    assert [b.shift_size for layer in port.layers
            for b in layer.residual_group.blocks] == [0, 4, 0, 4]
    assert [b.shift for layer in plain.layers
            for b in layer.residual_group.blocks] == [0, 4, 0, 4]
    x = torch.rand((2, side, side, 3), generator=torch.Generator().manual_seed(5))
    got = swinir_harness.apply(port, x)
    want = ref.nhwc(plain, x)
    assert got.shape == want.shape == (2, 4 * side, 4 * side, 3)
    assert float(want.std()) > 0.01
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_one_state_dict_loads_into_both():
    cfg = _config("3conv", 8)
    state = swin_weights(cfg, 2**31 + 98, "cpu")
    for module in (_port(cfg), ref.build(cfg)):
        res = module.load_state_dict(state, strict=False)
        assert not res.missing_keys and not res.unexpected_keys


def test_published_widths_have_one_set_of_names_and_shapes():
    """SwinIR-L real-world x4: the harness's preset and the reference built
    from ``benchmark/configs/swinir_x4.json`` (on the meta device)."""
    path = os.path.join(os.path.dirname(os.path.dirname(TINY)), os.pardir,
                        "configs", "swinir_x4.json")
    with open(path) as f:
        cfg = json.load(f)
    with torch.device("meta"):
        port = tswin.SwinIR(**swinir_harness._preset("real_sr", 4, True))
        plain = ref.build(cfg)
    a = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    b = {k: tuple(v.shape) for k, v in plain.state_dict().items()}
    assert a == b
    assert sum(v.numel() for v in plain.parameters()) == 28_268_539
