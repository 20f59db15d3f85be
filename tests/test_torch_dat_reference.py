"""The port's DAT (``models/dat.py``) against the benchmark's plain reference
(``benchmark/reference/dat.py``: DAT's eval forward written from the
published description in plain torch, importing nothing of the port), and
DAT through the SR harness's entry points.

Both load one seeded state dict, drawn by the benchmark's rules for the
configuration ``dat_x4`` (``benchmark/drivers/dat_serve.py:dat_weights``)
at the small widths of the test configuration ``dat_tiny`` (embed 32,
windows 4 x 8 and 8 x 4, groups of 4 and 2 blocks: shifted and unshifted
spatial blocks and channel blocks). Cases: one shifted and one unshifted
spatial block, one channel block and one SGFN alone, and whole forwards
through ``swinir_harness.apply`` at sides that are and are not multiples of
the windows. Tolerance 1e-5 (absolute and relative) for a module, 1e-4 for
a whole forward, as ``test_torch_swinir_reference.py`` holds SwinIR:
float32 sums taken in another order (the port sums the bias and the mask
first, and keeps the tokens as (B, H, W, C)). A block with its shift
turned off misses the reference by far more.
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers.dat_serve import dat_weights
from benchmark.reference import dat as ref
from srbh_tpu_torch.data import png
from srbh_tpu_torch.models import dat as tdat
from srbh_tpu_torch.tools import swinir_harness
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TOL, WHOLE = 1e-5, 1e-4
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "tests", "data")
PUBLISHED = os.path.join(os.path.dirname(DATA), "..", "configs",
                         "dat_x4.json")
SEED = 2**31 + 424


def _config(path=os.path.join(DATA, "dat_tiny.json")):
    with open(path) as f:
        return json.load(f)


def _preset(m):
    return dict(upscale=m["upscale"], in_chans=m["in_chans"],
                embed_dim=m["embed_dim"], split_size=tuple(m["split_size"]),
                depth=tuple(m["depth"]), num_heads=tuple(m["num_heads"]),
                expansion_factor=m["expansion_factor"],
                img_range=m["img_range"], num_feat=m["num_feat"])


@pytest.fixture(scope="module")
def pair():
    """(port, reference, state) at the tiny widths, one state loaded."""
    cfg = _config()
    state = dat_weights(cfg, SEED, "cpu")
    port = tdat.DAT(**_preset(cfg["model"])).eval()
    plain = ref.build(cfg).eval()
    port.load_state_dict(state)
    plain.load_state_dict(state)
    return port, plain, state


def _tokens(b, h, w, c, seed):
    return torch.randn((b, h, w, c), generator=torch.Generator().manual_seed(
        seed))


def _flat(x):
    return x.reshape(x.shape[0], -1, x.shape[-1])


def test_the_blocks_shift_as_published(pair):
    port, plain, _ = pair
    got = [(g, b) for g, layer in enumerate(port.layers)
           for b, blk in enumerate(layer.blocks)
           if getattr(blk.attn, "shift", False)]
    # even groups shift block 2, odd groups blocks 0 and 4 (dat_arch.py)
    assert got == [(0, 2), (1, 0)]
    assert got == [(g, b) for g, layer in enumerate(plain.layers)
                   for b, blk in enumerate(layer.blocks)
                   if getattr(blk.attn, "shifted", False)]
    assert [tdat.is_shifted(g, b) for g in (0, 1) for b in range(0, 12, 2)] \
        == [ref.shifted(g, b) for g in (0, 1) for b in range(0, 12, 2)]


@pytest.mark.parametrize("where,side", [
    ((0, 2), (16, 16)),   # a shifted spatial block
    ((0, 0), (16, 16)),   # an unshifted one
    ((1, 0), (12, 20)),   # shifted, padded to the window multiple
    ((0, 1), (12, 20)),   # a channel block
])
def test_attention_modules_match(pair, where, side):
    port, plain, _ = pair
    g, b = where
    pm, rm = port.layers[g].blocks[b].attn, plain.layers[g].blocks[b].attn
    h, w = side
    x = _tokens(2, h, w, 32, 7)
    with torch.no_grad():
        got = pm(x)
        want = rm(_flat(x), h, w)
        # the attention output before the gates, as the benchmark taps it
        got_a = pm.attend(pm.qkv(x))
        want_a = rm.attend(_flat(x), h, w)
    torch.testing.assert_close(_flat(got), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(_flat(got_a), want_a, atol=TOL, rtol=TOL)
    assert float(want.std()) > 1e-3


def test_an_unshifted_block_misses(pair):
    port, plain, state = pair
    pm = tdat.AdaptiveSpatialAttention(32, 4, (4, 8), shift=False)
    prefix = "layers.0.blocks.2.attn."
    pm.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                        if k.startswith(prefix)})
    x = _tokens(2, 16, 16, 32, 8)
    with torch.no_grad():
        err = (_flat(pm.attend(pm.qkv(x)))
               - plain.layers[0].blocks[2].attn.attend(_flat(x), 16, 16))
    assert float(err.abs().max()) > 1e-2


def test_sgfn_matches(pair):
    port, plain, _ = pair
    x = _tokens(2, 12, 20, 32, 9)
    with torch.no_grad():
        got = port.layers[1].blocks[1].ffn(x)
        want = plain.layers[1].blocks[1].ffn(_flat(x), 12, 20)
    torch.testing.assert_close(_flat(got), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("side", [(16, 16), (20, 28), (13, 21)])
def test_whole_forward_through_apply(pair, side):
    port, plain, _ = pair
    h, w = side
    x = torch.rand((2, h, w, 3), generator=torch.Generator().manual_seed(5))
    got = swinir_harness.apply(port, x)
    want = ref.nhwc(plain, x)
    assert got.shape == want.shape == (2, 4 * h, 4 * w, 3)
    assert float(want.std()) > 0.01
    torch.testing.assert_close(got, want, atol=WHOLE, rtol=WHOLE)


def test_state_dict_names_are_equal():
    cfg = _config(PUBLISHED)
    with torch.device("meta"):
        port = tdat.DAT(**swinir_harness._dat_preset("classical_sr", 4))
        plain = ref.build(cfg)
    assert list(port.state_dict()) == list(plain.state_dict())
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}


def test_published_preset_has_14_8_m_parameters():
    with torch.device("meta"):
        model = tdat.DAT(**swinir_harness._dat_preset("classical_sr", 4))
    n = sum(p.numel() for p in model.parameters())
    assert n == 14_802_051
    assert round(n / 1e6, 1) == 14.8


def test_published_derived_buffers_are_dropped_on_load(tmp_path, pair):
    """A state dict as the published file saves it (``params``, with its
    derived buffers) loads through the harness's ``load_weights``."""
    port, _, state = pair
    saved = dict(state)
    saved["layers.0.blocks.0.attn.attns.0.rpe_biases"] = torch.zeros(1)
    saved["layers.0.blocks.0.attn.attns.0.relative_position_index"] = (
        torch.zeros(1))
    saved["layers.0.blocks.2.attn.attn_mask_0"] = torch.zeros(1)
    saved["layers.0.blocks.2.attn.attn_mask_1"] = torch.zeros(1)
    path = str(tmp_path / "dat.pth")
    torch.save({"params": saved}, path)
    fresh = tdat.DAT(**_preset(_config()["model"])).eval()
    swinir_harness.load_weights(fresh, path, "classical_sr")
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_define_model_builds_dat():
    model = swinir_harness.define_model("classical_sr", 4, device="cpu",
                                        arch="dat")
    assert isinstance(model, tdat.DAT) and not model.training
    temps = [p for n, p in model.named_parameters()
             if n.endswith("temperature")]
    assert len(temps) == 18 and all(bool((t == 1).all()) for t in temps)
    with pytest.raises(ValueError):
        swinir_harness.define_model("real_sr", 4, device="cpu", arch="dat")


def test_tiled_inference_and_run_folder_and_main(tmp_path, monkeypatch,
                                                 pair):
    port, plain, _ = pair
    rng = np.random.default_rng(3)
    img = rng.random((20, 24, 3)).astype(np.float32)
    whole = swinir_harness.tiled_inference(
        lambda x: swinir_harness.apply(port, x), img, 4)
    want = ref.nhwc(plain, torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_allclose(whole, want, atol=WHOLE, rtol=WHOLE)
    tiled = swinir_harness.tiled_inference(
        lambda x: swinir_harness.apply(port, x), img, 4, tile=16,
        tile_overlap=8)
    assert tiled.shape == whole.shape and np.isfinite(tiled).all()

    folder = tmp_path / "lq"
    folder.mkdir()
    for k in range(2):
        png.imwrite(str(folder / f"im{k}.png"),
                    (rng.random((12, 10, 3)) * 255).astype(np.uint8))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(swinir_harness, "_dat_preset",
                        lambda *a: _preset(_config()["model"]))
    gt = tmp_path / "gt"
    gt.mkdir()
    for k in range(2):
        png.imwrite(str(gt / f"im{k}.png"),
                    (rng.random((48, 40, 3)) * 255).astype(np.uint8))
        png.imwrite(str(folder / f"im{k}x4.png"),
                    (rng.random((12, 10, 3)) * 255).astype(np.uint8))
    res = swinir_harness.main(["--task", "classical_sr", "--scale", "4",
                               "--arch", "dat", "--folder_gt", str(gt),
                               "--folder_lq", str(folder)], device="cpu")
    assert res["psnr"] is not None and np.isfinite(res["psnr"])
    out = tmp_path / "results" / "dat_classical_sr_x4"
    assert sorted(os.listdir(out)) == ["im0_DAT.png", "im1_DAT.png"]
    assert png.imread(str(out / "im0_DAT.png"), png.IMREAD_COLOR).shape == (
        48, 40, 3)


@pytest.mark.parametrize("masked", [False, True])
def test_the_library_route_matches_the_plain_one(masked):
    """The card's route (``scaled_dot_product_attention`` on q, k, v padded
    from head size 30 to 32, the bias and mask one float mask) on the CPU's
    own backend, against DAT's published product, which the CPU runs."""
    from srbh_tpu_torch.ops import dat_attention

    g = torch.Generator().manual_seed(11)
    qkv = torch.randn((3, 2, 4, 3, 64, 30), generator=g)
    bias = torch.randn((3, 64, 64), generator=g)
    add = bias[None]
    if masked:
        add = bias + torch.where(torch.rand((4, 1, 64, 64), generator=g)
                                 < 0.3, -100.0, 0.0)
    got = dat_attention._sdpa(qkv, add)
    want = dat_attention._plain(qkv, add)
    assert got.shape == want.shape == (2, 4, 3, 64, 30)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert torch.equal(dat_attention.rect_window_attention(qkv, add), want)


def test_weights_derived_are_kept_until_a_weight_changes(pair):
    """A branch keeps its position bias and a block its folded BatchNorms
    as buffers between forwards; ``prepare()`` after an in-place write of a
    weight makes them anew, and so does ``load_state_dict``."""
    port, _, state = pair
    block = port.layers[0].blocks[0].attn
    branch = block.attns[0]
    first, conv_b = branch.bias, block.conv_b
    x = _tokens(1, 16, 16, 32, 3)
    with torch.inference_mode():
        block(x)
    assert branch.bias is first and block.conv_b is conv_b
    with torch.no_grad():
        branch.pos.pos3[2].bias.add_(1.0)
        block.dwconv[1].running_mean.add_(1.0)
    assert branch.bias is first
    port.prepare()
    torch.testing.assert_close(branch.bias, first + 1.0)
    assert not torch.equal(block.conv_b, conv_b)
    prefix = "layers.0.blocks.0.attn."
    block.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                           if k.startswith(prefix)})
    torch.testing.assert_close(branch.bias, first)
    torch.testing.assert_close(block.conv_b, conv_b)
    names = port.state_dict()
    assert prefix + "attns.0.bias" not in names
    assert prefix + "conv_w" not in names
