"""Options of the JAX package's modules that the port takes too.

At tiny widths, weights carried from the JAX modules with ``convert.py``
and inputs made with numpy from a seed, against the JAX package on the CPU:

* SwinIR without the attention's ``qkv`` bias and without the patch
  embedding's LayerNorm (JAX through its XLA path, the port through
  ``window_attention_reference``): whole model within 1e-4, the bound of
  ``tests/test_torch_swinir.py``;
* ``SRRegressClsNosuper`` at ``upscale`` 2 and 8, within 1e-5 (the bound of
  ``tests/test_torch_eval.py``'s nosuper test); the classes that fuse x4 SR
  features (``SRRegressClsFeature``, ``-Geo``, ``-Refine``,
  ``SRRegressClsDecision``) refuse ``upscale`` 2 when built, where the JAX
  classes fail at their first call;
* ``MBConv(se_ratio=0.5)`` and ``ConvBNAct`` at kernel 1 / stride 2 / with a
  bias / with another activation and BatchNorm momentum, in eval and in
  training mode (outputs and updated running statistics), within 1e-5, the
  bound of ``tests/test_torch_layers.py``;
* the memory-mapped ``TiffReader`` with its chunk cache: every 64-px window
  at a 56-px stride of a striped LZW file and a tiled PackBits file equals a
  fresh uncached reader's read byte for byte, the cache never holds more
  than ``max_cache_bytes`` (0 included), a zero-length file is refused as
  not a TIFF, and ``close()`` may be called twice;
* ``DataLoader(prefetch=)``: values below 1 raise with the JAX loader's
  message, and the batches are the same for 1, 2 and 4.
"""
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from srbh_tpu.models import efficientnet as jeff
from srbh_tpu.models import height_model as jheight
from srbh_tpu.models import layers as jlayers
from srbh_tpu.models import sr_regress as jsrr
from srbh_tpu.models import swinir as jswin
from srbh_tpu_torch import convert, native
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
from srbh_tpu_torch.models import efficientnet as teff
from srbh_tpu_torch.models import height_model as theight
from srbh_tpu_torch.models import layers as tlayers
from srbh_tpu_torch.models import sr_regress as tsrr
from srbh_tpu_torch.models import swinir as tswin
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

ENC, DEC = "efficientnet-test", (32, 24, 16, 12, 8)
TOL, SWIN_TOL = 1e-5, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in tree.items()}


# ------------------------------------------------------------------ SwinIR


class _NoQkvBias(jswin.WindowAttention):
    """The JAX WindowAttention without the qkv bias: the JAX SwinIR has no
    field that reaches it, so its blocks build this class in the test."""

    qkv_bias: bool = False


@pytest.mark.parametrize("qkv_bias,patch_norm", [(False, True), (True, False),
                                                 (False, False)])
def test_swinir_options_match_jax(monkeypatch, qkv_bias, patch_norm):
    if not qkv_bias:
        monkeypatch.setattr(jswin, "WindowAttention", _NoQkvBias)
    depths = (2, 2)
    kw = dict(embed_dim=12, depths=depths, num_heads=(2, 2), window_size=8,
              mlp_ratio=2, upscale=2, upsampler="pixelshuffle", num_feat=16,
              patch_norm=patch_norm)
    jm = jswin.SwinIR(**kw)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32, 32, 3))))
    tm = tswin.SwinIR(**kw, qkv_bias=qkv_bias, use_kernel=False).eval()
    sd = convert.swinir_state_dict(v, depths, "pixelshuffle")
    assert any(k.endswith("attn.qkv.bias") for k in sd) == qkv_bias
    assert any(k.startswith("patch_embed.norm") for k in sd) == patch_norm
    tm.load_state_dict(sd, strict=True)
    x = np.random.default_rng(1).uniform(0, 1, (2, 30, 30, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (2, 60, 60, 3)
    np.testing.assert_allclose(got, want, atol=SWIN_TOL, rtol=SWIN_TOL)


def test_mlp_out_width_matches_jax():
    x = rand(2, 5, 6, seed=2)
    jm = jswin.Mlp(hidden=10, out=4)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = tswin.Mlp(6, 10, out=4)
    sd = {}
    for name in ("fc1", "fc2"):
        convert._dense(sd, name, v["params"][name])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, 4)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=TOL, rtol=TOL)
    assert tswin.Mlp(6, 10).fc2.out_features == 6


# --------------------------------------------------------- height models


@functools.lru_cache(maxsize=None)
def _nosuper_vars(upscale):
    jm = jheight.SRRegressClsNosuper(encoder_name=ENC, upscale=upscale,
                                     isaggre=True, chans_build=7,
                                     decoder_channels=DEC,
                                     drop_connect_rate=0.0)
    v = jax.device_get(dict(jax.jit(jm.init)(jax.random.PRNGKey(upscale),
                                             jnp.zeros((1, 32, 32, 8)))))
    v["batch_stats"] = _random_stats(v["batch_stats"],
                                     np.random.default_rng(upscale))
    return jm, v


@pytest.mark.parametrize("upscale", [2, 8])
def test_nosuper_at_other_scales_matches_jax(upscale):
    jm, v = _nosuper_vars(upscale)
    tm = theight.SRRegressClsNosuper(ENC, isaggre=True, chans_build=7,
                                     decoder_channels=DEC,
                                     upscale=upscale).eval()
    tm.load_state_dict(convert.nosuper_state_dict(v, ENC, True), strict=True)
    x = rand(2, 32, 32, 8, seed=upscale)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    side = 32 * upscale
    assert [tuple(g.shape) for g in got] == [(2, 1, side, side),
                                             (2, 7, side, side),
                                             (2, 1, 32, 32)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=TOL, rtol=TOL)


FUSED = {
    "SRRegressClsFeature": (theight.SRRegressClsFeature, dict(super_mid=8,
                                                               sr_chans=8)),
    "SRRegressClsFeatureGeo": (theight.SRRegressClsFeatureGeo,
                               dict(super_mid=8, sr_chans=8)),
    "SRRegressClsFeatureRefine": (theight.SRRegressClsFeatureRefine,
                                  dict(super_mid=8, sr_chans=8)),
    "SRRegressClsDecision": (tsrr.SRRegressClsDecision, dict(super_mid=8)),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_classes_fusing_x4_features_refuse_other_scales(name):
    cls, kw = FUSED[name]
    with pytest.raises(ValueError, match="upscale 2: the .* features are x4"):
        cls(ENC, decoder_channels=DEC, upscale=2, **kw)
    assert cls(ENC, decoder_channels=DEC, upscale=4, **kw) is not None


@pytest.mark.parametrize("name", ["SRRegressClsFeature",
                                  "SRRegressClsDecision"])
def test_the_jax_class_fails_there_too(name):
    if name == "SRRegressClsFeature":
        jm = jheight.SRRegressClsFeature(encoder_name=ENC, super_mid=8,
                                         upscale=2, decoder_channels=DEC)
        xs = (jnp.zeros((1, 32, 32, 8)), jnp.zeros((1, 128, 128, 8)))
    else:
        jm = jsrr.SRRegressClsDecision(encoder_name=ENC, super_mid=8,
                                       upscale=2, decoder_channels=DEC)
        xs = (jnp.zeros((1, 32, 32, 8)),)
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), *xs)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("train", [False, True])
def test_mbconv_se_ratio_matches_jax(train):
    x = rand(2, 8, 8, 16, seed=3)
    jm = jeff.MBConv(out_ch=16, expand_ratio=2, kernel=3, stride=1,
                     se_ratio=0.5)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    stats = _random_stats(v["batch_stats"], np.random.default_rng(3))
    want, upd = jm.apply({"params": v["params"], "batch_stats": stats},
                         jnp.asarray(x), train=train, mutable=["batch_stats"])
    sd = {}
    convert._mbconv(sd, "", v["params"], stats)
    tm = teff.MBConv(16, 16, 2, 3, 1, se_ratio=0.5).train(train)
    assert tm._se_reduce.out_channels == 8  # int(16 * 0.5)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL, rtol=TOL)
    if train:
        want_sd = {}
        convert._mbconv(want_sd, "", v["params"], jax.device_get(upd["batch_stats"]))
        for k, t in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), want_sd[k].numpy(),
                                           atol=TOL, rtol=TOL, err_msg=k)


CONV_BN_ACT = {  # name: (JAX fields, the port's keyword arguments)
    "k1_s2_bias": (dict(kernel_size=1, stride=2, use_bias=True),
                   dict(kernel_size=1, stride=2, use_bias=True)),
    "silu_momentum": (dict(act=fnn.silu, bn_momentum=0.8, bn_epsilon=1e-3),
                      dict(act=torch.nn.SiLU, bn_momentum=0.2,
                           bn_epsilon=1e-3)),
    "no_act": (dict(act=None), dict(act=None)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_BN_ACT))
def test_conv_bn_act_options_match_jax(case, train):
    jkw, tkw = CONV_BN_ACT[case]
    x = rand(2, 7, 7, 5, seed=4)
    jm = jlayers.ConvBNAct(6, **jkw)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    stats = _random_stats(v["batch_stats"], np.random.default_rng(5))
    want, upd = jm.apply({"params": v["params"], "batch_stats": stats},
                         jnp.asarray(x), train=train, mutable=["batch_stats"])
    sd = {}
    convert._conv(sd, "0", v["params"]["conv"])
    convert._bn(sd, "1", v["params"]["bn"], stats["bn"])
    tm = tlayers.ConvBNAct(5, 6, **tkw).train(train)
    assert len(tm) == (2 if tkw.get("act", 1) is None else 3)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL, rtol=TOL)
    bn = jax.device_get(upd["batch_stats"]["bn"])
    np.testing.assert_allclose(tm[1].running_mean.numpy(), bn["mean"],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tm[1].running_var.numpy(), bn["var"],
                               atol=TOL, rtol=TOL)


# ------------------------------------------------------------- TIFF reader


def _windows(width, height, size=64, stride=56):
    xs = list(range(0, width - size + 1, stride)) + [width - size]
    ys = list(range(0, height - size + 1, stride)) + [height - size]
    return [(x, y, size, size) for x in xs for y in ys]


@pytest.fixture(scope="module")
def tiffs(tmp_path_factory):
    """A striped LZW file (libtiff's, through cv2: neither package writes
    LZW) and a tiled PackBits file (assembled here)."""
    import cv2

    root = tmp_path_factory.mktemp("cached_tiff")
    rng = np.random.default_rng(8)
    striped = np.repeat(rng.integers(0, 4000, (300, 125)), 2,
                        axis=1).astype(np.uint16)
    assert cv2.imwrite(str(root / "lzw.tif"), striped,
                       [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    striped = striped[..., None]
    tiled = rng.integers(0, 4, (200, 180, 2)).astype(np.uint8)
    _write_tiled_packbits(str(root / "tiled.tif"), tiled, 64)
    return {"lzw": (root / "lzw.tif", striped),
            "tiled": (root / "tiled.tif", tiled)}


def _write_tiled_packbits(path, arr, tile):
    """A little-endian TIFF of ``arr`` (H, W, C, uint8) in ``tile``-square
    PackBits tiles, edge tiles zero-padded."""
    import struct

    h, w, c = arr.shape
    tiles = []
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            t = np.zeros((tile, tile, c), np.uint8)
            part = arr[ty: ty + tile, tx: tx + tile]
            t[: part.shape[0], : part.shape[1]] = part
            tiles.append(native.packbits_encode(t.tobytes()))
    n = len(tiles)
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 8),
               (259, 3, 1, 32773), (262, 3, 1, 1), (277, 3, 1, c),
               (284, 3, 1, 1), (322, 3, 1, tile), (323, 3, 1, tile)]
    ifd_size = 2 + 12 * (len(entries) + 2) + 4
    offsets_at = 8 + ifd_size
    counts_at = offsets_at + 4 * n
    data_at = counts_at + 4 * n
    offsets, pos = [], data_at
    for t in tiles:
        offsets.append(pos)
        pos += len(t)
    entries += [(324, 4, n, offsets_at), (325, 4, n, counts_at)]
    out = bytearray(b"II" + struct.pack("<HI", 42, 8))
    out += struct.pack("<H", len(entries))
    for tag, typ, cnt, val in sorted(entries):
        fmt = "<HHIHH" if typ == 3 and cnt == 1 else "<HHII"
        out += (struct.pack(fmt, tag, typ, cnt, val, 0) if fmt == "<HHIHH"
                else struct.pack(fmt, tag, typ, cnt, val))
    out += struct.pack("<I", 0)
    out += struct.pack(f"<{n}I", *offsets)
    out += struct.pack(f"<{n}I", *[len(t) for t in tiles])
    for t in tiles:
        out += t
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("bound", [512 << 20, 40_000, 0])
@pytest.mark.parametrize("kind", ["lzw", "tiled"])
def test_cached_reader_equals_a_fresh_uncached_read(tiffs, kind, bound):
    path, arr = tiffs[kind]
    r = TiffReader(str(path), max_cache_bytes=bound)
    assert r.tiled == (kind == "tiled")
    assert r.compression == (5 if kind == "lzw" else 32773)
    assert len(r.chunk_offsets) > 4
    np.testing.assert_array_equal(r.read(), arr)
    for window in _windows(arr.shape[1], arr.shape[0]):
        fresh = TiffReader(str(path), max_cache_bytes=0)
        got, want = r.read(window), fresh.read(window)
        assert got.tobytes() == want.tobytes(), window
        assert not fresh._cache and fresh._cache_bytes == 0
        x, y, xs, ys = window
        np.testing.assert_array_equal(got, arr[y: y + ys, x: x + xs])
        assert r._cache_bytes <= bound
        assert r._cache_bytes == sum(a.nbytes for a in r._cache.values())
    if bound == 512 << 20:
        chunks = len(r.chunk_offsets)
        assert len(r._cache) == chunks  # every chunk decoded once
    r.close()
    r.close()
    assert not r._cache and r._cache_bytes == 0


def test_zero_length_file_is_refused(tmp_path):
    (tmp_path / "empty.tif").write_bytes(b"")
    with pytest.raises(ValueError, match="not a TIFF"):
        TiffReader(str(tmp_path / "empty.tif"))


def test_reader_maps_the_file(tmp_path):
    import mmap

    write_tiff(str(tmp_path / "a.tif"), np.zeros((8, 8, 1), np.uint8))
    r = TiffReader(str(tmp_path / "a.tif"))
    assert isinstance(r._buf, mmap.mmap)
    r.close()
    assert r._buf == b""


# ------------------------------------------------------------------ loader


class _Samples:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "i": np.int64(i)}


def test_loader_refuses_prefetch_below_one():
    with pytest.raises(ValueError, match="prefetch must be >= 1, got 0"):
        DataLoader(_Samples(), batch_size=4, prefetch=0)


def test_loader_batches_do_not_depend_on_prefetch():
    def epoch(prefetch):
        loader = DataLoader(_Samples(), batch_size=4, shuffle=True,
                            num_workers=0, seed=3, device_put=True,
                            device="cpu", prefetch=prefetch)
        batches = list(loader)
        return [b["i"].tolist() for b in batches], [b["x"] for b in batches]

    want_i, want_x = epoch(1)
    assert sorted(sum(want_i, [])) == list(range(11)) and len(want_i) == 3
    for prefetch in (2, 4):
        got_i, got_x = epoch(prefetch)
        assert got_i == want_i
        for g, w in zip(got_x, want_x):
            assert torch.equal(g, w)


# --------------------------------------------------- nosuper x2 end to end


def test_trainer_runs_nosuper_at_x2(tmp_path):
    """``trainer.main`` and ``main_test`` of the nosuper ablation at
    ``upscale`` 2 on 32x32 tiles with 64x64 height tiles (one epoch of two
    steps): heights and classes come out at 64x64, and every test pixel is
    counted."""
    import os

    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.steps import make_predict_step
    from srbh_tpu_torch.train.trainer import main, main_test

    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(8)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(tmp_path / d)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for n in names:
        write_tiff(str(tmp_path / "s2c" / n),
                   rng.integers(0, 5000, (32, 32, 6)).astype(np.uint16), gt)
        write_tiff(str(tmp_path / "s1c" / n),
                   rng.uniform(-25, 5, (32, 32, 2)).astype(np.float32), gt)
        write_tiff(str(tmp_path / "bhc" / n),
                   rng.integers(0, 100, (64, 64)).astype(np.uint8),
                   (gt[0], 5.0, 0, gt[3], 0, -5.0))
    with open(tmp_path / "dl.csv", "w") as f:
        f.writelines(f"{n},s1c,s2c,bhc\n" for n in names)
    np.savetxt(tmp_path / "s2c_minmax.txt",
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(tmp_path / "s1c_minmax.txt",
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(tmp_path / "bh_stats.txt", hist)
    cfg = TrainConfig(
        datapath=str(tmp_path), trainlist="dl.csv", vallist="dl.csv",
        testlist="dl.csv", logdir=str(tmp_path / "logs"),
        logdirhr=str(tmp_path / "none"), datastats=str(tmp_path),
        preweight=str(tmp_path / "bh_stats.txt"), s1dir="s1c", s2dir="s2c",
        bhdir="bhc", maxepoch=1, batch_size=4, num_workers=0,
        encoder_name=ENC, model_variant="nosuper", upscale=2, isaggre=False)
    state = main(cfg, device="cpu")
    assert state.step == 2 and state.sr_model is None
    image = rand(1, 32, 32, 8, seed=9)
    height, logits = make_predict_step(state.model, None, device="cpu")(image)
    assert tuple(height.shape) == (1, 64, 64)
    assert tuple(logits.shape) == (1, 64, 64, cfg.chans_build)
    res = main_test(cfg, num_sample=0, suffix="x2", device="cpu")
    assert np.isfinite(res["rmse"])
    seg = open(str(tmp_path / "logs" / "acc1x2_0_seg.csv")).read().splitlines()
    counts = [list(map(float, r.split(",")[:cfg.chans_build]))
              for r in seg[6:]]
    assert sum(map(sum, counts)) == 8 * 64 * 64
