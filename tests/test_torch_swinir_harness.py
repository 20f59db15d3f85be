"""The port's SwinIR harness and PNG codec against the JAX package's harness
and cv2.

* ``data/png.py`` against cv2: fixtures written here with zlib in every
  colour type (grey, RGB, palette with and without ``tRNS``, grey + alpha,
  RGBA), at 8 and 16 bits where PNG has them, their rows cycling through
  all five filter types; ``imread`` bit-equal to ``cv2.imread`` for
  ``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``;
  ``imwrite`` decoded by cv2 to the same pixels (not the same bytes: zlib
  levels differ); an Adam7-interlaced file raises.
* ``calculate_psnrb`` against the JAX package's (1e-10), and
  ``get_image_pair`` for all seven tasks (the JPEG ones through cv2's
  codec, which the tests' environment has).
* ``run_folder`` and ``main`` against the JAX harness on a few PNGs, with
  both harnesses' models one tiny SwinIR (embed 12, depths (2,)): the full
  presets take too long on a CPU. Metrics within 1e-3 x (1 + |b|)
  and the written ``*_SwinIR.png`` within 1 LSB on 1 % of the pixels:
  outputs are rounded to 8 bits, and float32 rounding of the two frameworks
  flips some of them.
"""
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu.metrics import image as jimage
from srbh_tpu.models import swinir as jswin
from srbh_tpu.tools import swinir_harness as jharness
from srbh_tpu.train.convert import save_tree_npz
from srbh_tpu_torch.convert import swinir_state_dict
from srbh_tpu_torch.data import png
from srbh_tpu_torch.metrics import image as timage
from srbh_tpu_torch.models import swinir as tswin
from srbh_tpu_torch.tools import swinir_harness as tharness
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

# ---------------------------------------------------------------- the codec


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows, bpp):
    """Each byte row filtered with type ``y % 5``, its type byte first."""
    out = []
    prev = np.zeros_like(rows[0])
    for y, cur in enumerate(rows):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][kind]
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def write_fixture(path, samples, ctype, depth, palette=None, trns=None,
                  interlace=0):
    """A PNG of ``samples`` (H, W, C) in colour type ``ctype``."""
    h, w = samples.shape[:2]
    raw = samples.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = np.frombuffer(raw.tobytes(), np.uint8).reshape(h, -1).astype(np.int64)
    bpp = samples.shape[2] * depth // 8
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                          interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp), 9))
    with open(path, "wb") as f:
        f.write(data + _chunk(b"IEND", b""))


CODEC_CASES = [  # colour type, bit depth, palette (with tRNS)
    (0, 8, None), (0, 16, None), (2, 8, None), (2, 16, None), (3, 8, "plain"),
    (3, 8, "trns"), (4, 8, None), (4, 16, None), (6, 8, None), (6, 16, None)]


@pytest.mark.parametrize("ctype,depth,palette", CODEC_CASES)
def test_imread_matches_cv2(tmp_path, ctype, depth, palette):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 41, 37
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    path = str(tmp_path / "f.png")
    if palette:
        colours = rng.integers(0, 256, (40, 3))
        write_fixture(path, rng.integers(0, 40, (h, w, 1)), 3, 8, colours,
                      bytes(rng.integers(0, 256, 30).tolist())
                      if palette == "trns" else None)
    else:
        write_fixture(path, rng.integers(0, 2 ** depth, (h, w, ch)), ctype, depth)
    for flag in (png.IMREAD_COLOR, png.IMREAD_GRAYSCALE, png.IMREAD_UNCHANGED):
        want = cv2.imread(path, flag)
        got = png.imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=f"flag {flag}")


@pytest.mark.parametrize("shape", [(30, 21), (30, 21, 1), (30, 21, 3), (30, 21, 4)])
def test_imwrite_decodes_in_cv2_to_the_same_pixels(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "w.png")
    assert png.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  np.squeeze(img, -1) if shape[-1:] == (1,) else img)


def test_interlaced_and_foreign_files_raise(tmp_path):
    path = str(tmp_path / "adam7.png")
    write_fixture(path, np.zeros((8, 8, 3)), 2, 8, interlace=1)
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        png.imread(path)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="x.jpg: not a PNG"):
        png.imread(str(tmp_path / "x.jpg"))


# ------------------------------------------------------------------ PSNR-B

@pytest.mark.parametrize("shape,crop,y", [((48, 40), 0, False),
                                          ((48, 40, 3), 4, False),
                                          ((64, 56, 3), 0, True)])
def test_psnrb_matches_jax(shape, crop, y):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)
    # blocky: 8x8 means of b, so the blocking factor is not 0
    blocky = b.astype(np.float64)
    h, w = shape[0] // 8 * 8, shape[1] // 8 * 8
    blocky[:h, :w] = blocky[:h, :w].reshape(h // 8, 8, w // 8, 8, *shape[2:]).mean(
        (1, 3), keepdims=True).repeat(8, 1).repeat(8, 3).reshape(h, w, *shape[2:])
    for img in (b, blocky.round().astype(np.uint8)):
        want = jimage.calculate_psnrb(img, a, crop_border=crop, test_y_channel=y)
        got = timage.calculate_psnrb(img, a, crop_border=crop, test_y_channel=y)
        assert abs(got - want) <= 1e-10 * max(1.0, abs(want))
    assert timage._blocking_effect_factor(blocky[..., 0] / 255.0 if blocky.ndim == 3
                                          else blocky / 255.0) > 0


# --------------------------------------------------------- images and pairs

def _image(rng, h, w, i):
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 90 * np.sin((xx + 5 * i) / (4.0 + c)) * np.cos(yy / (5.0 + i))
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two BGR PNGs of 24x20 (``gt``) and their x2 LR (``lq``: 12x10,
    ``<name>x2.png``), written by cv2."""
    root = tmp_path_factory.mktemp("swinir_pngs")
    rng = np.random.default_rng(3)
    for d in ("gt", "lq"):
        os.makedirs(root / d)
    for i in range(2):
        hr = _image(rng, 24, 20, i)
        cv2.imwrite(str(root / "gt" / f"im{i}.png"), hr)
        cv2.imwrite(str(root / "lq" / f"im{i}x2.png"),
                    cv2.resize(hr, (10, 12), interpolation=cv2.INTER_AREA))
    return root


@pytest.mark.parametrize("task", jharness.TASKS)
def test_get_image_pair_matches_jax(folders, task):
    path = str(folders / "gt" / "im1.png")
    lq_dir = str(folders / "lq")
    want = jharness.get_image_pair(task, path, lq_dir, scale=2, noise=25, jpeg=30)
    got = tharness.get_image_pair(task, path, lq_dir, scale=2, noise=25, jpeg=30)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_jpeg_tasks_need_cv2(folders, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for task in ("jpeg_car", "color_jpeg_car"):
        with pytest.raises(ImportError):
            tharness.get_image_pair(task, str(folders / "gt" / "im0.png"))


# -------------------------------------------------------- run_folder, main

def _tiny_kw(task, scale):
    gray = task in ("gray_dn", "jpeg_car")
    jpeg = task in ("jpeg_car", "color_jpeg_car")
    sr = task in ("classical_sr", "lightweight_sr")
    return dict(embed_dim=12, depths=(2,), num_heads=(2,),
                window_size=7 if jpeg else 8, mlp_ratio=2,
                upscale=scale if sr else 1, in_chans=1 if gray else 3,
                out_chans=1 if gray else 3, img_range=255.0 if jpeg else 1.0,
                upsampler="pixelshuffle" if sr else "", resi_connection="1conv",
                num_feat=16)


def _tiny_pair(task, scale):
    kw = _tiny_kw(task, scale)
    jm = jswin.SwinIR(**kw)
    v = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, kw["in_chans"]))))
    tm = tswin.SwinIR(**kw)
    tm.load_state_dict(swinir_state_dict(v, kw["depths"], kw["upsampler"]))
    return jm, v, tm.eval()


def _same_outputs(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for n in names:
        a = cv2.imread(os.path.join(got_dir, n), cv2.IMREAD_UNCHANGED).astype(int)
        b = cv2.imread(os.path.join(want_dir, n), cv2.IMREAD_UNCHANGED).astype(int)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-2, n


def _same_metrics(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert (got[k] is None) == (w is None), k
        if w is not None:
            assert abs(got[k] - w) <= 1e-3 * (1 + abs(w)), (k, got[k], w)


@pytest.mark.parametrize("task,scale,tile", [("color_dn", 1, None),
                                             ("classical_sr", 2, 16),
                                             ("color_jpeg_car", 1, None)])
def test_run_folder_matches_jax(folders, tmp_path, monkeypatch, task, scale, tile):
    jm, v, tm = _tiny_pair(task, scale)
    monkeypatch.setattr(jharness, "define_model", lambda *a, **k: jm)
    kw = dict(folder_lq=str(folders / "lq"), tile=tile, tile_overlap=8)
    want = jharness.run_folder(task, str(folders / "gt"), v, scale,
                               save_dir=str(tmp_path / "jax"), **kw)
    got = tharness.run_folder(task, str(folders / "gt"), tm, scale,
                              save_dir=str(tmp_path / "port"), device="cpu", **kw)
    _same_metrics(got, want)
    assert got["psnr"] is not None and np.isfinite(got["psnr"])
    assert (got["psnrb"] is not None) == (task == "color_jpeg_car")
    _same_outputs(tmp_path / "port", tmp_path / "jax")


def test_main_matches_jax(folders, tmp_path, monkeypatch, capsys):
    """``main`` with ``--model_path``: a JAX npz to both harnesses, and the
    same weights as a torch state dict (under ``params``) to the port's."""
    jm, v, tm = _tiny_pair("color_dn", 1)
    npz = str(tmp_path / "swinir.npz")
    save_tree_npz(npz, {"params": v["params"]})
    pth = str(tmp_path / "swinir.pth")
    torch.save({"params": tm.state_dict()}, pth)
    monkeypatch.setattr(jharness, "define_model", lambda *a, **k: jm)
    monkeypatch.setattr(tharness, "define_model", lambda *a, device=None, **k:
                        tswin.SwinIR(**_tiny_kw("color_dn", 1)).to(device))
    args = ["--task", "color_dn", "--folder_gt", str(folders / "gt")]
    out = "results/swinir_color_dn_x1"
    runs = {}
    for name, harness, extra in (("jax", jharness, {}), ("port", tharness, {"device": "cpu"}),
                                 ("pth", tharness, {"device": "cpu"})):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        path = pth if name == "pth" else npz
        runs[name] = harness.main(args + ["--model_path", path], **extra)
    _same_metrics(runs["port"], runs["jax"])
    _same_outputs(tmp_path / "port" / out, tmp_path / "jax" / out)
    assert runs["pth"] == runs["port"]
    capsys.readouterr()
    tharness.main(args, device="cpu")
    assert "no --model_path: random init (smoke mode)" in capsys.readouterr().out
