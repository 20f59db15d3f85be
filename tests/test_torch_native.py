"""The port's native host codec (``srbh_tpu_torch/native``) against its plain
versions and the JAX package.

* PackBits encode and decode equal the Python codecs of ``data/tiff.py``
  byte for byte (and the JAX package's native ones); a malformed stream
  raises where the JAX wrapper falls back; a truncated one is zero-filled
  like the Python decoder's output.
* LZW: a file that libtiff wrote (through cv2) decodes to its pixels, and
  each strip decodes to the Python decoder's bytes; a malformed stream
  raises.
* ``blend_tiles`` (through ``MosaicAccumulator.add_batch``) gives the
  mosaic of ``add_batch_plain`` and of the JAX stitcher, uint8 and uint16
  build tiles; a tile outside the canvas raises before anything is added.
* A failed build raises. A second build of an unchanged source (the codec's
  or the window-attention kernel's, through the shared ``native.build``)
  returns the library already built without running the compiler.
"""
import hashlib
import os

import cv2
import numpy as np
import pytest

from srbh_tpu import native as jnative
from srbh_tpu.data import tiff as jtiff
from srbh_tpu.predict.stitcher import MosaicAccumulator as JaxMosaic
from srbh_tpu_torch import native
from srbh_tpu_torch.data import tiff
from srbh_tpu_torch.ops import window_attention as wa
from srbh_tpu_torch.predict.stitcher import MosaicAccumulator
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _streams():
    rng = np.random.default_rng(0)
    runs = np.repeat(rng.integers(0, 256, 400), rng.integers(1, 300, 400))
    return {
        "empty": b"",
        "one": b"\x07",
        "noise": rng.integers(0, 256, 5000).astype(np.uint8).tobytes(),
        "runs": runs.astype(np.uint8).tobytes(),
        "mixed": np.concatenate([runs[:3000], rng.integers(0, 4, 3000)]
                                ).astype(np.uint8).tobytes(),
        "u16_raster": rng.integers(0, 5000, (64, 64, 6)).astype("<u2").tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_packbits_equals_the_python_codec(name):
    data = _streams()[name]
    enc = native.packbits_encode(data)
    assert enc == tiff._packbits_encode(data)
    assert enc == jnative.packbits_encode(data)
    assert native.packbits_decode(enc, len(data)) == data
    assert tiff._packbits_decode(enc, len(data)) == data


def test_packbits_malformed_raises_truncated_zero_fills():
    with pytest.raises(ValueError, match="malformed PackBits"):
        native.packbits_decode(b"\x02abc\xfd", 10)  # a run header, no byte
    assert jnative.packbits_decode(b"\x02abc\xfd", 10) is None
    short = native.packbits_decode(b"\x02abc", 8)
    assert short == b"abc" + b"\x00" * 5
    assert short[:3] == tiff._packbits_decode(b"\x02abc", 8)


@pytest.mark.parametrize("dtype", ["u1", "<u2"])
def test_lzw_libtiff_file_decodes_to_its_pixels(tmp_path, dtype):
    rng = np.random.default_rng(3)
    img = np.repeat(rng.integers(0, 250 if dtype == "u1" else 60000,
                                 (64, 40)), 3, axis=1)[:, :96].astype(dtype)
    p = str(tmp_path / "l.tif")
    assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    r = tiff.TiffReader(p)
    assert r.compression == 5
    np.testing.assert_array_equal(tiff.read_tiff(p)[..., 0], img)
    np.testing.assert_array_equal(tiff.read_tiff(p), jtiff.read_tiff(p))
    row_bytes = r.width * r.spp * r.bits // 8
    with open(p, "rb") as f:
        buf = f.read()
    for off, count in zip(r.chunk_offsets, r.chunk_counts):
        stream = buf[off: off + count]
        want = tiff._lzw_decode(stream, r.rows_per_strip * row_bytes)
        assert native.lzw_decode(stream, len(want)) == want


def test_lzw_malformed_raises():
    with pytest.raises(ValueError, match="malformed LZW"):
        native.lzw_decode(b"\xff\xff\xff\xff", 16)  # first code not a literal


def test_packbits_tiff_bytes_equal_jax(tmp_path):
    arr = np.random.default_rng(4).integers(0, 3, (70, 33, 2)).astype(np.uint16)
    a, b = str(tmp_path / "a.tif"), str(tmp_path / "b.tif")
    tiff.write_tiff(a, arr, compress="PACKBITS")
    jtiff.write_tiff(b, arr, compress="PACKBITS")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(tiff.read_tiff(b), arr)


def _tiles(seed, n=6, t=16, c=7, dtype=np.uint16):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 3000, (n, t, t)).astype(np.uint16)
    b = rng.integers(0, 255, (n, t, t, c)).astype(dtype)
    pos = np.stack([rng.integers(0, 9, n), rng.integers(0, 7, n),
                    rng.integers(1, 5, n), rng.integers(1, 5, n)], 1)
    return h, b, pos


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_blend_tiles_equals_plain_and_jax(dtype):
    acc, plain, jax_acc = (cls(12, 10, 7) for cls in
                           (MosaicAccumulator, MosaicAccumulator, JaxMosaic))
    for seed in range(3):
        h, b, pos = _tiles(seed, dtype=dtype)
        acc.add_batch(h, b, pos)
        plain.add_batch_plain(h, b, pos)
        jax_acc.add_batch(h, b, pos)
    for a, p, j in zip(acc.finalize(), plain.finalize(), jax_acc.finalize()):
        assert a.dtype == p.dtype == j.dtype
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(a, j)
    np.testing.assert_array_equal(acc.build_sum, plain.build_sum)


@pytest.mark.parametrize("bad", [(-1, 0, 2, 2), (10, 0, 3, 2), (0, 8, 2, 3),
                                 (0, 0, 5, 1)])
def test_blend_tiles_outside_the_canvas_raises(bad):
    acc = MosaicAccumulator(12, 10, 7)
    h, b, pos = _tiles(1)
    pos[-1] = bad
    with pytest.raises(ValueError, match="leaves"):
        acc.add_batch(h, b, pos)
    assert not acc.weight.any() and not acc.height_sum.any()


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library()
    assert not os.listdir(tmp_path / "build")


def test_the_library_is_built_from_the_ports_source():
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.get_lib()._name == str(path)


def _refuse(*args, **kwargs):
    raise AssertionError("the compiler ran for a source already built")


@pytest.mark.parametrize("log", [False, True])
def test_a_second_build_reuses_the_library(tmp_path, monkeypatch, log):
    """The shared builder's cache: the second build of an unchanged source
    returns the first one's path (and, with ``log``, the compiler's output
    kept beside it) and runs no compiler."""
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 7; }\n')
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")

    def command(out):
        return ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", str(out)]

    path, out = native.build(src, "probe", command, log=log)
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libprobe_")
    assert path.with_suffix(".log").exists() == log
    monkeypatch.setattr(native.subprocess, "run", _refuse)
    assert native.build(src, "probe", command, log=log) == (
        path, out if log else "")
    assert sorted(os.listdir(native.BUILD_DIR)) == sorted(
        [path.name] + [path.with_suffix(".log").name] * log)


def test_the_kernel_already_built_is_not_rebuilt(tmp_path, monkeypatch):
    """``build_kernel`` takes the library and its log that a build of the
    same source left (the names a hash of the source) without looking for
    nvcc, and returns the log's text; a library without its log is
    rebuilt."""
    src = tmp_path / "window_attention.cu"
    src.write_text("// the kernel\n")
    monkeypatch.setattr(wa, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = tmp_path / f"libwindow_attention_{tag}.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info: 0 bytes spill stores\n")
    monkeypatch.setattr(native.subprocess, "run", _refuse)
    monkeypatch.setattr(wa, "_nvcc", lambda: "nvcc")
    assert wa.build_kernel() == (lib, "ptxas info: 0 bytes spill stores\n")
    lib.with_suffix(".log").unlink()
    with pytest.raises(AssertionError, match="the compiler ran"):
        wa.build_kernel()
