"""Native host paths of the port: the TIFF codecs and the host mosaic blend.

The port's copy of ``srbh_tpu/native``: ``tiffcodec.cpp`` (PackBits decode
and encode, LZW decode, the batched mosaic blend) is built at first use with
``g++ -O3 -shared -fPIC`` into ``build/srbh_tpu_torch/`` beside the package
and bound with ``ctypes``. ``data/tiff.py`` decodes and encodes through it
and ``predict/stitcher.py:MosaicAccumulator.add_batch`` blends through it.
:func:`build` and :func:`load` are the port's one path from a source to a
loaded library; ``ops/window_attention.py`` takes it too.

Unlike the JAX package's, nothing here falls back to Python: a failed build
raises, a malformed stream raises, and a tile outside the canvas raises
before anything is added. The Python versions (``data/tiff.py``'s
``_packbits_decode``, ``_packbits_encode``, ``_lzw_decode`` and
``MosaicAccumulator.add_batch_plain``) stay as the plain versions the tests
hold these against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable

import numpy as np

SOURCE = Path(__file__).resolve().with_name("tiffcodec.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srbh_tpu_torch"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build(source: Path, name: str, command: Callable[[Path], list],
          log: bool = False) -> tuple[Path, str]:
    """(path, compiler's output) of ``BUILD_DIR/lib<name>_<tag>.so``, ``tag``
    a hash of ``source``, compiled by the arguments ``command(out)`` unless
    already built. Each process compiles to its own temporary ``out`` and
    moves it into place, so none loads a half-written file. ``log`` keeps
    the output in a ``.log`` beside the library, which a built library then
    needs. A failed compile raises ``RuntimeError`` naming the compiler."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{tag}.so"
    log_file = lib.with_suffix(".log")
    if lib.exists() and (not log or log_file.exists()):
        return lib, log_file.read_text() if log else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) "
                           f"building {source}:\n{out}")
    if log:
        log_file.write_text(out)
    os.replace(tmp, lib)
    return lib, out


def load(name: str, path: Callable[[], Path],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library ``name``, on the first call loaded from ``path()`` and
    bound by ``bind``, under one lock for all of the port's libraries."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(path()))
            bind(lib)
            _loaded[name] = lib
        return _loaded[name]


def build_library() -> Path:
    """``tiffcodec.cpp`` built with ``g++ -O3 -shared -fPIC`` (:func:`build`)."""
    return build(SOURCE, "tiffcodec", lambda out: [
        "g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(out)])[0]


def _bind(lib: ctypes.CDLL) -> None:
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.packbits_decode.restype = ctypes.c_long
    lib.packbits_decode.argtypes = [u8, ctypes.c_long, u8, ctypes.c_long]
    lib.packbits_encode.restype = ctypes.c_long
    lib.packbits_encode.argtypes = [u8, ctypes.c_long, u8]
    lib.lzw_decode.restype = ctypes.c_long
    lib.lzw_decode.argtypes = [u8, ctypes.c_long, u8, ctypes.c_long]
    lib.blend_tiles.restype = None
    lib.blend_tiles.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    return load("tiffcodec", build_library, _bind)


def _u8ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _decode(fn, name: str, data: bytes, expected: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.zeros(max(expected, 1), np.uint8)
    n = fn(_u8ptr(src), len(src), _u8ptr(dst), expected)
    if n < 0:
        raise ValueError(f"malformed {name} stream ({len(data)} bytes)")
    # a short stream leaves the zeros: the Python decoders zero-fill too
    return dst[:expected].tobytes()


def packbits_decode(data: bytes, expected: int) -> bytes:
    """``expected`` bytes of a PackBits stream (TIFF compression 32773)."""
    return _decode(get_lib().packbits_decode, "PackBits", data, expected)


def lzw_decode(data: bytes, expected: int) -> bytes:
    """``expected`` bytes of a TIFF LZW stream (compression 5)."""
    return _decode(get_lib().lzw_decode, "LZW", data, expected)


def packbits_encode(data: bytes) -> bytes:
    """PackBits stream of ``data``, byte-equal to the Python encoder's."""
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(len(src) + len(src) // 127 + 2, np.uint8)
    n = get_lib().packbits_encode(_u8ptr(src), len(src), _u8ptr(dst))
    return dst[:n].tobytes()


def blend_tiles(height_canvas: np.ndarray, build_canvas: np.ndarray,
                weight: np.ndarray, height_tiles: np.ndarray,
                build_tiles: np.ndarray, pos: np.ndarray,
                upscale: int) -> None:
    """Add tiles into the canvases of
    ``srbh_tpu_torch.predict.stitcher.MosaicAccumulator`` in place:
    height (N, T, T) and build (N, T, T, C) uint16 tiles, pos (N, 4)
    [xoff, yoff, xcount, ycount] in source pixels, T a multiple of
    ``upscale``. Raises before adding anything when an argument's shape or
    dtype is wrong or a tile's window leaves the tile or the canvas."""
    c, h, w = build_canvas.shape
    if (height_canvas.dtype != np.int64 or build_canvas.dtype != np.int64
            or weight.dtype != np.uint16 or height_canvas.shape != (h, w)
            or weight.shape != (h, w)):
        raise TypeError("canvases must be int64 (H, W), int64 (C, H, W) and "
                        "uint16 (H, W)")
    for a in (height_canvas, build_canvas, weight):
        if not a.flags.c_contiguous:
            raise ValueError("canvases must be C-contiguous")
    n, t = height_tiles.shape[:2]
    if (height_tiles.dtype != np.uint16 or build_tiles.dtype != np.uint16
            or height_tiles.shape != (n, t, t)
            or build_tiles.shape != (n, t, t, c) or t % upscale
            or pos.shape != (n, 4)):
        raise ValueError(
            f"tiles must be uint16 (N, T, T) and (N, T, T, {c}) with T a "
            f"multiple of {upscale}, pos (N, 4): got {height_tiles.dtype} "
            f"{height_tiles.shape}, {build_tiles.dtype} {build_tiles.shape}, "
            f"pos {pos.shape}")
    px = pos.astype(np.int64) * upscale
    bad = ((px < 0).any(1) | (px[:, 2] > t) | (px[:, 3] > t)
           | (px[:, 0] + px[:, 2] > w) | (px[:, 1] + px[:, 3] > h))
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(f"tile {i} at {pos[i].tolist()} (x{upscale}) leaves "
                         f"its {t}x{t} tile or the {w}x{h} canvas")
    height_tiles = np.ascontiguousarray(height_tiles)
    build_tiles = np.ascontiguousarray(build_tiles)
    pos32 = np.ascontiguousarray(pos, np.int32)
    get_lib().blend_tiles(
        height_canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        build_canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        weight.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, c,
        height_tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        build_tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        pos32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, t // upscale, upscale)
