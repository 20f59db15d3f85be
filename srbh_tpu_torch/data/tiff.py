"""Minimal GeoTIFF reader/writer (numpy, zlib and the port's native codec).

The port's copy of ``srbh_tpu/data/tiff.py``. PackBits and LZW go through
the port's C++ codec (``srbh_tpu_torch/native``), as the JAX package's do
through its own; the Python codecs here stay as their plain versions:

* read: uint8/uint16/int16/uint32/float32/float64; strip and tile layouts;
  None/PackBits/Deflate/LZW compression; the horizontal-differencing
  predictor; chunky and planar configs; windowed reads
  ``(xoff, yoff, xsize, ysize)`` that decode only the chunks they touch;
  windows crossing the right/bottom edge are zero-filled.
* metadata: :meth:`TiffReader.info` gives a :class:`TiffInfo` with the
  GDAL nodata value, the colormap and the GeoKey payloads (directory,
  doubles, ASCII) as little-endian bytes, for verbatim passthrough.
* write: strip layout, chunky, None/PackBits/Deflate, the GeoTIFF
  geotransform (ModelPixelScale + ModelTiepoint, or ModelTransformation),
  a 256-entry RGBA colormap (photometric 3), GDAL nodata, and GeoKeys
  carried from a source file (``like``) or given (``geo_keys``): the same
  bytes as the JAX package's ``write_tiff`` for the same arguments.

:class:`TiffReader` maps the file read-only (``mmap``; a zero-length file,
which cannot be mapped, is read as bytes and then refused as not a TIFF),
so the pages a window touches are all it keeps resident, and worker
processes forked from the reader's process share the map. Decoded strips
and tiles are cached up to ``max_cache_bytes`` (insert-only: once the bound
is reached, later chunks are decoded on every read), as
``srbh_tpu/data/tiff.py`` does: the city predictor's 64-px windows at a
56-px stride touch each strip several times, and the cache decodes it once
per process. :meth:`TiffReader.close` releases the map and the cache; it
may be called twice. :func:`write_tiff`'s strip encode is the span
``tiff.encode`` (``utils/profiler.py``); it runs on a thread pool when
several strips are compressed (:func:`_encode_strips`), and opens no span
in the pool's threads.
"""
from __future__ import annotations

import mmap
import os
import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from srbh_tpu_torch import native
from srbh_tpu_torch.utils import profiler

# TIFF tag ids
T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_STRIP_OFFSETS, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR, T_PREDICTOR, T_COLORMAP, T_SAMPLE_FORMAT = 284, 317, 320, 339
T_TILE_W, T_TILE_L, T_TILE_OFFSETS, T_TILE_COUNTS = 322, 323, 324, 325
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT, T_MODEL_TRANSFORM = 33550, 33922, 34264
T_GEO_KEYS, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113
# a GDAL nodata string that reads as a float (anything else reads as None)
_FLOAT = re.compile(r"\s*[+-]?(nan|inf(inity)?|(\d+\.?\d*|\.\d+)"
                    r"(e[+-]?\d+)?)\s*", re.IGNORECASE)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 2: "s", 7: "s"}


def _sample_dtype(bits: int, fmt: int, endian: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{endian}{kind}{bits // 8}")


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i: i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i: i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out[:expected])


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 127 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            # literal stretch until the next run of >= 3
            j = i + 1
            while j < n and j - i < 128:
                if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                    break
                j += 1
            out.append(j - i - 1)
            out += data[i:j]
            i = j
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-flavour LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    dictionary: List[bytes] = []

    def reset():
        nonlocal dictionary
        dictionary = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitbuf, bitcnt, codesize = 0, 0, 9
    prev: Optional[bytes] = None
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= codesize:
            code = (bitbuf >> (bitcnt - codesize)) & ((1 << codesize) - 1)
            bitcnt -= codesize
            if code == CLEAR:
                reset()
                codesize = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out[:expected])
            if prev is None:
                entry = dictionary[code]
            elif code < len(dictionary):
                entry = dictionary[code]
                dictionary.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                dictionary.append(entry)
            out += entry
            prev = entry
            if len(dictionary) >= (1 << codesize) - 1 and codesize < 12:
                codesize += 1
            if len(out) >= expected:
                return bytes(out[:expected])
    return bytes(out[:expected])


def _decompress(data: bytes, method: int, expected: int) -> bytes:
    if method == 1:
        return data[:expected]
    if method in (8, 32946):
        return zlib.decompress(data)[:expected]
    if method == 32773:
        return native.packbits_decode(data, expected)
    if method == 5:
        return native.lzw_decode(data, expected)
    raise ValueError(f"unsupported TIFF compression {method}")


@dataclass
class TiffInfo:
    width: int
    height: int
    count: int  # bands
    dtype: np.dtype
    compression: int
    geotransform: Tuple[float, float, float, float, float, float]
    nodata: Optional[float] = None
    colormap: Optional[Dict[int, Tuple[int, int, int, int]]] = None
    # verbatim projection payloads (little-endian) for passthrough
    geo_keys: Optional[bytes] = None
    geo_doubles: Optional[bytes] = None
    geo_ascii: Optional[bytes] = None


class TiffReader:
    """Single-IFD TIFF reader with windowed access over a read-only map of
    the file, caching decoded chunks up to ``max_cache_bytes``."""

    def __init__(self, path: str, max_cache_bytes: int = 512 << 20):
        self.path = path
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_bytes = 0
        self._max_cache_bytes = max_cache_bytes
        with open(path, "rb") as f:
            if os.fstat(f.fileno()).st_size:
                self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            else:
                self._buf = f.read()
        b = self._buf
        if b[:2] not in (b"II", b"MM") or len(b) < 8:
            raise ValueError(f"{path}: not a TIFF")
        self._e = "<" if b[:2] == b"II" else ">"
        magic, off = struct.unpack(self._e + "HI", b[2:8])
        if magic != 42:
            raise ValueError(f"{path}: bad TIFF magic {magic}")
        self.tags = self._read_ifd(off)
        self._parse()

    def close(self) -> None:
        """Release the file's map and the decoded chunks (idempotent)."""
        buf, self._buf = self._buf, b""
        if isinstance(buf, mmap.mmap):
            buf.close()
        self._cache.clear()
        self._cache_bytes = 0

    def _read_ifd(self, off: int) -> Dict[int, tuple]:
        e, b = self._e, self._buf
        (n,) = struct.unpack(e + "H", b[off: off + 2])
        tags = {}
        for i in range(n):
            ent = b[off + 2 + 12 * i: off + 14 + 12 * i]
            tag, typ, cnt = struct.unpack(e + "HHI", ent[:8])
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size <= 4:
                raw = ent[8: 8 + size]
            else:
                (ptr,) = struct.unpack(e + "I", ent[8:12])
                raw = b[ptr: ptr + size]
            tags[tag] = (typ, cnt, raw)
        return tags

    def _values(self, tag: int):
        typ, cnt, raw = self.tags[tag]
        if typ in (2, 7):
            return raw
        cnt = min(cnt, len(raw) // _TYPE_SIZES.get(typ, 1))
        if typ in (5, 10):  # rationals (8 B: numerator, denominator)
            vals = struct.unpack(self._e + ("II" if typ == 5 else "ii") * cnt,
                                 raw[: 8 * cnt])
            return [vals[2 * i] / vals[2 * i + 1] if vals[2 * i + 1] else 0.0
                    for i in range(cnt)]
        if typ not in _TYPE_FMT:
            raise ValueError(f"{self.path}: corrupt TIFF: tag {tag} has "
                             f"unknown type {typ}")
        return list(struct.unpack(self._e + _TYPE_FMT[typ] * cnt,
                                  raw[: _TYPE_SIZES[typ] * cnt]))

    def _tag1(self, tag: int, default=None):
        if tag not in self.tags:
            return default
        v = self._values(tag)
        return v[0] if isinstance(v, list) else v

    def _parse(self):
        self.width = int(self._tag1(T_WIDTH))
        self.height = int(self._tag1(T_LENGTH))
        self.spp = int(self._tag1(T_SPP, 1))
        self.bits = int(self._tag1(T_BITS, 8))
        self.dtype = _sample_dtype(self.bits, int(self._tag1(T_SAMPLE_FORMAT, 1)),
                                   self._e)
        self.compression = int(self._tag1(T_COMPRESSION, 1))
        self.planar = int(self._tag1(T_PLANAR, 1))
        self.predictor = int(self._tag1(T_PREDICTOR, 1))
        self.tiled = T_TILE_OFFSETS in self.tags
        if self.tiled:
            self.tile_w = int(self._tag1(T_TILE_W))
            self.tile_l = int(self._tag1(T_TILE_L))
            offsets, counts = T_TILE_OFFSETS, T_TILE_COUNTS
        else:
            self.rows_per_strip = int(self._tag1(T_ROWS_PER_STRIP, self.height))
            offsets, counts = T_STRIP_OFFSETS, T_STRIP_COUNTS
        self.chunk_offsets = [int(v) for v in self._values(offsets)]
        self.chunk_counts = [int(v) for v in self._values(counts)]
        for off, cnt in zip(self.chunk_offsets, self.chunk_counts):
            if off < 0 or cnt < 0 or off + cnt > len(self._buf):
                raise ValueError(f"{self.path}: corrupt TIFF: chunk "
                                 f"[{off}, +{cnt}] outside the file")

    @property
    def geotransform(self) -> Tuple[float, ...]:
        """GDAL-style (x0, dx, rx, y0, ry, dy)."""
        if T_MODEL_TRANSFORM in self.tags:
            m = self._values(T_MODEL_TRANSFORM)
            return (m[3], m[0], m[1], m[7], m[4], m[5])
        if T_MODEL_PIXEL_SCALE in self.tags and T_MODEL_TIEPOINT in self.tags:
            sx, sy = self._values(T_MODEL_PIXEL_SCALE)[:2]
            i, j, _, x, y, _ = self._values(T_MODEL_TIEPOINT)[:6]
            return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
        return (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)

    @property
    def nodata(self) -> Optional[float]:
        if T_GDAL_NODATA not in self.tags:
            return None
        text = self._values(T_GDAL_NODATA).rstrip(b"\x00").decode(
            "ascii", "replace")
        return float(text) if _FLOAT.fullmatch(text) else None

    def _geo(self, tag: int, itemsize: int) -> Optional[bytes]:
        """A GeoKey payload as little-endian bytes: ``write_tiff`` writes
        little-endian files, so a big-endian payload is swapped."""
        if tag not in self.tags:
            return None
        raw = self.tags[tag][2]
        if self._e == ">" and itemsize > 1:
            kind = {2: "u2", 8: "f8"}[itemsize]
            raw = np.frombuffer(raw[: len(raw) - len(raw) % itemsize],
                                ">" + kind).astype("<" + kind).tobytes()
        return raw

    def info(self) -> TiffInfo:
        cmap = None
        if T_COLORMAP in self.tags:
            v = self._values(T_COLORMAP)
            n = len(v) // 3
            cmap = {i: (v[i] >> 8, v[n + i] >> 8, v[2 * n + i] >> 8, 255)
                    for i in range(n)}
        return TiffInfo(
            width=self.width, height=self.height, count=self.spp,
            dtype=self.dtype, compression=self.compression,
            geotransform=self.geotransform, nodata=self.nodata, colormap=cmap,
            geo_keys=self._geo(T_GEO_KEYS, 2),
            geo_doubles=self._geo(T_GEO_DOUBLES, 8),
            geo_ascii=self._geo(T_GEO_ASCII, 1))

    def _decode_chunk(self, idx: int, shape: Tuple[int, ...]) -> np.ndarray:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        off, cnt = self.chunk_offsets[idx], self.chunk_counts[idx]
        n = int(np.prod(shape))
        expected = n * self.dtype.itemsize
        data = _decompress(self._buf[off: off + cnt], self.compression, expected)
        # a short chunk (corrupt stream) reads as zeros past its end
        data = data + b"\x00" * (expected - len(data))
        arr = np.frombuffer(data, self.dtype, count=n).reshape(shape)
        if self.predictor == 2:
            arr = np.cumsum(arr, axis=1, dtype=self.dtype)
        if self._cache_bytes + arr.nbytes <= self._max_cache_bytes:
            self._cache[idx] = arr
            self._cache_bytes += arr.nbytes
        return arr

    def read(self, window: Optional[Tuple[int, int, int, int]] = None
             ) -> np.ndarray:
        """Read an (H, W, C) array; ``window=(xoff, yoff, xsize, ysize)``."""
        xoff, yoff, xs, ys = window or (0, 0, self.width, self.height)
        out = np.zeros((ys, xs, self.spp), self.dtype)
        planes = self.spp if self.planar == 2 else 1
        chans = 1 if self.planar == 2 else self.spp
        if self.tiled:
            ch_h, ch_w = self.tile_l, self.tile_w
        else:
            ch_h, ch_w = self.rows_per_strip, self.width
        across = (self.width + ch_w - 1) // ch_w
        down = (self.height + ch_h - 1) // ch_h
        last_y = min((yoff + ys - 1) // ch_h, down - 1)
        last_x = min((xoff + xs - 1) // ch_w, across - 1)
        for p in range(planes):
            for cy in range(yoff // ch_h, last_y + 1):
                for cx in range(xoff // ch_w, last_x + 1):
                    rows = ch_h if self.tiled else min(ch_h, self.height - cy * ch_h)
                    chunk = self._decode_chunk(p * across * down + cy * across + cx,
                                               (rows, ch_w, chans))
                    y0, x0 = max(cy * ch_h, yoff), max(cx * ch_w, xoff)
                    y1 = min(cy * ch_h + rows, yoff + ys, self.height)
                    x1 = min((cx + 1) * ch_w, xoff + xs, self.width)
                    sub = chunk[y0 - cy * ch_h: y1 - cy * ch_h,
                                x0 - cx * ch_w: x1 - cx * ch_w]
                    dst = out[y0 - yoff: y1 - yoff, x0 - xoff: x1 - xoff]
                    if self.planar == 2:
                        dst[..., p] = sub[..., 0]
                    else:
                        dst[...] = sub
        return out


def read_tiff(path: str, window=None) -> np.ndarray:
    """Convenience: (H, W, C) array (C kept even when 1)."""
    return TiffReader(path).read(window)


_UNCOMPRESSED = (None, "none", "NONE")


def _compress(data: bytes, method: Optional[str]) -> Tuple[bytes, int]:
    if method in _UNCOMPRESSED:
        return data, 1
    if method.upper() == "DEFLATE":
        return zlib.compress(data, 6), 8
    if method.upper() == "PACKBITS":
        return native.packbits_encode(data), 32773
    raise ValueError(f"unsupported write compression {method!r}")


def _encode_strips(array: np.ndarray, rows_per_strip: int,
                   compress: Optional[str]) -> List[Tuple[bytes, int]]:
    """Each strip's ``(stream, compression id)``, in strip order.

    DEFLATE (``zlib.compress``) and PackBits (the C++ codec through ctypes)
    release the GIL while they encode, and strips are independent, so
    several compressed strips are encoded on a thread pool of
    ``min(strips, usable cores)`` threads: the same bytes as the serial
    loop. The pool lives for this call alone and is joined before it
    returns, so no thread is alive when a loader later forks its workers.
    One strip, one usable core or no compression (a copy) stays serial."""
    def encode(y0):
        chunk = np.ascontiguousarray(array[y0: y0 + rows_per_strip]).astype(
            array.dtype.newbyteorder("<")).tobytes()
        return _compress(chunk, compress)

    starts = range(0, array.shape[0], rows_per_strip)
    threads = min(len(starts), len(os.sched_getaffinity(0)))
    if threads < 2 or compress in _UNCOMPRESSED:
        return list(map(encode, starts))
    with ThreadPoolExecutor(threads, thread_name_prefix="tiff-encode") as pool:
        return list(pool.map(encode, starts))


def write_tiff(path: str, array: np.ndarray,
               geotransform: Tuple[float, ...] = (0, 1, 0, 0, 0, -1),
               compress: Optional[str] = None,
               colormap: Optional[Dict[int, Tuple[int, int, int, int]]] = None,
               nodata: Optional[float] = None,
               like: Optional[TiffInfo] = None,
               rows_per_strip: int = 256,
               geo_keys: Optional[bytes] = None) -> None:
    """Write an (H, W) or (H, W, C) array as a striped chunky GeoTIFF, the
    same bytes as the JAX package's ``write_tiff`` for the same arguments.

    ``like`` carries a source file's GeoKeys, GeoKey doubles and ASCII
    verbatim (the array2raster pattern, utils/preprocess.py:106-133);
    ``geo_keys`` stamps a GeoKeyDirectory of its own and wins over
    ``like``'s. ``colormap`` maps values to RGBA (photometric 3)."""
    if array.ndim == 2:
        array = array[..., None]
    h, w, c = array.shape
    dt = array.dtype
    fmt_code = {"u": 1, "i": 2, "f": 3}[dt.kind]
    entries: List[Tuple[int, int, int, bytes]] = []  # (tag, type, count, payload)

    def add(tag, typ, values):
        values = values if isinstance(values, (list, tuple)) else [values]
        entries.append((tag, typ, len(values), struct.pack(
            "<" + _TYPE_FMT[typ] * len(values), *values)))

    with profiler.span("tiff.encode"):
        encoded = _encode_strips(array, rows_per_strip, compress)
    strips = [comp for comp, _ in encoded]
    counts = [len(comp) for comp in strips]
    comp_id = encoded[-1][1] if encoded else 1

    add(T_WIDTH, 4, w)
    add(T_LENGTH, 4, h)
    add(T_BITS, 3, [dt.itemsize * 8] * c)
    add(T_COMPRESSION, 3, comp_id)
    add(T_PHOTOMETRIC, 3, 3 if colormap else (2 if c >= 3 else 1))
    add(T_SPP, 3, c)
    add(T_ROWS_PER_STRIP, 4, rows_per_strip)
    add(T_STRIP_COUNTS, 4, counts)
    add(T_PLANAR, 3, 1)
    add(T_SAMPLE_FORMAT, 3, [fmt_code] * c)
    if colormap:
        rgb = [[0] * (1 << (dt.itemsize * 8)) for _ in range(3)]
        for k, colour in colormap.items():
            for band, v in zip(rgb, colour[:3]):
                band[k] = int(v) * 257
        add(T_COLORMAP, 3, rgb[0] + rgb[1] + rgb[2])
    gt = geotransform
    if gt[2] == 0 and gt[4] == 0:
        add(T_MODEL_PIXEL_SCALE, 12, [gt[1], -gt[5], 0.0])
        add(T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, gt[0], gt[3], 0.0])
    else:
        add(T_MODEL_TRANSFORM, 12, [gt[1], gt[2], 0, gt[0], gt[4], gt[5], 0,
                                    gt[3], 0, 0, 0, 0, 0, 0, 0, 1])
    if geo_keys is not None:
        entries.append((T_GEO_KEYS, 3, len(geo_keys) // 2, geo_keys))
    elif like is not None and like.geo_keys:
        entries.append((T_GEO_KEYS, 3, len(like.geo_keys) // 2, like.geo_keys))
    if like is not None and like.geo_doubles:
        entries.append((T_GEO_DOUBLES, 12, len(like.geo_doubles) // 8,
                        like.geo_doubles))
    if like is not None and like.geo_ascii:
        entries.append((T_GEO_ASCII, 2, len(like.geo_ascii), like.geo_ascii))
    if nodata is not None:
        text = repr(nodata).encode() + b"\x00"
        entries.append((T_GDAL_NODATA, 2, len(text), text))

    # layout: header (8) + IFD + out-of-line payloads + strip data
    n_entries = len(entries) + 1  # + strip offsets
    payload_off = 8 + 2 + 12 * n_entries + 4
    oversized = sum(len(p) + (len(p) & 1) for *_, p in entries if len(p) > 4)
    offsets_size = 4 * len(strips) if len(strips) > 1 else 0
    pos = payload_off + oversized + offsets_size
    strip_offsets = []
    for cnt in counts:
        strip_offsets.append(pos)
        pos += cnt + (cnt & 1)
    entries.append((T_STRIP_OFFSETS, 4, len(strip_offsets),
                    struct.pack("<" + "I" * len(strip_offsets), *strip_offsets)))
    entries.sort(key=lambda t: t[0])

    ifd = bytearray(struct.pack("<H", len(entries)))
    payloads = bytearray()
    ppos = payload_off
    for tag, typ, cnt, payload in entries:
        if len(payload) <= 4:
            ifd += struct.pack("<HHI", tag, typ, cnt) + payload.ljust(4, b"\x00")
        else:
            ifd += struct.pack("<HHII", tag, typ, cnt, ppos)
            padded = payload + (b"\x00" if len(payload) & 1 else b"")
            payloads += padded
            ppos += len(padded)
    ifd += struct.pack("<I", 0)  # no next IFD
    out = bytearray(b"II" + struct.pack("<HI", 42, 8)) + ifd + payloads
    for s in strips:
        out += s + (b"\x00" if len(s) & 1 else b"")
    with open(path, "wb") as f:
        f.write(out)
