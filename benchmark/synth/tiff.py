"""A frozen copy of the port's GeoTIFF writer
(``srbh_tpu_torch/data/tiff.py:write_tiff`` at the commit that added the
benchmark), without PackBits, and a plain reader of what the port writes
(strips, chunky, no compression or DEFLATE).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

T_WIDTH, T_LENGTH, T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 256, 257, 258, 259, 262
T_STRIP_OFFSETS, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR, T_PREDICTOR, T_COLORMAP, T_SAMPLE_FORMAT = 284, 317, 320, 339
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT, T_MODEL_TRANSFORM = 33550, 33922, 34264
T_GEO_KEYS, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_NODATA = 42113
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 2: "s", 7: "s"}


def read_tiff(path: str) -> np.ndarray:
    """(H, W, C) of a little-endian striped chunky TIFF, uncompressed or
    DEFLATE, without a predictor; anything else raises."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian TIFF")
    (off,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, off)
    tags = {}
    for i in range(n):
        tag, typ, cnt, val = struct.unpack_from("<HHII", buf, off + 2 + 12 * i)
        size = _TYPE_SIZES[typ] * cnt
        pos = off + 2 + 12 * i + 8 if size <= 4 else val
        fmt = _TYPE_FMT[typ]
        if fmt == "s":
            tags[tag] = buf[pos:pos + cnt]
        else:
            tags[tag] = struct.unpack_from("<" + fmt * cnt, buf, pos)
    w, h = tags[T_WIDTH][0], tags[T_LENGTH][0]
    c = tags.get(T_SPP, (1,))[0]
    bits = tags[T_BITS][0]
    fmt = tags.get(T_SAMPLE_FORMAT, (1,))[0]
    comp = tags.get(T_COMPRESSION, (1,))[0]
    if tags.get(T_PLANAR, (1,))[0] != 1 or tags.get(T_PREDICTOR, (1,))[0] != 1:
        raise ValueError(f"{path}: planar or predicted layout")
    dt = np.dtype({1: "u", 2: "i", 3: "f"}[fmt] + str(bits // 8)).newbyteorder("<")
    data = bytearray()
    for so, sc in zip(tags[T_STRIP_OFFSETS], tags[T_STRIP_COUNTS]):
        chunk = buf[so:so + sc]
        if comp == 8 or comp == 32946:
            chunk = zlib.decompress(chunk)
        elif comp != 1:
            raise ValueError(f"{path}: compression {comp}")
        data += chunk
    return np.frombuffer(bytes(data), dt)[:h * w * c].reshape(h, w, c).astype(dt.newbyteorder("="))


def _compress(data: bytes, method: Optional[str]) -> Tuple[bytes, int]:
    if method in (None, "none", "NONE"):
        return data, 1
    if method.upper() == "DEFLATE":
        return zlib.compress(data, 6), 8
    raise ValueError(f"unsupported write compression {method!r}")


def write_tiff(path: str, array: np.ndarray,
               geotransform: Tuple[float, ...] = (0, 1, 0, 0, 0, -1),
               compress: Optional[str] = None,
               colormap: Optional[Dict[int, Tuple[int, int, int, int]]] = None,
               nodata: Optional[float] = None,
               like: Optional[object] = None,
               rows_per_strip: int = 256,
               geo_keys: Optional[bytes] = None) -> None:
    """Write an (H, W) or (H, W, C) array as a striped chunky GeoTIFF.

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

    strips, counts, comp_id = [], [], 1
    for y0 in range(0, h, rows_per_strip):
        chunk = np.ascontiguousarray(array[y0: y0 + rows_per_strip]).astype(
            dt.newbyteorder("<")).tobytes()
        comp, comp_id = _compress(chunk, compress)
        strips.append(comp)
        counts.append(len(comp))

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
