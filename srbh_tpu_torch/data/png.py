"""Minimal PNG reader/writer (pure numpy + zlib), in place of cv2's.

The SwinIR harness reads and writes its images with ``cv2.imread`` /
``cv2.imwrite``; the card's machine has no cv2, so this module gives what
they give for PNG files:

* read: bit depths 8 and 16; colour types 0 (grey), 2 (RGB), 3 (palette,
  with its ``tRNS`` alpha), 4 (grey + alpha) and 6 (RGBA); all five filter
  types. An Adam7-interlaced file, another bit depth or a file that is not
  a PNG raises ``ValueError`` naming the file.
* :func:`imread` with cv2's flags: ``IMREAD_COLOR`` (BGR uint8: grey
  replicated, alpha dropped, 16 bits cut to their high byte),
  ``IMREAD_GRAYSCALE`` (uint8: colour to grey as cv2's libpng does it,
  ``(R*9797 + G*19234 + B*3737) >> 15`` for 8-bit files, the same with
  ``+ 16384`` on the 16-bit values, then the high byte, for 16-bit ones)
  and ``IMREAD_UNCHANGED`` (the stored
  depth, BGR / BGRA, grey with alpha as BGRA, grey alone as (H, W)).
* :func:`imwrite`: 8-bit grey, BGR or BGRA, one zlib stream, no filter.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        yield kind, data[pos + 8: pos + 8 + n]
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of a non-interlaced image, each filter undone."""
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # sub: a running sum of each byte lane
            cur = (line.reshape(-1, bpp).cumsum(0, dtype=np.uint64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:  # up
            cur = line + prev
        elif kind in (3, 4):  # average, paeth: byte after byte
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """The image as stored, (H, W, C) in the file's channel order (grey,
    grey + alpha, RGB or RGBA; a palette expanded to RGB, or RGBA with a
    ``tRNS`` chunk), uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    chunks = list(_chunks(data))
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG files are not supported")
    if depth not in (8, 16) or ctype not in _CHANNELS or (ctype == 3 and depth != 8):
        raise ValueError(f"{path}: bit depth {depth} of colour type {ctype} is "
                         "not supported (8 or 16 bits)")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    bpp = ch * depth // 8
    img = _unfilter(raw, h, w * bpp, bpp)
    img = (img.view(">u2").astype(np.uint16) if depth == 16 else img).reshape(h, w, ch)
    if ctype == 3:
        plte = next(body for kind, body in chunks if kind == b"PLTE")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        trns = [body for kind, body in chunks if kind == b"tRNS"]
        if trns:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns[0])] = np.frombuffer(trns[0], np.uint8)
            palette = np.concatenate([palette, alpha[:, None]], 1)
        img = palette[img[..., 0]]
    return img


def imread(path: str, flag: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flag)`` of a PNG file."""
    img = read_png(path)
    colour = img.shape[2] >= 3
    if flag == IMREAD_UNCHANGED:
        if img.shape[2] == 1:
            return img[..., 0]
        if img.shape[2] == 2:  # grey + alpha as BGRA
            return img[..., [0, 0, 0, 1]]
        return img[..., [2, 1, 0, 3][: img.shape[2]]]
    wide = img.dtype == np.uint16
    if flag == IMREAD_COLOR:
        out = img[..., [2, 1, 0]] if colour else img[..., [0, 0, 0]]
        return (out >> 8).astype(np.uint8) if wide else out
    if flag != IMREAD_GRAYSCALE:
        raise ValueError(f"imread flag {flag}")
    grey = img[..., 0]
    if colour:  # libpng's weights: it rounds at 16 bits, truncates at 8
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        grey = (r * 9797 + g * 19234 + b * 3737 + (16384 if wide else 0)) >> 15
    return (grey >> 8 if wide else grey).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` of an 8-bit grey (H, W) or (H, W, 1),
    BGR or BGRA image as a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: imwrite takes uint8 images, not {img.dtype}")
    img = img.reshape(*img.shape[:2], -1)
    ctype = {1: 0, 3: 2, 4: 6}[img.shape[2]]
    if ctype:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return True
