"""Space-to-depth packed 3x3 convolution of narrow-channel maps (NCHW).

Counterpart of ``srbh_tpu/ops/s2d.py``: a stride-1 3x3 conv over
``(C, H, W)`` computed as a VALID 2x2 conv over the packed
``(4C, H/2, W/2)`` form with a transformed kernel. It is the compute form of
``SRRegressClsFeature(compute_mode="packed")``; its outputs equal the
literal convs' up to float rounding (``tests/test_torch_s2d.py``).

The packed channel order is the JAX package's, ``(d*2 + e)*C + c`` for the
offset ``(d, e)`` inside a 2x2 block, now on the channel axis of an NCHW
tensor; so :func:`concat_perm`, :func:`tile_channel_param` and
:func:`ps_to_pack_perm` are the JAX functions unchanged. A packed tensor
carries a parity:

* parity 0: block ``i`` holds rows ``{2i, 2i+1}``, ``H/2`` blocks;
* parity 1: block ``i`` holds rows ``{2i-1, 2i}``, ``H/2 + 1`` blocks whose
  outer rows (-1 and H; the same for columns) are halo slots.

Each packed 3x3 conv flips the parity: from 0 the input is padded with one
zero block a side, from 1 its halo slots are zeroed; both reproduce the
literal conv's zero padding. For output offset ``(a, b)``, input tap
``(p, q)`` and input offset ``(d, e)``, the packed kernel holds
``W[u+1, v+1]`` with ``u = 2p + d - 1 - a``, ``v = 2q + e - 1 - b`` when
``|u|, |v| <= 1``, else zero.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> parity-0 packed (B, 4C, H/2, W/2)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"spatial dims ({h},{w}) must be even to pack")
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def unpack(xp: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """Packed (B, 4C, Hp, Wp) -> (B, C, H, W); parity 1 drops the halo."""
    b, c4, hp, wp = xp.shape
    c = c4 // 4
    x = xp.reshape(b, 2, 2, c, hp, wp).permute(0, 3, 4, 1, 5, 2)
    x = x.reshape(b, c, 2 * hp, 2 * wp)
    if parity == 1:
        x = x[:, :, 1:-1, 1:-1]
    return x


@functools.lru_cache(maxsize=None)
def _weight_index(ci: int, co: int) -> np.ndarray:
    """(4Co, 4Ci, 2, 2) indices into an OIHW (Co, Ci, 3, 3) kernel
    flattened, with ``Co*Ci*9`` (one past the end) for a zero entry."""
    zero = co * ci * 9
    idx = np.full((2, 2, co, 2, 2, ci, 2, 2), zero, np.int64)  # a b o d e i p q
    o = np.arange(co)[:, None]
    i = np.arange(ci)[None, :]
    for a in (0, 1):
        for b in (0, 1):
            for d in (0, 1):
                for e in (0, 1):
                    for p in (0, 1):
                        for q in (0, 1):
                            u = 2 * p + d - 1 - a
                            v = 2 * q + e - 1 - b
                            if -1 <= u <= 1 and -1 <= v <= 1:
                                idx[a, b, :, d, e, :, p, q] = (
                                    o * ci * 9 + i * 9 + (u + 1) * 3 + v + 1)
    # (a, b, o) is the output channel (a*2 + b)*Co + o; (d, e, i) the input
    return idx.reshape(4 * co, 4 * ci, 2, 2)


def transform_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> the packed 2x2 kernel (4Co, 4Ci, 2, 2)."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"only 3x3 kernels, got {kh}x{kw}")
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[torch.from_numpy(_weight_index(ci, co)).to(w.device)]


def halo_mask(hp: int, wp: int, c: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """(4C, Hp, Wp) multiplicative mask zeroing a parity-1 tensor's halo
    slots: row -1 is block 0's ``d = 0`` half, row H the last block's
    ``d = 1`` half; columns likewise with ``e``."""
    row = torch.ones(4 * c, hp, 1, dtype=dtype, device=device)
    row[: 2 * c, 0] = 0
    row[2 * c:, -1] = 0
    col = torch.ones(4 * c, 1, wp, dtype=dtype, device=device)
    col[0:c, :, 0] = 0
    col[2 * c: 3 * c, :, 0] = 0
    col[c: 2 * c, :, -1] = 0
    col[3 * c:, :, -1] = 0
    return row * col


def conv3x3_packed(xp: torch.Tensor, parity: int, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   kin_perm=None) -> torch.Tensor:
    """The literal stride-1, zero-padded 3x3 conv of OIHW kernel ``w`` on a
    packed tensor of parity ``parity``; returns parity ``1 - parity``.
    ``kin_perm`` (:func:`concat_perm`) adapts the kernel to an input that
    concatenates separately packed tensors (parity 0 only)."""
    if kin_perm is not None and parity != 0:
        raise NotImplementedError(
            "conv3x3_packed: kin_perm with parity=1 is unsupported (the "
            "halo mask assumes a canonical packed layout)")
    if parity == 0:
        xp = F.pad(xp, (1, 1, 1, 1))
    else:
        _, c4, hp, wp_ = xp.shape
        xp = xp * halo_mask(hp, wp_, c4 // 4, xp.dtype, xp.device)
    wp = transform_weight(w).to(xp.dtype)
    if kin_perm is not None:
        wp = wp[:, torch.as_tensor(kin_perm, device=wp.device)]
    b = None if bias is None else bias.repeat(4).to(xp.dtype)
    return F.conv2d(xp, wp, b)


def conv1x1_packed(xp: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   kin_perm=None) -> torch.Tensor:
    """A 1x1 conv of OIHW kernel ``w`` on a packed tensor (block-diagonal
    over the four offsets); keeps the parity."""
    w2 = w.reshape(w.shape[0], w.shape[1])
    wbd = torch.block_diag(w2, w2, w2, w2)[:, :, None, None]
    if kin_perm is not None:
        wbd = wbd[:, torch.as_tensor(kin_perm, device=wbd.device)]
    b = None if bias is None else bias.repeat(4).to(xp.dtype)
    return F.conv2d(xp, wbd.to(xp.dtype), b)


def tile_channel_param(v: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) parameter in the packed (4C,) order: a 4x tile."""
    return v.repeat(4)


def concat_perm(parts: Sequence[int]) -> np.ndarray:
    """Kernel input-channel gather for ``cat([pack(x1), pack(x2), ...])``:
    ``perm[j]`` is the channel of ``pack(cat([x1, x2, ...]))`` that the
    concatenation holds at ``j``."""
    ctot = sum(parts)
    perm, start = [], 0
    for c in parts:
        for de in range(4):
            perm.extend(de * ctot + start + cc for cc in range(c))
        start += c
    return np.asarray(perm, dtype=np.int64)


def ps_to_pack_perm(c_out: int) -> np.ndarray:
    """Channel gather with ``x[:, ps_to_pack_perm(C)] == pack(pixel_shuffle(
    x, 2))``: pixel shuffle reads channel ``c*4 + i*2 + j`` for offset
    ``(i, j)``, the packed form holds it at ``(i*2 + j)*C + c``."""
    perm = [c * 4 + ij for ij in range(4) for c in range(c_out)]
    return np.asarray(perm, dtype=np.int64)
