"""Symmetric int8 quantisation of the RRDBNet trunk (NCHW).

Counterpart of ``srbh_tpu/ops/quant.py``, behind ``RRDBNet(quantize=True)``
(off by default): per-output-channel weight scales, a dynamic per-tensor
activation scale, and a convolution whose products are int8 x int8 summed
exactly in int32, then scaled back to float with the two scales.

The integer convolution is an im2col product: the zero-padded int8 input's
k*k shifted views side by side (NHWC, so the taps lie along the row) times
the int8 kernel through ``torch._int_mm`` (int8 in, int32 out). ``F.conv2d``
is no route: on int8 it returns int8, and its sums wrap. ``_int_mm`` on a
card wants more than 16 rows and a multiple of 8 columns in both operands,
so the reduction and output axes are padded with zeros, which adds nothing
to a sum, and the rows are taken a chunk of images at a time.

Rounding is half to even in both frameworks (``torch.round``,
``jnp.round``) on the float32 quotient by the scale, as the JAX package
computes it, so the int8 operands and the int32 sums equal the JAX ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_CHUNK_BYTES = 1 << 30  # the int8 im2col rows of one _int_mm call, at most


def quantize_weight(w: torch.Tensor, dim: Tuple[int, ...] = (1, 2, 3)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW kernel: (w_q int8,
    scale float32 of shape (O, 1, 1, 1)). ``dim`` are the reduced axes."""
    amax = w.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return w_q, scale.float()


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (x_q int8, scale float32 0-d; in
    ``x``'s type until the cast, as the JAX package computes it)."""
    scale = (x.abs().amax().clamp_min(1e-12) / 127.0).float()
    x_q = torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)
    return x_q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv_sums(x_q: torch.Tensor, w_q: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """The exact int32 sums of the zero-padded (``k // 2``) convolution of
    int8 NCHW ``x_q`` with int8 OIHW ``w_q``: (B, O, Ho, Wo) int32."""
    b, ci, h, w = x_q.shape
    co, _, k, _ = w_q.shape
    p = k // 2
    ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
    kk, kp, cp = k * k * ci, _round_up(k * k * ci, 8), _round_up(co, 8)
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, p, p, p, p))  # NHWC, int8
    wm = w_q.permute(2, 3, 1, 0).reshape(kk, co)  # (tap, ci) x co
    wm = F.pad(wm, (0, cp - co, 0, kp - kk)).contiguous()
    per = max(1, _CHUNK_BYTES // (ho * wo * kp))
    out = []
    for i in range(0, b, per):
        xi = xp[i:i + per]
        cols = torch.stack(
            [xi[:, dy:dy + stride * (ho - 1) + 1:stride,
                dx:dx + stride * (wo - 1) + 1:stride]
             for dy in range(k) for dx in range(k)], dim=3)
        rows = cols.reshape(-1, kk)
        m = rows.shape[0]
        if kp != kk or m < 17:  # a copy: only where _int_mm needs it
            rows = F.pad(rows, (0, kp - kk, 0, max(0, 17 - m)))
        out.append(torch._int_mm(rows, wm)[:m, :co])
    y = out[0] if len(out) == 1 else torch.cat(out)
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quantise-on-the-fly convolution (padding ``k // 2``): int8 x int8
    summed in int32, times the activation and weight scales, plus the
    float bias, in ``out_dtype``. ``weight`` is the float OIHW kernel, so
    the parameters stay float32 and one state dict serves both modes."""
    w_q, w_s = quantize_weight(weight)
    x_q, x_s = quantize_activation(x)
    y = int8_conv_sums(x_q, w_q, stride)
    out = y.float() * (x_s * w_s.reshape(1, -1, 1, 1))
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(out_dtype)
