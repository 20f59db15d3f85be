"""DAT's two attentions: rectangular-window attention with an additive bias
and mask, and transposed channel attention.

Neither has a hand kernel. The window-attention kernel
(``ops/window_attention.py``) stops at 64 tokens a window and refuses more;
DAT's windows are 8 x 32 and 32 x 8, 256 tokens. So
:func:`rect_window_attention` takes one of two routes, by the device:

* on a card, :func:`_sdpa`: ``F.scaled_dot_product_attention`` on the
  memory-efficient backend (forced: no quiet fallback to another backend),
  the caller's bias and mask summed in one additive float mask, q, k and v
  zero-padded from head size 30 to 32 (the backend wants a multiple of 4 in
  float32; zero columns change no score and give zero output columns, which
  are cut) with the scale given as ``d ** -0.5`` of the unpadded size;
* elsewhere, :func:`_plain`: ``(q * scale) @ k^T + bias (+ mask)``,
  softmax, ``@ v``, as DAT publishes it.

The first timed 0.256-0.278 ms a call against the plain product's
0.311-0.379 at DAT x4's shapes on an H100. Both keep float32: the plain
product is cuBLAS float32 unless the caller turned TF32 on, and the
memory-efficient backend's float32 path multiplies with 3xTF32 (float32
accuracy).

:data:`calls` counts the calls of each kind (``"spatial"``: one a window
branch; ``"channel"``) in this process, so that a caller can see that a
forward ran every attention it should.
"""
from __future__ import annotations

import torch.nn.functional as F

calls = {"spatial": 0, "channel": 0}


def rect_window_attention(qkv, add):
    """Attention within windows of any size.

    qkv: (3, B, nW, heads, N, d), q, k and v stacked; add: the scores'
    additive term, (1, heads, N, N) (a position bias, every window alike)
    or (nW, heads, N, N) (bias plus each window's mask). Returns (B, nW,
    heads, N, d): :func:`_sdpa` on a card (a view of its padded output),
    :func:`_plain` elsewhere."""
    calls["spatial"] += 1
    return _sdpa(qkv, add) if qkv.is_cuda else _plain(qkv, add)


def _plain(qkv, add):
    """DAT's published product: softmax(q k^T * d^-0.5 + add) v."""
    q, k, v = qkv.unbind(0)
    scale = qkv.shape[-1] ** -0.5
    return ((q * scale) @ k.transpose(-2, -1) + add).softmax(-1) @ v


def _sdpa(qkv, add):
    """The same through ``F.scaled_dot_product_attention``: on a card its
    memory-efficient backend, forced; elsewhere the device's own."""
    _, b, nw, h, n, d = qkv.shape
    pad = -d % 8
    q, k, v = F.pad(qkv, (0, pad)).unbind(0)
    dp = d + pad
    if add.shape[0] == 1:
        # every window the same bias: batch rows B * nW, heads h
        q, k, v = (t.view(b * nw, h, n, dp) for t in (q, k, v))
        add = add.expand(b * nw, h, n, n)
    else:
        # a mask a window: batch rows B, "heads" nW * h
        q, k, v = (t.view(b, nw * h, n, dp) for t in (q, k, v))
        add = add.view(1, nw * h, n, n).expand(b, -1, n, n)
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                 scale=d ** -0.5)
    else:
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                             scale=d ** -0.5)
    return out.view(b, nw, h, n, dp)[..., :d]


def channel_attention(qkv, temperature):
    """XCiT's transposed attention, as DAT's channel blocks use it: qkv
    (3, B, heads, d, N), each channel's row of q and k L2-normalised over
    the N tokens, ``softmax(q k^T * temperature) v``; temperature (heads,
    1, 1). Returns (B, heads, d, N)."""
    calls["channel"] += 1
    q, k = F.normalize(qkv[:2], dim=-1).unbind(0)
    attn = (q @ k.transpose(-2, -1)) * temperature
    return attn.softmax(-1) @ qkv[2]
