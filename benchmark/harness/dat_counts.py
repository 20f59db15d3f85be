"""Operations and bytes of DAT's serving forward and of its spatial
attention products, counted from shapes on the benchmark's reference
(``reference/dat.py``) at the meta device.

* the forward: every convolution, linear and attention product, 2
  operations per multiply-add (``FlopCounterMode``, :func:`counts.step_flops`);
* one window branch's attention product (B_ = B nW windows, h heads, N
  tokens, head size d, masked or not): ``4 B_ h N^2 d`` operations (``q k^T``
  and ``p v``) and the least bytes any implementation moves: q, k and v read
  once and the output written once, the (h, N, N) position bias and, where
  the block shifts, the (nW, N, N) mask read once, all float32. The work is
  the same whatever route computes it; :func:`roofline_ms` sets it against
  the TF32 peak (the float32-accurate products of a Hopper kernel run on
  TF32 tensor cores, as the hand window-attention kernel's 3xTF32 and the
  memory-efficient backend's do) and the HBM rate.
"""
from __future__ import annotations

import torch

from benchmark.harness import counts
from benchmark.harness.peaks import roofline_seconds
from benchmark.reference import dat as ref


def attention_flops(b_: int, heads: int, n: int, d: int) -> int:
    return 4 * b_ * heads * n * n * d


def attention_bytes(b_: int, heads: int, n: int, d: int, nw: int = 0,
                    itemsize: int = 4) -> int:
    return 4 * b_ * heads * n * d * itemsize + 4 * (heads + nw) * n * n


def spatial_calls(model, x) -> list:
    """(B_, heads, N, d, nW or 0) of each window branch's attention of one
    forward of ``model`` (the reference) on ``x``, in order."""
    calls = []

    def note(m, args):
        qkv, h, w = args[0], args[1], args[2]
        mask = args[3] if len(args) > 3 else None
        b, _, c = qkv[0].shape
        nw = (h // m.hs) * (w // m.ws)
        calls.append((b * nw, m.heads, m.hs * m.ws, c // m.heads,
                      0 if mask is None else mask.shape[0]))

    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, ref.Spatial_Attention)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def serve_counts(cfg: dict, batch: int) -> dict:
    """One request of ``batch`` tiles: ``tile_flops`` (the whole forward a
    tile), ``spatial_flops`` and ``spatial_bytes`` (every window branch's
    attention product of the request, float32) and ``spatial_calls``."""
    t = cfg["model"]["tile"]
    with torch.device("meta"):
        model = ref.build(cfg).eval()
        one = torch.empty(1, cfg["model"]["in_chans"], t, t)
        x = torch.empty(batch, cfg["model"]["in_chans"], t, t)
        tile_flops = counts.step_flops(model, one)
        calls = spatial_calls(model, x)
    return {"tile_flops": tile_flops,
            "spatial_flops": sum(attention_flops(*c[:4]) for c in calls),
            "spatial_bytes": sum(attention_bytes(*c) for c in calls),
            "spatial_calls": len(calls)}


def roofline_ms(c: dict) -> tuple:
    """(least milliseconds, bound) of a request's spatial attention
    products, from :func:`serve_counts`."""
    s, bound = roofline_seconds(c["spatial_flops"], c["spatial_bytes"],
                                "tf32")
    return 1e3 * s, bound
