"""Operations and bytes of SwinIR's serving forward and of its fused window
attention, counted from shapes on the benchmark's reference
(``reference/swinir.py``) at the meta device.

* the forward: every convolution, linear and attention product, 2
  operations per multiply-add (``FlopCounterMode``, :func:`counts.step_flops`);
* one window-attention call (heads, B_ windows, N tokens, head size d, nW
  masks or 0): ``4 heads B_ N^2 d`` operations (``q k^T`` and ``p v``) and
  the least bytes a fused kernel moves: q, k and v read once and the output
  written once, the (heads, N, N) bias and the (nW, N, N) mask read once in
  float32.
"""
from __future__ import annotations

import torch

from benchmark.harness import counts
from benchmark.reference import swinir as ref


def attention_flops(heads: int, b_: int, n: int, d: int) -> int:
    return 4 * heads * b_ * n * n * d


def attention_bytes(heads: int, b_: int, n: int, d: int, nw: int = 0,
                    itemsize: int = 4) -> int:
    return 4 * heads * b_ * n * d * itemsize + 4 * (heads + nw) * n * n


def attention_calls(model, x) -> list:
    """(heads, B_, N, d, nW) of each window attention of one forward of
    ``model`` (the reference) on ``x``, in order."""
    calls = []

    def note(m, args):
        w, mask = args[0], args[1] if len(args) > 1 else None
        calls.append((m.heads, w.shape[0], w.shape[1], w.shape[2] // m.heads,
                      0 if mask is None else mask.shape[0]))

    hooks = [m.register_forward_pre_hook(note) for m in model.modules()
             if isinstance(m, ref.WindowAttention)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def serve_counts(cfg: dict, batch: int) -> dict:
    """One request of ``batch`` tiles: ``tile_flops`` (the whole forward a
    tile), ``attn_flops`` and ``attn_bytes`` (every window attention of the
    request, float32) and ``attn_calls``."""
    t = cfg["model"]["tile"]
    with torch.device("meta"):
        model = ref.build(cfg).eval()
        one = torch.empty(1, cfg["model"]["in_chans"], t, t)
        x = torch.empty(batch, cfg["model"]["in_chans"], t, t)
        tile_flops = counts.step_flops(model, one)
        calls = attention_calls(model, x)
    return {"tile_flops": tile_flops,
            "attn_flops": sum(attention_flops(*c[:4]) for c in calls),
            "attn_bytes": sum(attention_bytes(*c) for c in calls),
            "attn_calls": len(calls)}
