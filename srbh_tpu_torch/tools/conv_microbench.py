"""Chained single-conv times of the fusion stack's shapes on one card.

    python -m srbh_tpu_torch.tools.conv_microbench [--batch 32]
        [--cases lit16,g2c16,g8c16,g16c16]

Counterpart of ``srbh_tpu/tools/conv_microbench.py:38-119``: each case is a
chain of square 3x3 convolutions (``Ci == Co``, stride 1, padding 1), each
conv's output the next one's input, so one link is exactly one conv. The
chain runs in a CUDA graph (``tools/timing.device_ms``: back-to-back
replays, CUDA events), so the host's launch time does not set its pace.
For each case and compute type (float32 with TF32 off, bfloat16) it prints
ms per conv and the achieved TFLOP/s, counting each output channel's
contraction over ``Ci / groups`` inputs. The ground truth for a
fusion-stack kernel:

======  ==========================================================
lit16   the heads' literal 16-channel convs at 256x256
g2c16   the two 16-wide heads as one conv of 2 groups (32 channels)
g8c16   8 images' 16 channels as one 8-group conv of 128 channels, at
        batch / 8: the same work as ``lit16``
g16c16  the same with 16 groups of 16, at batch / 16
======  ==========================================================
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.timing import DTYPES

# (channels, groups, batch divisor) at 256x256
CASES = {"lit16": (16, 1, 1), "g2c16": (32, 2, 1), "g8c16": (128, 8, 8),
         "g16c16": (256, 16, 16)}
SIDE, CHAIN = 256, 8


def case_flops(batch: int, channels: int, groups: int, side: int = SIDE) -> int:
    """FLOPs of one 3x3 conv of the case: 2 x outputs x 9 x Ci / groups."""
    return 2 * batch * side * side * channels * 9 * (channels // groups)


def time_case(batch: int, channels: int, groups: int, dtype, device,
              repeats: int = 3, side: int = SIDE, seed: int = 0) -> dict:
    """ms per conv of a ``CHAIN``-long chain and its TFLOP/s (``None`` off
    a card, where the chain runs once and is checked for shape and finite
    values)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((batch, channels, side, side), generator=gen,
                   device=device).to(dtype)
    w = ((torch.rand((channels, channels // groups, 3, 3), generator=gen,
                     device=device) - 0.5) * (6.0 / (9 * channels // groups)) ** 0.5
         ).to(dtype)

    def chain():
        y = x
        for _ in range(CHAIN):
            y = F.conv2d(y, w, padding=1, groups=groups)
        return y

    y = chain()
    if y.shape != x.shape or not torch.isfinite(y.float()).all():
        raise AssertionError(f"conv chain {tuple(y.shape)}: not finite or "
                             "not square")
    if device.type != "cuda":
        return {"ms_per_conv": None, "tflop_per_s": None}
    ms = timing.device_ms(chain, calls=2, replays=3, repeats=repeats) / CHAIN
    return {"ms_per_conv": ms,
            "tflop_per_s": case_flops(batch, channels, groups, side) / ms / 1e9}


def run(batch: int = 32, cases=tuple(CASES), dtypes=tuple(DTYPES),
        repeats: int = 3, side: int = SIDE, device=None) -> dict:
    """One record of every case in every compute type on ``device``
    (``None`` is the card)."""
    unknown = [c for c in cases if c not in CASES]
    if unknown:
        raise ValueError(f"unknown cases {unknown}; known: {list(CASES)}")
    dev = resolve_device(device)
    out = {}
    for name in cases:
        channels, groups, div = CASES[name]
        if batch % div:
            raise ValueError(f"{name} packs {div} images a group: batch "
                             f"{batch} is not a multiple")
        for dt in dtypes:
            out[f"{name}_{dt}"] = {
                "batch": batch // div, "channels": channels, "groups": groups,
                **time_case(batch // div, channels, groups, DTYPES[dt], dev,
                            repeats, side)}
    return {"tool": "conv_microbench", "batch": batch, "side": side,
            "chain": CHAIN, **timing.device_record(dev),
            "repeats": repeats if dev.type == "cuda" else 0, "cases": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.conv_microbench")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "conv_microbench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    rec = run(args.batch, args.cases.split(","), repeats=args.repeats, device=dev)
    timing.emit([rec], args.out)
    return rec


if __name__ == "__main__":
    main()
