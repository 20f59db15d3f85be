"""Per-stage times of the flagship serving path on one card.

    python -m srbh_tpu_torch.tools.profile_flagship [--batch 32]
        [--dtype bfloat16] [--stages trunk,hrfeat,...]

Counterpart of ``srbh_tpu/tools/profile_flagship.py:73-170``. It splits the
serving path that ``srbh_tpu_torch.bench`` times into stages and times each
on seeded inputs of its real shape, on the card:

========  ====================================================
trunk     frozen RRDBNet features (B, 3, 64, 64) -> (B, 64, 256, 256)
hrfeat    ``model.hrfeat``: (B, 64, 256, 256) -> (B, 16, 256, 256)
encdec    the EfficientNet encoder and both U-Net decoders
heads     the ``reg`` and ``seg`` HRFuseResidual heads
aggre     the 64x64 aggregation conv
postproc  the post-processing (``predictor.postprocess``)
full      the whole path (``predictor.serving_outputs``)
========  ====================================================

A stage runs under ``torch.inference_mode()`` and, for bfloat16, autocast
(the post-processing is float32). Each is timed with the step timer
(``tools/timing.step_stats``: a host clock around calls that end in a
synchronize); one whose median is under ``SHORT_MS`` is timed again with
``tools/timing.device_ms`` (a CUDA graph of back-to-back calls), since
its host time would otherwise set its pace. ``full`` is printed beside the
sum of the parts. The JAX tool's ``*_packed`` and ``heads_grouped`` stages
(the space-to-depth and grouped-conv forms) raise: ROADMAP item 15.
"""
from __future__ import annotations

import argparse
import os

import torch

from srbh_tpu_torch import entry, resolve_device
from srbh_tpu_torch.predict.predictor import (
    compute_type,
    postprocess,
    serving_outputs,
)
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.timing import DTYPES

STAGES = ("trunk", "hrfeat", "encdec", "heads", "aggre", "postproc", "full")
PARTS = STAGES[:-1]
SHORT_MS = 2.0


def stage_fns(model, sr, dtype) -> dict:
    """The stage functions on NCHW tensors; composed, they give ``full``
    (see :func:`compose`)."""

    def run(fn, amp=True):
        def stage(*args):
            with torch.inference_mode(), compute_type(
                    args[0].device, dtype if amp else torch.float32):
                return fn(*args)
        return stage

    def encdec(x):
        feats = model.encoder(x)
        return model.decoder1(*feats), model.decoder2(*feats)

    return {
        "trunk": run(lambda x3: sr(x3, features_only=True)),
        "hrfeat": run(model.hrfeat),
        "encdec": run(encdec),
        "heads": run(lambda d1, d2, hr: (model.reg(d1, hr), model.seg(d2, hr))),
        "aggre": run(model.aggre_height),
        "postproc": run(postprocess, amp=False),
        "full": run(lambda x: serving_outputs(model, sr, x, dtype=dtype)),
    }


def compose(fns, x):
    """The serving outputs of NCHW ``x`` through the stages, one after
    another."""
    d1, d2 = fns["encdec"](x)
    hr = fns["hrfeat"](fns["trunk"](x[:, :3]))
    return fns["postproc"](*fns["heads"](d1, d2, hr))


def stage_inputs(model, sr, batch: int, tile: int, seed: int, device) -> dict:
    """Seeded uniform inputs of each stage's real shape on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hr_side = 4 * tile
    mid, super_mid = model.aggre_height.in_channels, model.hrfeat[-1].conv2.out_channels
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    x = rand(batch, 8, tile, tile)
    dec, hr = rand(batch, mid, tile, tile), rand(batch, super_mid, hr_side, hr_side)
    return {"trunk": (x[:, :3],),
            "hrfeat": (rand(batch, sr.conv_first.out_channels, hr_side, hr_side),),
            "encdec": (x,), "heads": (dec, dec, hr), "aggre": (dec,),
            "postproc": (rand(batch, 1, hr_side, hr_side),
                         rand(batch, 7, hr_side, hr_side)),
            "full": (x,)}


def run(batch: int = 32, dtype: str = "bfloat16", stages=STAGES,
        repeats: int = 5, seed: int = 0, tile: int = 64, tiny: bool = False,
        device=None) -> dict:
    """One record of every stage's times on ``device`` (``None`` is the
    card); off a card each stage runs once and its times are ``None``."""
    bad = [s for s in stages if s not in STAGES]
    if any(s.endswith("_packed") or s == "heads_grouped" for s in bad):
        raise NotImplementedError(f"stages {bad}: the packed and grouped "
                                  "forms are not ported: ROADMAP.md Queue 1 "
                                  "item 15")
    if bad:
        raise ValueError(f"unknown stages {bad}; known: {STAGES}")
    dev = resolve_device(device)
    model, sr, _ = entry.flagship(tile=tile, batch=batch, tiny=tiny,
                                  device=dev, seed=seed)
    fns = stage_fns(model, sr, DTYPES[dtype])
    ins = stage_inputs(model, sr, batch, tile, seed, dev)
    out = {}
    for name in stages:
        fn, args = fns[name], ins[name]
        stats = timing.step_stats(lambda i: fn(*args), dev, repeats)
        stats["timer"] = "step"
        if stats["median_ms"] is not None and stats["median_ms"] < SHORT_MS:
            stats["median_ms"] = timing.device_ms(lambda: fn(*args), calls=10,
                                                  replays=5, repeats=repeats)
            stats["q1_ms"] = stats["q3_ms"] = stats["event_ms"] = None
            stats["timer"] = "graph"
        out[name] = stats
    medians = [out[s]["median_ms"] for s in PARTS if s in out]
    parts = (sum(medians) if medians and None not in medians
             and len(medians) == len(PARTS) else None)
    full = out.get("full", {}).get("median_ms")
    return {"tool": "profile_flagship", "batch": batch, "dtype": dtype,
            **timing.device_record(dev),
            "repeats": repeats if dev.type == "cuda" else 0, "stages": out, "sum_of_parts_ms": parts, "full_ms": full,
            "full_tiles_per_sec": None if full is None else 1e3 * batch / full}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.profile_flagship")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "profile_flagship.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    rec = run(args.batch, args.dtype, args.stages.split(","), args.repeats,
              args.seed, device=dev)
    timing.emit([rec], args.out)
    return rec


if __name__ == "__main__":
    main()
