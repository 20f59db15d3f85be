"""Train-step time by stage and peak memory against the batch size.

    python -m srbh_tpu_torch.tools.train_diag [--batch 16 32 ...]

Counterpart of ``srbh_tpu/tools/train_diag.py:38-172``. For each batch size
it times three things on the card (``tools/timing.step_stats``: a host
clock around calls that end in a synchronize; seeded batches already on
the card, two in turn):

====  =============================================================
sr    the frozen RRDBNet-23 feature forward alone (``no_grad``)
fwd   the step's forward with the SR pass and the three losses,
      without gradients (``step.forward_loss`` under ``no_grad``)
step  the whole train step (forward, backward, Adam), state carried
====  =============================================================

in float32, the trainer's default, and the memory the step takes:
``max_memory_allocated`` and ``max_memory_reserved`` after
``reset_peak_memory_stats`` (the port's form of the JAX tool's
``memory_stats`` peak). ``SRBH_TRAIN_REMAT=1`` measures the model with its
256^2 fusion stack recomputed in the backward pass (``remat``).
"""
from __future__ import annotations

import argparse
import os

import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.train_bench import build, host_batches, train_config


def diagnose(batch: int, repeats: int = 5, seed: int = 0, tile: int = 64,
             tiny: bool = False, device=None) -> dict:
    """The record of one batch size on ``device`` (``None`` is the card);
    off a card each part runs once and times and memory are ``None``."""
    remat = os.environ.get("SRBH_TRAIN_REMAT", "") == "1"
    dev = resolve_device(device)
    state, step = build(train_config(tiny, seed=1337, remat=remat),
                        torch.float32, dev, False, False)
    sr = state.sr_model
    batches = host_batches(2, batch, tile, seed, dev)
    images = [b["image"].permute(0, 3, 1, 2)[:, :3] for b in batches]
    lr = 1e-3

    def sr_fwd(i):
        with torch.no_grad():
            return sr(images[i % 2], features_only=True)

    def fwd(i):
        with torch.no_grad():
            loss, _ = step.forward_loss(state, batches[i % 2])
        if not torch.isfinite(loss):
            raise AssertionError("loss forward not finite")

    t_sr = timing.step_stats(sr_fwd, dev, repeats)
    t_fwd = timing.step_stats(fwd, dev, repeats)
    t_step = timing.step_stats(lambda i: step(state, batches[i % 2], lr), dev,
                               repeats)
    cuda = dev.type == "cuda"
    return {"tool": "train_diag", "batch": batch, "dtype": "float32",
            "remat": remat,
            **timing.device_record(dev),
            "repeats": repeats if cuda else 0,
            "sr": t_sr, "fwd": t_fwd, "step": t_step,
            "sr_fwd_ms": t_sr["median_ms"], "loss_fwd_ms": t_fwd["median_ms"],
            "step_ms": t_step["median_ms"],
            "tiles_per_sec": timing.per_second(batch, t_step),
            "max_memory_allocated_gib": timing.peak_gib(dev),
            "max_memory_reserved_gib": (torch.cuda.max_memory_reserved(dev) / 2**30
                                        if cuda else None)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.train_diag")
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "train_diag.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = []
    for b in args.batch:
        records.append(diagnose(b, args.repeats, args.seed, device=dev))
        torch.cuda.empty_cache()
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
