"""Real-ESRGAN GAN train-step throughput on one card.

    python -m srbh_tpu_torch.tools.sr_train_bench [--batch 12]
        [--dtype float32 bfloat16]
    python -m srbh_tpu_torch.bench --sr-train [the same flags]

Counterpart of ``srbh_tpu/tools/sr_train_bench.py:48-109``: the fused step
of ``train/sr_trainer.py`` at the finetune recipe's widths
(SR/finetune_realesrgan_x4plus_pairdata.yml: RRDBNet-23 nf 64 gc 32 and its
EMA, UNetDiscriminatorSN nf 64, VGG19 perceptual; batch 12, lq 64 -> gt
256), with seeded random weights: the USM-sharpened ground truth, the
generator's L1, perceptual and GAN losses, the discriminator's real and
fake passes with their spectral-norm iterations, both Adam updates and the
EMA. The state is carried from step to step; two seeded (lq, gt) pairs,
on the card before the timed loop, alternate. On a card the step runs
with ``cudnn.benchmark`` on for its own length, as the trainer's step
always does. For each compute type it prints tiles/s at the median step
time with the quartiles, the peak memory, the idle share and the device
time by kernel of one profiled step. ``SRBH_SR_REMAT=1`` times the
generator with each RRDB recomputed in the backward pass
(``RealESRGANTrainer(remat=True)``); the metric takes ``_remat``.
"""
from __future__ import annotations

import argparse
import os

import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.timing import DTYPES
from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer


def run(batch: int = 12, dtypes=("float32", "bfloat16"), repeats: int = 5,
        seed: int = 0, steps: int = 3, lq: int = 64, num_block: int = 23,
        num_feat: int = 64, num_grow_ch: int = 32, disc_feat: int = 64,
        device=None) -> list:
    """One record per compute type of the GAN step on ``device`` (``None``
    is the card); off a card each step runs once and times are ``None``."""
    remat = os.environ.get("SRBH_SR_REMAT", "") == "1"
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pairs = [(torch.rand((batch, lq, lq, 3), generator=gen, device=dev),
              torch.rand((batch, 4 * lq, 4 * lq, 3), generator=gen, device=dev))
             for _ in range(2)]
    records = []
    for name in dtypes:
        trainer = RealESRGANTrainer(num_block=num_block, num_feat=num_feat,
                                    num_grow_ch=num_grow_ch,
                                    disc_feat=disc_feat, dtype=DTYPES[name],
                                    remat=remat)
        state = trainer.init(seed, (batch, lq, lq, 3), device=dev)
        step = trainer.make_step()
        last = {}

        def one(i):
            last.update(step(state, *pairs[i % 2]))

        stats = timing.step_stats(one, dev, repeats, steps)
        if not all(torch.isfinite(v) for v in last.values()):
            raise AssertionError(f"GAN step {name}: losses not finite")
        rec = {"tool": "sr_train_bench",
               "metric": "sr_gan_train_tiles_per_sec" + "_remat" * remat,
               "batch": batch, "lq": lq, "gt": 4 * lq, "dtype": name,
               "remat": remat,
               **timing.device_record(dev), **stats,
               "value": timing.per_second(batch, stats), "unit": "tiles/s",
               "peak_gib": timing.peak_gib(dev), "idle_share": None,
               "busy_ms": None, "kernels": None, "state_step": state.step,
               "l_g_total": last["l_g_total"].item()}
        if dev.type == "cuda":
            prof = timing.profile_window(lambda: step(state, *pairs[0]),
                                         host_ops=False, top=12)
            rec.update(idle_share=prof["idle_share"], busy_ms=prof["busy_ms"],
                       kernels=prof["kernels"])
        records.append(rec)
        del state, step, trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.sr_train_bench")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--dtype", nargs="+", choices=list(DTYPES),
                    default=list(DTYPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3,
                    help="steps back to back in each timed repeat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "sr_train_bench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = run(args.batch, args.dtype, args.repeats, args.seed, args.steps,
                  device=dev)
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
