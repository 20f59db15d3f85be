"""Height train-step throughput on one card.

    python -m srbh_tpu_torch.tools.train_bench [--batch 16]
        [--dtype float32 bfloat16] [--device_aug] [--norm]
    python -m srbh_tpu_torch.bench --train [the same flags]

Counterpart of ``srbh_tpu/tools/train_bench.py:59-155``. It times
``train/steps.py:make_train_step`` at the reference's batch 16
(train.py:97): the frozen RRDBNet-23 feature pass under ``no_grad``, the
EfficientNet-B4 U-Net forward and backward, the three adaptive losses and
the Adam update, with seeded random weights. The train state is carried
from step to step; two seeded batches, already on the card before the
timed loop, alternate. Batches are the host pipeline's (image and every
target), or with ``--device_aug`` only the image and the height raster
(augmentation and targets in the step; ``SRBH_TRAIN_DEVICE_AUG=1`` is the
same switch), and with ``--norm`` too the raw S2 / S1 values (normalised in
the step). For each compute type it prints tiles/s at the median step time
with the quartiles, ``mfu`` (3 x the height model's forward FLOPs, for its
forward and backward, plus the frozen SR pass's forward, over the type's
dense peak; ``tools/timing.py``), the peak memory, the idle share and the
leading kernels of one profiled step, and, for the first compute type, the
``tools/_trace.py`` guard's counts. ``main`` turns TF32 off.

The JAX tool chains its steps in one ``fori_loop`` and perturbs the image
with the loss so that XLA cannot hoist the SR pass out of the loop; eager
PyTorch hoists nothing, and the guard checks that every convolution runs
in the timed step. ``SRBH_TRAIN_REMAT=1`` times the model with its 256^2
fusion stack recomputed in the backward pass (``remat``); the metric takes
``_remat``, and the peak memory is the figure to read beside the rate.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from srbh_tpu_torch import entry, resolve_device
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.timing import DTYPES
from srbh_tpu_torch.tools._trace import check_convs
from srbh_tpu_torch.train.config import TrainConfig
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step

# the step's normalisation tables for --norm: S2 DNs and S1 dB to [0, 1]
NORM = {"s2_off": np.full(6, 1000.0), "s2_scale": np.full(6, 3000.0),
        "s1_off": np.full(2, -25.0), "s1_scale": np.full(2, 30.0)}


def train_config(tiny: bool = False, **kw) -> TrainConfig:
    """The flagship's trainer configuration (``entry.modules``' widths);
    ``tiny`` is the small test configuration."""
    if tiny:
        kw = dict(encoder_name="efficientnet-test", super_mid=8,
                  sr_num_block=2, sr_num_feat=16, sr_num_grow=8, **kw)
    return TrainConfig(**kw)


def host_batches(n: int, batch: int, tile: int, seed: int, device,
                 device_aug: bool = False, norm: bool = False) -> list:
    """``n`` seeded train batches on ``device``: the host pipeline's (image
    and targets), or the device-aug step's (image and height raster), or
    with ``norm`` the raw S2 / S1 values and the height raster."""
    rng = np.random.default_rng(seed)
    hr = 4 * tile
    out = []
    for _ in range(n):
        height = rng.integers(0, 100, (batch, hr, hr))
        if norm:
            b = {"s2": rng.integers(0, 5000, (batch, tile, tile, 6)).astype(np.uint16),
                 "s1": rng.uniform(-25, 5, (batch, tile, tile, 2)).astype(np.float32),
                 "height": height.astype(np.uint8)}
        elif device_aug:
            b = {"image": rng.uniform(0, 1, (batch, tile, tile, 8)).astype(np.float32),
                 "height": height.astype(np.uint8)}
        else:
            b = {"image": rng.uniform(0, 1, (batch, tile, tile, 8)).astype(np.float32),
                 "height": height.astype(np.float32),
                 "weight": rng.uniform(0.5, 2.0, (batch, hr, hr)).astype(np.float32),
                 "build": rng.integers(0, 7, (batch, hr, hr)).astype(np.int32),
                 "height_aggre": rng.uniform(0, 100, (batch, tile, tile)).astype(np.float32),
                 "weight_aggre": rng.uniform(0.5, 2.0, (batch, tile, tile)).astype(np.float32)}
        out.append({k: torch.as_tensor(v, device=device) for k, v in b.items()})
    return out


def sr_reference(model, sr, batch: dict):
    """A plain forward of the models on a batch's image: the convolutions
    one train step must run (``tools/_trace.check_convs``)."""
    x = (batch["image"] if "image" in batch
         else torch.cat([batch["s2"].float(), batch["s1"]], -1))
    x = x.permute(0, 3, 1, 2).float()

    def reference():
        model.eval()
        model(x, sr(x[:, :3], features_only=True))
    return reference


def build(cfg: TrainConfig, dtype, device, device_aug: bool, norm: bool):
    """(state, step): fresh weights from ``cfg.seed``, on ``device``."""
    from srbh_tpu_torch.train.trainer import build_models

    model, sr = build_models(cfg)
    state = TrainState(model.to(device), sr_model=sr)
    step = make_train_step(model, sr, seed=cfg.seed, dtype=dtype, device=device,
                           device_aug=device_aug, norm=NORM if norm else None)
    return state, step


def run(batch: int = 16, dtypes=("float32", "bfloat16"), device_aug: bool = False,
        norm: bool = False, repeats: int = 5, seed: int = 0, tile: int = 64,
        tiny: bool = False, steps: int = 3, device=None) -> list:
    """One record per compute type of the train step on ``device`` (``None``
    is the card); off a card each step runs once and times are ``None``."""
    device_aug = device_aug or norm or os.environ.get("SRBH_TRAIN_DEVICE_AUG", "") == "1"
    remat = os.environ.get("SRBH_TRAIN_REMAT", "") == "1"
    dev = resolve_device(device)
    cfg = train_config(tiny, seed=1337, remat=remat)
    flops = entry.flops_per_tile(tiny, tile)
    flop_per_tile = 3 * flops["model"] + flops["sr"]
    batches = host_batches(2, batch, tile, seed, dev, device_aug, norm)
    lr = 1e-3
    mode = ("_devnorm" if norm else "_devaug" if device_aug else "") + (
        "_remat" if remat else "")
    records = []
    for i, name in enumerate(dtypes):
        state, step = build(cfg, DTYPES[name], dev, device_aug, norm)
        convs = (check_convs(lambda: step(state, batches[0], lr),
                             sr_reference(state.model, state.sr_model, batches[0]),
                             state.model, state.sr_model)
                 if i == 0 else None)
        last = {}

        def one(i):
            last.update(step(state, batches[i % 2], lr))

        stats = timing.step_stats(one, dev, repeats, steps)
        if not (torch.isfinite(last["loss"]) and torch.isfinite(last["rmse"])):
            raise AssertionError(f"train step {name}: loss not finite")
        tps = timing.per_second(batch, stats)
        rec = {"tool": "train_bench",
               "metric": "height_train_tiles_per_sec" + mode, "batch": batch,
               "dtype": name, "device_aug": device_aug, "norm": norm,
               "remat": remat,
               **timing.device_record(dev), **stats, "value": tps,
               "unit": "tiles/s", "flop_per_tile": flop_per_tile,
               "tflop_per_s": None if tps is None else tps * flop_per_tile / 1e12,
               "peak_tflop_per_s": None, "mfu": None,
               "peak_gib": timing.peak_gib(dev), "idle_share": None,
               "busy_ms": None, "kernels": None, "convs": convs,
               "state_step": state.step,
               "loss": last["loss"].item()}
        if dev.type == "cuda":
            prof = timing.profile_window(lambda: step(state, batches[0], lr),
                                         host_ops=False)
            rec.update(peak_tflop_per_s=timing.peak_flop_per_s(DTYPES[name]) / 1e12,
                       idle_share=prof["idle_share"], busy_ms=prof["busy_ms"],
                       kernels=prof["kernels"])
            rec["mfu"] = rec["tflop_per_s"] / rec["peak_tflop_per_s"]
        records.append(rec)
        del state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.train_bench")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", nargs="+", choices=list(DTYPES),
                    default=list(DTYPES))
    ap.add_argument("--device_aug", action="store_true")
    ap.add_argument("--norm", action="store_true",
                    help="normalise raw S2 / S1 in the step (implies --device_aug)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3,
                    help="steps back to back in each timed repeat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "train_bench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = run(args.batch, args.dtype, args.device_aug, args.norm,
                  args.repeats, args.seed, steps=args.steps,
                  device=dev)
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
