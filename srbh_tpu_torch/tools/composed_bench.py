"""Training end to end: GeoTIFFs on disk, the loader, the copy, the step.

    python -m srbh_tpu_torch.tools.composed_bench [--batch 16] [--tiles 256]
        [--workers 4 8] [--modes host device device_norm] [--epochs 2]
        [--test-scale]

Counterpart of ``srbh_tpu/tools/composed_bench.py:44-173``. The train step
(``tools/train_bench.py``) and the loader (``tools/loader_bench.py``) are
timed apart there; this tool runs them together, as ``trainer.main``'s loop
does: synthetic tiles written as GeoTIFFs (``loader_bench``'s files), the
port's loader (decode and normalise, and augmentation and targets in the
``host`` mode) in its worker processes, the copy to the card from pinned
memory, and the full-width train step in float32, the trainer's default
(seeded random weights, the same start for every mode). For each mode and worker count it prints tiles/s
over ``--epochs`` epochs after a warm one (the median and quartiles of the
epochs' times beside it) and the bytes a tile puts on the wire:

===========  ===========================================================
host         the workers augment and build every target
             (BH_loader.py:331-397); the image and five targets a tile
device       ``device_aug``: the workers decode and normalise; the step
             augments and builds the targets (the image and the height)
device_norm  also the normalisation in the step: raw S2 DNs, S1 and the
             height on the wire
===========  ===========================================================

It also times a copy of 32 MiB to the card from pageable and from pinned
memory (CUDA events), the transfer bound each mode's bytes give, and
checks that ``device`` and ``device_norm`` give the step bit-equal
batches: the image and every target after normalisation, augmentation and
target building.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.loader_bench import build_synthetic, dataset
from srbh_tpu_torch.tools.train_bench import train_config
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import _augment, make_train_step

MODES = ("host", "device", "device_norm")


def h2d_mb_s(device, nbytes: int = 32 << 20, repeats: int = 5) -> dict:
    """MB/s of a copy of ``nbytes`` to the card from pageable and from
    pinned host memory (the median of ``repeats`` copies, CUDA events)."""
    host = torch.rand(nbytes // 4, generator=torch.Generator().manual_seed(0))
    out = {}
    for name, src in (("pageable", host), ("pinned", host.pin_memory())):
        dst = torch.empty_like(src, device=device)
        dst.copy_(src)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        out[name] = nbytes / 1e3 / float(np.median(times))
    return out


def norm_tables(ds) -> dict:
    return {k: getattr(ds, k) for k in ("s2_off", "s2_scale", "s1_off", "s1_scale")}


def mode_dataset(root: str, mode: str):
    device_aug = mode != "host"
    return dataset(root, aug=not device_aug, device_aug=device_aug,
                   device_norm=mode == "device_norm")


def check_device_modes(root: str, batch: int, device) -> dict:
    """The batches the step trains on from the first ``batch`` tiles in the
    ``device`` and ``device_norm`` modes (one seed, one step): raises
    unless they are bit-equal."""
    from srbh_tpu_torch.ops.hierarchy import DEFAULT_HIR, build_hierarchy_lut

    made = {}
    for mode in ("device", "device_norm"):
        ds = mode_dataset(root, mode)
        samples = [ds[i] for i in range(batch)]
        b = {k: torch.as_tensor(np.stack([s[k] for s in samples]), device=device)
             for k in samples[0] if k != "path"}
        norm = ({k: torch.as_tensor(np.asarray(v, np.float64), device=device)
                 for k, v in norm_tables(ds).items()}
                if mode == "device_norm" else None)
        lut = torch.as_tensor(build_hierarchy_lut(DEFAULT_HIR).astype(np.int64),
                              device=device)
        cw = torch.as_tensor(ds.heightweight.astype(np.float32), device=device)
        made[mode] = _augment(b, device, 1337, 0, norm, lut, cw, True, True)
    unequal = [k for k in made["device"]
               if not torch.equal(made["device"][k], made["device_norm"][k])]
    if unequal:
        raise AssertionError(f"device and device_norm batches differ in {unequal}")
    return {"device_equals_device_norm": True, "keys": sorted(made["device"])}


def run(batch: int = 16, tiles: int = 256, workers=(4, 8), modes=MODES,
        epochs: int = 2, tiny: bool = False, device=None) -> list:
    """One record of the copy and the mode check, then one per mode and
    worker count, on ``device`` (``None`` is the card); off a card each
    loop runs its warm epoch only and times are ``None``."""
    from srbh_tpu_torch.train.trainer import build_models

    dev = resolve_device(device)
    timed = dev.type == "cuda"
    if tiles % batch:
        raise ValueError(f"tiles {tiles} is not a multiple of batch {batch}")
    bw = h2d_mb_s(dev) if timed else {"pageable": None, "pinned": None}
    records = []
    with tempfile.TemporaryDirectory(prefix="srbh_composed_") as root:
        build_synthetic(root, tiles)
        cfg = train_config(tiny, seed=1337, batch_size=batch)
        model, sr = build_models(cfg)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        records.append({"tool": "composed_bench", "metric": "h2d_bandwidth",
                        **timing.device_record(dev), "pageable_mb_s": bw["pageable"],
                        "pinned_mb_s": bw["pinned"], "bytes": 32 << 20,
                        **check_device_modes(root, batch, dev)})
        for mode in modes:
            ds = mode_dataset(root, mode)
            sample = ds[0]
            bpt = sum(v.nbytes for k, v in sample.items() if k != "path")
            step = make_train_step(
                model, sr, seed=cfg.seed, device=dev,
                device_aug=mode != "host", class_weight=ds.heightweight,
                norm=norm_tables(ds) if mode == "device_norm" else None)
            for n in workers:
                model.load_state_dict(start)
                state = TrainState(model.to(dev))
                loader = DataLoader(ds, batch_size=batch, shuffle=True,
                                    num_workers=n, seed=0, drop_last=True,
                                    device_put=True, device=dev)
                for b in loader:  # the warm epoch
                    m = step(state, b, 1e-3)
                if not torch.isfinite(m["loss"]):
                    raise AssertionError(f"{mode}: loss not finite")
                times = []
                for _ in range(epochs if timed else 0):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    for b in loader:
                        step(state, b, 1e-3)
                    torch.cuda.synchronize(dev)
                    times.append(1e3 * (time.perf_counter() - t0))
                q1, med, q3 = (np.percentile(times, (25, 50, 75)).tolist()
                               if times else (None, None, None))
                records.append({
                    "tool": "composed_bench",
                    "metric": "composed_train_tiles_per_sec", "mode": mode,
                    "num_workers": n, "batch": batch, "dtype": "float32",
                    "tiles": tiles, **timing.device_record(dev),
                    "repeats": len(times), "median_ms": med, "q1_ms": q1,
                    "q3_ms": q3, "value": (tiles * len(times) / sum(times) * 1e3
                                           if times else None),
                    "unit": "tiles/s", "bytes_per_tile": int(bpt),
                    "transfer_bound_tiles_per_sec": (
                        bw["pinned"] * 1e6 / bpt if timed else None),
                    "state_step": state.step})
                del state, loader
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.composed_bench")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tiles", type=int, default=256)
    ap.add_argument("--workers", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--test-scale", action="store_true",
                    help="tiny models (a plumbing check)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "composed_bench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = run(args.batch, args.tiles, args.workers, args.modes, args.epochs,
                  tiny=args.test_scale, device=dev)
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
