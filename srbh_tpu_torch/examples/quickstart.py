"""End to end on synthetic data: train -> evaluate -> map a city.

    python -m srbh_tpu_torch.examples.quickstart [workdir] [--cpu]

The port's twin of ``examples/quickstart.py``: the reference workflow
(its README's steps) at a tiny size. It writes synthetic Sentinel-2 (6-band
uint16), Sentinel-1 (2-band float32) and 2.5 m height tiles with their
split lists and min-max tables, trains the height model for two epochs
(``train.trainer.main``), evaluates the checkpoint (``main_test``: the
``acc`` / ``_seg`` / ``_he`` files), and maps a synthetic city with the
trained model (``predict.predictor.predict_city``: a build and a height
GeoTIFF). For the paper's pipeline, put real tiles in place of the
synthetic ones and the flagship's widths in place of the tiny ones
(``encoder_name="efficientnet-b4"``, ``sr_num_block=23``,
``sr_num_feat=64``, ``sr_num_grow=32``, ``super_mid=16``).

It runs on the card unless asked for the CPU (``--cpu``,
``main(device="cpu")``), and uses no pandas: the lists are written with
the ``csv`` module.
"""
from __future__ import annotations

import csv
import os
import sys

import numpy as np
import torch

from srbh_tpu_torch import resolve_device

GEO = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)  # 10 m, EPSG:32650 origin


def build_synthetic_dataset(root: str, n_tiles: int = 8, tile: int = 32):
    """Write the tiles, the train / val / test lists and the normalisation
    tables under ``root``; returns (data dir, stats dir)."""
    from srbh_tpu_torch.data.tiff import write_tiff

    data = os.path.join(root, "data")
    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(n_tiles)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    for n in names:
        write_tiff(os.path.join(data, "s2c", n),
                   rng.integers(0, 5000, (tile, tile, 6)).astype(np.uint16),
                   geotransform=GEO)
        write_tiff(os.path.join(data, "s1c", n),
                   rng.uniform(-25, 5, (tile, tile, 2)).astype(np.float32),
                   geotransform=GEO)
        write_tiff(os.path.join(data, "bhc", n),
                   rng.integers(0, 100, (tile * 4, tile * 4)).astype(np.uint8),
                   geotransform=(GEO[0], 2.5, 0.0, GEO[3], 0.0, -2.5))
    for split in ("train", "val", "test"):
        with open(os.path.join(data, f"dl_{split}.csv"), "w", newline="") as f:
            csv.writer(f).writerows((n, "s1c", "s2c", "bhc") for n in names)
    stats = os.path.join(root, "stats")
    os.makedirs(stats, exist_ok=True)
    np.savetxt(os.path.join(stats, "s2c_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(stats, "s1c_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(os.path.join(stats, "bh_stats.txt"), hist)
    return data, stats


def tiny_config(root: str, data: str, stats: str):
    """The smallest configuration that runs: the reference's flags with a
    test-size model (no frozen SR checkpoint: random SR weights)."""
    from srbh_tpu_torch.train.config import TrainConfig

    return TrainConfig(
        datapath=data, trainlist="dl_train.csv", vallist="dl_val.csv",
        testlist="dl_test.csv", logdir=os.path.join(root, "logs"),
        logdirhr=os.path.join(root, "no_sr_ckpt"), datastats=stats,
        preweight=os.path.join(stats, "bh_stats.txt"),
        s1dir="s1c", s2dir="s2c", bhdir="bhc",
        maxepoch=2, batch_size=4, num_workers=0,
        encoder_name="efficientnet-test", super_mid=8,
        sr_num_block=1, sr_num_feat=8, sr_num_grow=8, tile=32)


def predict_demo_city(root: str, cfg, model, sr, device):
    """Map a synthetic 130 x 100 city (S2, S1, a WSF mask, the 64 / 56
    fishnet and its validity) with the trained models; returns the build
    and height GeoTIFF paths."""
    from srbh_tpu_torch.data.grid import (
        GridImageDataset,
        fishgrid_stats,
        write_fishgrid,
    )
    from srbh_tpu_torch.data.tiff import write_tiff
    from srbh_tpu_torch.predict.predictor import make_city_step, predict_city

    city = os.path.join(root, "city")
    os.makedirs(city, exist_ok=True)
    rng = np.random.default_rng(1)
    w, h = 130, 100
    write_tiff(os.path.join(city, "demo_s2.tif"),
               rng.integers(0, 5000, (h, w, 6)).astype(np.uint16),
               geotransform=GEO)
    write_tiff(os.path.join(city, "demo_s1.tif"),
               rng.uniform(-25, 5, (h, w, 2)).astype(np.float32),
               geotransform=GEO)
    write_tiff(os.path.join(city, "demo_wsf.tif"),
               (rng.random((h, w)) < 0.5).astype(np.uint8) * 255,
               geotransform=GEO)
    write_fishgrid(os.path.join(city, "demo_s2.tif"), 64, 56)
    fishgrid_stats(os.path.join(city, "demo_wsf.tif"),
                   os.path.join(city, "demo_s2_grid.shp"))
    step = make_city_step(model.eval(), sr.eval(), dtype=torch.float32,
                          device=device)
    ds = GridImageDataset(city, "demo", cfg.datastats, s1dir="s1c",
                          s2dir="s2c", gridvalid="isv", nchans=cfg.nchanss2)
    return predict_city(ds, step, os.path.join(root, "pred"), "demo",
                        chans_build=cfg.chans_build, batch_size=4,
                        device=device)


def main(root: str = "quickstart_out", device=None):
    """Train, evaluate and map under ``root`` on ``device`` (``None`` is
    the card; without one this raises unless ``device="cpu"``). Returns the
    city's (build, height) GeoTIFF paths."""
    from srbh_tpu_torch.train import trainer

    dev = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    data, stats = build_synthetic_dataset(root)
    cfg = tiny_config(root, data, stats)

    print("== train (2 tiny epochs) ==")
    state = trainer.main(cfg, writer=None, device=dev)
    print(f"   trained {int(state.step)} steps; checkpoints in {cfg.logdir}")

    print("== evaluate (acc / seg / he files) ==")
    trainer.main_test(cfg, suffix="demo", device=dev)
    accs = sorted(f for f in os.listdir(cfg.logdir) if f.startswith("acc"))
    print("   wrote", accs)

    print("== map a city ==")
    build_tif, height_tif = predict_demo_city(root, cfg, state.model,
                                              state.sr_model, dev)
    print("   wrote", build_tif, "and", height_tif)
    return build_tif, height_tif


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(args[0] if args else "quickstart_out",
         device="cpu" if "--cpu" in sys.argv[1:] else None)
