"""Seeded training tiles in the height dataset's own on-disk form, as
``S12GlobeDataset`` reads it with ``TrainConfig``'s default names:

* ``<root>/s2globe_check/<name>``: Sentinel-2, uint16, 6 bands, 64 x 64;
* ``<root>/s1globe_check/<name>``: Sentinel-1, float32 dB, 2 bands, 64 x 64;
* ``<root>/bhglobe/<name>``: building heights, uint8 metres, 256 x 256;
* ``<root>/datalist_globe_train_0.7.csv``: the list of names;
* ``<root>/datastatsglobe/{s2globe_check,s1globe_check}_minmax.txt``: the
  min-max tables, and ``bh_stats_globe.txt``: the heights' histogram (the
  class weights' source).

Each tile is a town block: a ground of zero height with rectangular
buildings of heights drawn from a long-tailed law (most low, some towers),
and S2 / S1 bands that see them (brighter reflectance and backscatter
where buildings stand, area-averaged to 10 m) over a smooth field and
sensor noise. Drawn with numpy in chunks, written with the benchmark's
frozen TIFF writer.
"""
from __future__ import annotations

import csv
import os

import numpy as np

from benchmark.synth.tiff import write_tiff

S2DIR, S1DIR, BHDIR = "s2globe_check", "s1globe_check", "bhglobe"
STATS = "datastatsglobe"
TRAINLIST = "datalist_globe_train_0.7.csv"
S2_MAX = 5000.0
S1_RANGE = (-25.0, 5.0)
GEO = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
GEO_HR = (500000.0, 2.5, 0.0, 4649776.0, 0.0, -2.5)
BUILDINGS = 12
NAME = "t_{:05d}.tif"


def make(n: int, seed: int, chunk: int = 128) -> tuple:
    """(s2 uint16 (n, 64, 64, 6), s1 float32 (n, 64, 64, 2), heights uint8
    (n, 256, 256)) numpy."""
    rng = np.random.default_rng([seed, 0x4E16])
    s2 = np.empty((n, 64, 64, 6), np.uint16)
    s1 = np.empty((n, 64, 64, 2), np.float32)
    bh = np.empty((n, 256, 256), np.uint8)
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        y0, x0 = rng.integers(0, 240, (2, m, BUILDINGS))
        hh, ww = rng.integers(6, 48, (2, m, BUILDINGS))
        height = np.minimum(3 + rng.pareto(1.5, (m, BUILDINGS)) * 6,
                            200).astype(np.float32)
        h = np.zeros((m, 256, 256), np.float32)
        for k in range(m):
            for j in range(BUILDINGS):
                roof = h[k, y0[k, j]:y0[k, j] + hh[k, j],
                         x0[k, j]:x0[k, j] + ww[k, j]]
                np.maximum(roof, height[k, j], out=roof)
        # some tiles are open land
        h *= rng.random((m, 1, 1)) > 0.15
        bh[a:a + m] = np.round(h).astype(np.uint8)
        built = (h > 0).reshape(m, 64, 4, 64, 4).mean((2, 4))
        coarse = rng.random((m, 1, 4, 4))
        field = np.kron(coarse, np.ones((16, 16)))[:, 0]
        base = 400 + 1600 * rng.random((m, 1, 1, 6))
        refl = (base * (0.7 + 0.6 * field[..., None])
                + 1500 * built[..., None] * rng.random((m, 1, 1, 6))
                + 60 * rng.random((m, 64, 64, 6)))
        s2[a:a + m] = np.clip(np.round(refl), 0, S2_MAX).astype(np.uint16)
        back = (-18 + 6 * field[..., None] + 12 * built[..., None]
                + rng.normal(0, 1.5, (m, 64, 64, 2)))
        s1[a:a + m] = np.clip(back, *S1_RANGE).astype(np.float32)
    return s2, s1, bh


def index(path: str) -> int:
    """The tile index of a written tile's path (its name's number)."""
    return int(os.path.basename(path)[2:-4])


def write(root: str, s2: np.ndarray, s1: np.ndarray, bh: np.ndarray) -> dict:
    """Write the tiles under ``root``; returns ``TrainConfig``'s path
    arguments (``datapath``, ``datastats``, ``preweight``)."""
    for d in (S2DIR, S1DIR, BHDIR, STATS):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [NAME.format(i) for i in range(len(s2))]
    for k, name in enumerate(names):
        write_tiff(os.path.join(root, S2DIR, name), s2[k], GEO)
        write_tiff(os.path.join(root, S1DIR, name), s1[k], GEO)
        write_tiff(os.path.join(root, BHDIR, name), bh[k], GEO_HR)
    with open(os.path.join(root, TRAINLIST), "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(
            (name, S1DIR, S2DIR, BHDIR) for name in names)
    stats = os.path.join(root, STATS)
    np.savetxt(os.path.join(stats, S2DIR + "_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, S2_MAX)]))
    np.savetxt(os.path.join(stats, S1DIR + "_minmax.txt"),
               np.stack([np.full(2, S1_RANGE[0]), np.full(2, S1_RANGE[1])]))
    preweight = os.path.join(stats, "bh_stats_globe.txt")
    np.savetxt(preweight, np.bincount(bh.reshape(-1), minlength=256)
               .astype(np.float64))
    return {"datapath": root, "datastats": stats, "preweight": preweight}
