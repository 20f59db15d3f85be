"""The training / evaluation tile dataset, on the host (numpy).

The port's :class:`S12GlobeDataset` of ``srbh_tpu/data/dataset.py:43-216``
(BH_loader.py:282-400), on its host-augmentation path: S2 (first
``nchans`` bands) + S1 GeoTIFF tiles, per-band min-max or mean-std
normalisation clipped to ``datarange``, joint augmentation at the x4 grid,
the hierarchical class mask and per-pixel weights, and the 64x64 aggregated
height target. The pixel recipe is the reference's: image x4 nearest ->
augment -> normalise -> x0.25 nearest -> clip, computed in its fused low-res
form (``data/augment.py``). The data list is read with the ``csv`` module.
"""
from __future__ import annotations

import csv
import os
from typing import Optional, Tuple

import numpy as np

from srbh_tpu_torch.data.augment import augment_pair_lowres
from srbh_tpu_torch.data.tiff import read_tiff
from srbh_tpu_torch.ops.hierarchy import (
    DEFAULT_HIR,
    WEIGHT_METHODS,
    build_hierarchy_lut,
)
from srbh_tpu_torch.ops.normalize import load_stats_table, norm_offsets


def _aggregate_numpy(height: np.ndarray, scale: float = 0.25) -> np.ndarray:
    """Block mean over valid (h >= 0) pixels, in float64
    (aggregate_utils.py:29-41)."""
    step = int(round(1 / scale))
    h, w = height.shape
    blocks = height.reshape(h // step, step, w // step, step).astype(np.float64)
    num = blocks.sum(axis=(1, 3))
    den = (blocks >= 0).sum(axis=(1, 3))
    return (num / (den + 1e-10)).astype(np.float32)


def _read_datalist(path: str, s1dir: str, s2dir: str, heightdir: str):
    """Rows ``(basename, s1dir, s2dir, heightdir, ...)`` of a header-less CSV
    list; a one-column list takes the given directories."""
    with open(path, newline="") as f:
        rows = [tuple(r) for r in csv.reader(f) if r]
    if rows and all(len(r) == 1 for r in rows):
        rows = [(r[0], s1dir, s2dir, heightdir) for r in rows]
    return rows


class S12GlobeDataset:
    """Sentinel-2 + Sentinel-1 tile dataset with hierarchy targets."""

    def __init__(self, datalist: str, rootname: str, datastats: str = "datastats",
                 normmethod: str = "minmax", datarange: Optional[Tuple] = (0, 1),
                 aug: bool = False, num_sample: int = 0,
                 s1dir: str = "s1", s2dir: str = "s2", heightdir: str = "bh",
                 preweight: Optional[str] = None, isaggre: bool = False,
                 ishir: bool = False, hir=DEFAULT_HIR, nchans: int = 6,
                 weightmethod: str = "sqrt", seed: int = 1337):
        if isaggre and not ishir:
            # the aggregated weights index the hierarchy LUT (the reference
            # fails the same way, BH_loader.py:326-329, 389)
            raise ValueError("isaggre=True requires ishir=True")
        self.nchans = nchans
        self._rows = _read_datalist(datalist, s1dir, s2dir, heightdir)
        if num_sample > 0:
            self._rows = self._rows[:num_sample]
        self.aug = aug
        self.rootname = rootname
        self.s2_off = self.s2_scale = self.s1_off = self.s1_scale = None
        # a missing table is only an error when a sample needs it
        # (__getitem__ raises then, as the reference's np.loadtxt does)
        self._s2_stats_path = os.path.join(datastats, f"{s2dir}_{normmethod}.txt")
        if nchans > 0 and os.path.exists(self._s2_stats_path):
            self.s2_off, self.s2_scale = norm_offsets(
                load_stats_table(self._s2_stats_path, nchans), normmethod)
        self._s1_stats_path = os.path.join(datastats, f"{s1dir}_{normmethod}.txt")
        if os.path.exists(self._s1_stats_path):
            self.s1_off, self.s1_scale = norm_offsets(
                load_stats_table(self._s1_stats_path), normmethod)
        self.datarange = datarange
        self.heightweight = np.ones((len(hir) - 1,))
        if preweight is not None:
            self.heightweight = WEIGHT_METHODS.get(
                weightmethod, WEIGHT_METHODS["sqrt"])(np.loadtxt(preweight), hir)
        self.isaggre = isaggre
        self.ishir = ishir
        self.buildhir = build_hierarchy_lut(hir) if ishir else None
        self.seed = seed
        self._epoch = 0
        self._weight32 = self.heightweight.astype(np.float32)

    def __len__(self):
        return len(self._rows)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream; the loader calls it at the start
        of every epoch."""
        self._epoch = int(epoch)

    def _sample_rng(self, index: int) -> np.random.Generator:
        """The augmentation RNG, a pure function of (seed, epoch, index): the
        same draws whatever the number or order of loader workers."""
        return np.random.default_rng((self.seed, self._epoch, index))

    def _load_pair(self, index):
        basename, s1dir, s2dir, bhdir = self._rows[index][:4]
        s2 = read_tiff(os.path.join(self.rootname, s2dir, basename))[..., : self.nchans]
        s1 = read_tiff(os.path.join(self.rootname, s1dir, basename))
        img = np.concatenate([s2, s1], axis=-1).astype(np.float32)
        hpath = os.path.join(self.rootname, bhdir, basename)
        if os.path.exists(hpath):
            height = read_tiff(hpath)[..., 0]
        else:
            height = np.ones((256, 256), np.uint8)  # BH_loader.py:346
        return img, height, os.path.join(self.rootname, s2dir, basename)

    def __getitem__(self, index):
        img, height, img_path = self._load_pair(index)
        if self.aug:
            img, height = augment_pair_lowres(self._sample_rng(index), img, height)
        # normalise: the first nchans bands are S2, the rest S1
        # (BH_loader.py:361-363)
        bs2 = self.nchans
        if bs2 > 0:
            if self.s2_off is None:
                raise FileNotFoundError(
                    f"missing S2 stats table {self._s2_stats_path}")
            img[..., :bs2] = (img[..., :bs2] - self.s2_off) / self.s2_scale
        if img.shape[-1] > bs2:
            if self.s1_off is None:
                raise FileNotFoundError(
                    f"missing S1 stats table {self._s1_stats_path}")
            img[..., bs2:] = (img[..., bs2:] - self.s1_off) / self.s1_scale
        if isinstance(self.datarange, tuple):
            img = img.clip(*self.datarange)
        return self._finish_sample(img, height, img_path)

    def _finish_sample(self, img, height, img_path):
        height = height.astype(np.float32)
        if self.ishir:
            build = self.buildhir[height.astype(np.int64).clip(0, 255)]
            weight = self._weight32[build]
        else:
            build = (height > 0).astype(np.int64)
            weight = np.ones_like(build, np.float32)
        sample = {"image": np.ascontiguousarray(img),
                  "height": height, "build": build.astype(np.int32),
                  "weight": weight, "path": img_path}
        if self.isaggre:
            aggre = _aggregate_numpy(height, 0.25)
            build_aggre = self.buildhir[aggre.astype(np.int64).clip(0, 255)]
            sample["height_aggre"] = aggre
            sample["weight_aggre"] = self._weight32[build_aggre]
        return sample
