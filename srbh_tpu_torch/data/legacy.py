"""Legacy dataset variants (SURVEY.md §2.4 #33): earlier experiment loaders
kept for API parity.

The port's copy of ``srbh_tpu/data/legacy.py``, without pandas or cv2 (the
card's machine has neither): datalists are lists of rows (``read_rows``)
where the JAX package holds a DataFrame, resizes are
``data/raster.py``'s (nearest exact, bilinear within float rounding of
cv2's), labels are read by ``data/png.py`` when they are PNG files and by
``data/tiff.py`` otherwise, and the training augmentation is
``augment_pair_lowres`` on the low-res image, the JAX package's own
bit-identical form of its x4-nearest-up / augment / subsample sequence.

* :class:`SimpleTileDataset`    — myImageFloder (BH_loader.py:65-105): tif
  image /255 + height map, joint aug, optional multi-scale height pyramid.
* :class:`WholeImageDataset`    — wholeimgLoader (BH_loader.py:828-905):
  stride-grid windows over whole-city S2+S1 rasters, per-window normalise,
  symmetric-pad ragged edge windows to the grid size, returns
  (image, [xoff, yoff, xcount, ycount]).
* :func:`load_whole_s12`        — load_s12 (BH_loader.py:761-810): load +
  normalise a full city mosaic, symmetric-pad to a stride multiple, return
  the padded array, original size and window positions.
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import numpy as np

from srbh_tpu_torch.data import png
from srbh_tpu_torch.data.augment import augment_pair_lowres
from srbh_tpu_torch.data.datalist import read_rows
from srbh_tpu_torch.data.raster import resize_linear, resize_nearest
from srbh_tpu_torch.data.tiff import TiffReader, read_tiff
from srbh_tpu_torch.ops.normalize import load_stats_table, norm_offsets


class SimpleTileDataset:
    """Image (/255) + height tiles from a 2-column datalist CSV (its rows in
    ``self.datalist``)."""

    def __init__(self, datalist: str, aug: bool = False, num_sample: int = 0,
                 multi_scale: bool = False, seed: int = 1337):
        self.datalist = read_rows(datalist)
        if num_sample > 0:
            self.datalist = self.datalist[:num_sample]
        self.aug = aug
        self.multi_scale = multi_scale
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.datalist)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _sample_rng(self, index: int) -> np.random.Generator:
        # pure function of (seed, epoch, index): thread-safe under the
        # threaded loader, reproducible for any num_workers
        return np.random.default_rng((self.seed, self._epoch, index))

    def __getitem__(self, index):
        img = read_tiff(self.datalist[index][0]).astype(np.float32)
        lab = read_tiff(self.datalist[index][1])[..., 0]
        if self.aug:
            img, lab = augment_pair_lowres(self._sample_rng(index), img, lab)
        img = img / 255.0
        sample = {"image": np.ascontiguousarray(img)}
        if self.multi_scale:
            lh, lw = lab.shape
            sample["height"] = {
                "stage1": resize_nearest(lab, lw // 4, lh // 4
                                         ).astype(np.float32),
                "stage2": resize_nearest(lab, lw // 2, lh // 2
                                         ).astype(np.float32),
                "stage3": lab.astype(np.float32),
            }
        else:
            sample["height"] = lab.astype(np.float32)
        return sample


class WholeImageDataset:
    """Stride-grid windows over `{city}_s2_rgbnir_clip.tif` +
    `{city}_s1_vvvhratio_clip.tif` (older naming), symmetric-padded."""

    def __init__(self, rootname: str, cityname: str, datastats: str,
                 normmethod: str = "minmax", datarange=(0, 1),
                 grid: int = 1024, stride: int = 1000,
                 s2name: str = "s2_rgbnir", s1name: str = "s1_vvvhratio"):
        self.s2path = os.path.join(rootname, f"{cityname}_{s2name}_clip.tif")
        self.s1path = os.path.join(rootname, f"{cityname}_{s1name}_clip.tif")
        self.s2 = TiffReader(self.s2path)
        self.s1 = TiffReader(self.s1path)
        if (self.s2.width, self.s2.height) != (self.s1.width, self.s1.height):
            raise ValueError("width/height mismatch in s1 & s2")
        self.width, self.height = self.s2.width, self.s2.height
        self.geotrans = self.s2.geotransform
        self.pos = [(x, y) for x in range(0, self.width, stride)
                    for y in range(0, self.height, stride)]
        self.s2_off, self.s2_scale = norm_offsets(load_stats_table(
            os.path.join(datastats, f"{s2name}_{normmethod}.txt")), normmethod)
        self.s1_off, self.s1_scale = norm_offsets(load_stats_table(
            os.path.join(datastats, f"{s1name}_{normmethod}.txt")), normmethod)
        self.grid = grid
        self.datarange = datarange

    def __len__(self):
        return len(self.pos)

    def __getitem__(self, index):
        xoff, yoff = self.pos[index]
        xcount = min(self.grid, self.width - xoff)
        ycount = min(self.grid, self.height - yoff)
        s2 = self.s2.read((xoff, yoff, xcount, ycount))
        s1 = self.s1.read((xoff, yoff, xcount, ycount))
        bs2 = s2.shape[-1]
        img = np.concatenate([s2, s1], -1).astype(np.float32)
        img[..., :bs2] = (img[..., :bs2] - self.s2_off) / self.s2_scale
        img[..., bs2:] = (img[..., bs2:] - self.s1_off) / self.s1_scale
        if isinstance(self.datarange, tuple):
            img = img.clip(*self.datarange)
        img = np.pad(img, ((0, self.grid - ycount), (0, self.grid - xcount),
                           (0, 0)), mode="symmetric")
        return {"image": img,
                "pos": np.array([xoff, yoff, xcount, ycount], np.int32)}


def _load_label(labpath: str) -> np.ndarray:
    """``cv2.imread(labpath, IMREAD_UNCHANGED)`` of a PNG or a TIFF label:
    one band as (H, W)."""
    with open(labpath, "rb") as f:
        is_png = f.read(8) == png.PNG_SIGNATURE
    if is_png:
        return png.imread(labpath, png.IMREAD_UNCHANGED)
    lab = read_tiff(labpath)
    return lab[..., 0] if lab.ndim == 3 else lab


def _scale_pair(img: np.ndarray, lab: np.ndarray, scale: float):
    if scale != 1.0:
        h, w = img.shape[:2]
        img = resize_linear(img, int(w * scale), int(h * scale))
        lab = resize_nearest(lab, int(w * scale), int(h * scale))
    return img, lab


def preprocess_imglab(testlist: Sequence[Sequence[str]], idx: int,
                      scale: float = 1.0):
    """Single-sample loader (utils/preprocess.py:11-24): ``testlist`` is
    the datalist's rows, row = (img, label) paths; returns (image /255 as
    (1, H, W, C) float32, (1, H, W) label, raw image). NHWC instead of the
    reference's NCHW tensor."""
    img = read_tiff(testlist[idx][0])
    lab = _load_label(testlist[idx][1])
    x = (img.astype(np.float32) / 255.0)
    x, lab = _scale_pair(x, lab, scale)
    return x[None], lab[None], img


def preprocess_s12lab(testlist: Sequence[Sequence[str]], idx: int,
                      scale: float = 1.0):
    """S2+S1 pair loader (utils/preprocess.py:26-44): the S1 tile lives in
    the sibling ``sen1/`` dir under the same basename; channels concat."""
    s2_path = testlist[idx][0]
    root = os.path.dirname(os.path.dirname(s2_path))
    base = os.path.basename(s2_path)
    s2 = read_tiff(s2_path)
    s1 = read_tiff(os.path.join(root, "sen1", base))
    img = np.concatenate([s2, s1], axis=-1)
    lab = _load_label(testlist[idx][1])
    x = img.astype(np.float32) / 255.0
    x, lab = _scale_pair(x, lab, scale)
    return x[None], lab[None], img


def preprocess_tlclab(testlist: Sequence[Sequence[str]], idx: int,
                      scale: float = 1.0):
    """Image+TLC loader (utils/preprocess.py:47-73): the true-colour
    companion is ``tlc/tlc<suffix>`` next to the image dir; returns the
    first three normalised channels as the preview."""
    img_path = testlist[idx][0]
    name = os.path.basename(img_path)
    root = os.path.dirname(os.path.dirname(img_path))
    img = read_tiff(img_path)
    tlc = read_tiff(os.path.join(root, "tlc", "tlc" + name[3:]))
    img = np.concatenate([img, tlc], axis=-1)
    lab = _load_label(testlist[idx][1])
    x = img.astype(np.float32) / 255.0
    x, lab = _scale_pair(x, lab, scale)
    return x[None], lab[None], x[..., :3]


def preprocess_t1t2(testlist: Sequence[Sequence[str]], idx: int,
                    scale: float = 1.0):
    """Bi-temporal loader (utils/preprocess.py:76-103): img1+tlc1+img2+tlc2
    stacks from sibling dirs, label at ``lab/lab<suffix>.png``."""
    img_path = testlist[idx][0]
    base = os.path.basename(img_path)[:-4]
    root = os.path.dirname(os.path.dirname(img_path))
    parts = [read_tiff(img_path),
             read_tiff(os.path.join(root, "tlc1", base + ".tif")),
             read_tiff(os.path.join(root, "img2", base + ".tif")),
             read_tiff(os.path.join(root, "tlc2", base + ".tif"))]
    # reference order: img1, tlc1, img2, tlc2 (utils/preprocess.py:89)
    img = np.concatenate([parts[0], parts[1], parts[2], parts[3]], axis=-1)
    lab = _load_label(os.path.join(root, "lab", "lab" + base[3:] + ".png"))
    x = img.astype(np.float32) / 255.0
    x, lab = _scale_pair(x, lab, scale)
    return x[None], lab[None], x[..., :3]


def load_whole_s12(rootname: str, cityname: str, datastats: str,
                   normmethod: str = "minmax", datarange=(0, 1),
                   grid: int = 1024, stride: int = 24,
                   s2name: str = "s2_rgbnir", s1name: str = "s1_vvvhratio"
                   ) -> Tuple[np.ndarray, Tuple[int, int], list]:
    """Whole-mosaic load (BH_loader.py:761-810): note the reference treats
    ``stride`` as the OVERLAP (``stride = grid - stride``)."""
    step = grid - stride
    s2 = read_tiff(os.path.join(rootname, f"{cityname}_{s2name}_clip.tif"))
    s1 = read_tiff(os.path.join(rootname, f"{cityname}_{s1name}_clip.tif"))
    bs2 = s2.shape[-1]
    img = np.concatenate([s2, s1], -1).astype(np.float32)
    s2_off, s2_scale = norm_offsets(load_stats_table(
        os.path.join(datastats, f"{s2name}_{normmethod}.txt")), normmethod)
    s1_off, s1_scale = norm_offsets(load_stats_table(
        os.path.join(datastats, f"{s1name}_{normmethod}.txt")), normmethod)
    img[..., :bs2] = (img[..., :bs2] - s2_off) / s2_scale
    img[..., bs2:] = (img[..., bs2:] - s1_off) / s1_scale
    if isinstance(datarange, tuple):
        img = img.clip(*datarange)
    h, w = img.shape[:2]
    rows = int(math.ceil((h - grid) / step) * step + grid)
    cols = int(math.ceil((w - grid) / step) * step + grid)
    img = np.pad(img, ((0, rows - h), (0, cols - w), (0, 0)), "symmetric")
    pos = [(i, j) for i in range(0, rows, step) for j in range(0, cols, step)]
    return img, (h, w), pos
