"""Per-band normalisation tables of Sentinel-1/2 tiles (numpy).

A copy of the numpy part of ``srbh_tpu/ops/normalize.py``, which the port
may not import.

Reference semantics (BH_loader.py:300-306, 361-369): a 2-row stats table where
row 0 is the per-band mean (meanstd) or min (minmax) and row 1 the std or
max; for minmax the loader rewrites row 1 to ``max - min`` in-place and then
clips the normalised tile to ``datarange=(0, 1)``.

The helpers return the (offset, scale) pair; the dataset applies it, or
:func:`normalize_tile`, which takes a numpy array or a tensor alike.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_stats_table(path: str, nchans: Optional[int] = None) -> np.ndarray:
    """Load a 2xC whitespace-separated stats table (see datasetglobe/*.txt)."""
    # ndmin=2 preserves the row/column structure: a 1-band table (two
    # lines of one value) must load as (2, 1), which np.atleast_2d on the
    # collapsed 1-D result would have turned into (1, 2)
    table = np.loadtxt(path, ndmin=2)
    if nchans is not None:
        table = table[:, :nchans]
    return table


def norm_offsets(
    table: np.ndarray, method: str = "minmax"
) -> Tuple[np.ndarray, np.ndarray]:
    """Return per-band (offset, scale) so that x_norm = (x - offset) / scale.

    minmax: offset=min, scale=max-min (BH_loader.py:304-306).
    meanstd: offset=mean, scale=std.
    """
    table = np.asarray(table, dtype=np.float64)
    offset = table[0].copy()
    if method == "minmax":
        scale = table[1] - table[0]
    elif method == "meanstd":
        scale = table[1].copy()
    else:
        raise ValueError(f"unknown normmethod {method!r}")
    return offset, scale


def normalize_tile(img, offset, scale,
                   datarange: Optional[Tuple[float, float]] = (0.0, 1.0)):
    """``(img - offset) / scale`` of an (..., C) channels-last tile (a numpy
    array or a tensor), clipped to ``datarange`` as the train and test tiles
    are (BH_loader.py:367-369); ``None`` skips the clip, as the whole-city
    grid loader does (BH_loader.py:984-986)."""
    x = (img - offset) / scale
    if datarange is not None:
        x = x.clip(datarange[0], datarange[1])
    return x
