"""Hierarchical height-class lookup tables and class weights (numpy).

A copy of ``srbh_tpu/ops/hierarchy.py``, which the port may not import.

The reference bins per-pixel height (uint8 metres) into 7 hierarchy classes
``hir = (0, 3, 12, 21, 30, 60, 90, 256)`` via a 256-entry LUT, and derives
per-class loss weights from the training-set height histogram:

* ``hierweight``        (BH_loader.py:30-41): inverse-sqrt-frequency,
  normalised so the weights sum to ``num_classes``.
* ``hierweight_simple`` (BH_loader.py:44-55): inverse-frequency variant.
* ``hierweight_equal``  (BH_loader.py:58-61): all-ones.
* ``buildhir`` LUT      (BH_loader.py:327-330): height value -> class id.

They run once, on the host, when a dataset is built.
"""
from __future__ import annotations

import numpy as np

DEFAULT_HIR = (0, 3, 12, 21, 30, 60, 90, 256)


def build_hierarchy_lut(hir=DEFAULT_HIR) -> np.ndarray:
    """256-entry uint8 LUT mapping a height value to its hierarchy class."""
    num = len(hir) - 1
    lut = np.zeros((256,), dtype=np.uint8)
    for i in range(num):
        lut[hir[i]: hir[i + 1]] = i
    return lut


def _bin_frequencies(stats: np.ndarray, hir) -> np.ndarray:
    """Fraction of pixels per hierarchy bin, from a 256-bin height histogram."""
    stats = np.asarray(stats, dtype=np.float64)
    stats = stats / stats.sum()
    num = len(hir) - 1
    freq = np.zeros((num,), dtype=np.float64)
    for i in range(num):
        freq[i] = stats[hir[i]: hir[i + 1]].sum()
    return freq


def hierweight(stats: np.ndarray, hir=DEFAULT_HIR) -> np.ndarray:
    """Inverse-sqrt-frequency class weights, scaled to sum to ``len(hir)-1``."""
    freq = _bin_frequencies(stats, hir)
    w = 1.0 / np.sqrt(freq)
    w = w / w.sum()
    num = len(hir) - 1
    return num / np.sum(w) * w  # sums to num (w already normalised)


def hierweight_simple(stats: np.ndarray, hir=DEFAULT_HIR) -> np.ndarray:
    """Plain inverse-frequency variant (BH_loader.py:44-55)."""
    freq = _bin_frequencies(stats, hir)
    w = 1.0 / freq
    w = w / w.sum()
    num = len(hir) - 1
    return num / np.sum(w) * w


def hierweight_equal(stats: np.ndarray, hir=DEFAULT_HIR) -> np.ndarray:
    """All-ones weights (BH_loader.py:58-61)."""
    return np.ones((len(hir) - 1,), dtype=np.float64)


WEIGHT_METHODS = {
    "sqrt": hierweight,
    "simple": hierweight_simple,
    "equal": hierweight_equal,
}
