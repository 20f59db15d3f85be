"""Valid-pixel block aggregation of height maps (torch).

Counterpart of ``srbh_tpu/ops/aggregate.py`` (aggregate_utils.py:11-41): the
2.5 m height map is reduced to the 10 m grid by block sums of the data over
block sums of a validity mask.

* ``inclusive=True, eps=1e-10`` is ``aggregate_torch`` (validity
  ``data >= threshold``), the training loader's form;
* ``inclusive=False, eps=1e-6`` is the numpy ``aggregate`` (validity
  ``data > threshold``).

Block sums run over the trailing H, W in float32, as the JAX package's
``reduce_window``; the host dataset keeps its own float64 copy
(``data/dataset.py``). :func:`aggregate_mean` is the training form with its
arguments bound.
"""
from __future__ import annotations

import functools

import torch


def block_sum(x: torch.Tensor, step: int) -> torch.Tensor:
    """Non-overlapping ``step`` x ``step`` sums over the trailing two dims."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // step, step, w // step, step).sum((-3, -1))


def aggregate(data: torch.Tensor, scale: float, valid_threshold: float = 0.0,
              inclusive: bool = True, eps: float = 1e-10) -> torch.Tensor:
    """Block means of ``data`` (..., H, W) by ``1/scale`` over valid pixels:
    (..., H*scale, W*scale), float32."""
    step = int(round(1.0 / scale))
    data = data.float()
    valid = (data >= valid_threshold) if inclusive else (data > valid_threshold)
    return block_sum(data, step) / (block_sum(valid.float(), step) + eps)


# the training path's form, aggregate_torch (aggregate_utils.py:29-41)
aggregate_mean = functools.partial(aggregate, valid_threshold=0.0,
                                   inclusive=True, eps=1e-10)
