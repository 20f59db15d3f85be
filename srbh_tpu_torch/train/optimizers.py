"""Poly-warm-up AdamW (utils/optimizer.py:3-34).

Counterpart of ``srbh_tpu/train/optimizers.py``: a linear warm-up from
``warmup_ratio`` to 1 over ``warmup_iter`` steps, then the polynomial decay
``(1 - t / max_iter)^power``, as ``torch.optim.AdamW`` with a ``LambdaLR``.
Call ``scheduler.step()`` after each ``optimizer.step()``: update ``k``
(counted from 0) then uses ``schedule(k)``, as optax does. AdamW's
decoupled decay is scaled by the scheduled rate, as optax's ``adamw``.
The schedule is computed in float32 with the JAX package's operations, so
each update's rate is the JAX package's to the float32 rounding.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch


def poly_warmup_schedule(base_lr: float, warmup_iter: int, max_iter: int,
                         warmup_ratio: float = 1e-6,
                         power: float = 1.0) -> Callable[[int], float]:
    """The learning rate of update ``step``."""
    f = np.float32

    def schedule(step: int) -> float:
        s = f(step)
        if s < warmup_iter:
            rate = f(1) - (f(1) - s / f(warmup_iter)) * f(1.0 - warmup_ratio)
        else:
            rate = np.power(np.maximum(f(1) - s / f(max_iter), f(0)), f(power))
        return float(f(base_lr) * rate)

    return schedule


def poly_warmup_adamw(params: Iterable, base_lr: float, weight_decay: float,
                      betas=(0.9, 0.999), warmup_iter: int = 1500,
                      max_iter: int = 80000, warmup_ratio: float = 1e-6,
                      power: float = 1.0
                      ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) over ``params``, eps 1e-8."""
    schedule = poly_warmup_schedule(base_lr, warmup_iter, max_iter,
                                    warmup_ratio, power)
    opt = torch.optim.AdamW(params, lr=base_lr, betas=tuple(betas), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: schedule(k) / base_lr)
