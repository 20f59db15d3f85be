"""Consistency-training ramps (utils/ramps.py:19-41): a copy of
``srbh_tpu/utils/ramps.py``, on Python floats."""
from __future__ import annotations

import math


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 (1 - t)^2), t = current / length clipped to [0, 1]."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return math.exp(-5.0 * phase * phase)


def linear_rampup(current: float, rampup_length: float) -> float:
    if current < 0 or rampup_length < 0:
        raise ValueError(f"negative ramp: {current}, {rampup_length}")
    if current >= rampup_length:
        return 1.0
    return current / rampup_length


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    if not 0 <= current <= rampdown_length:
        raise ValueError(f"{current} outside [0, {rampdown_length}]")
    return 0.5 * (math.cos(math.pi * current / rampdown_length) + 1)
