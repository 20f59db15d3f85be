"""Streaming metrics. ``AverageMeter`` only, the port's copy of
``srbh_tpu/metrics/streaming.py:235``; the height and segmentation metrics
wait for the test-set evaluation (``main_test``)."""
from __future__ import annotations


class AverageMeter:
    """Running value/sum/count/average (metrics.py:143-160)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count
