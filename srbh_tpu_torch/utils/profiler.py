"""Step timing and profiler traces.

Counterpart of ``srbh_tpu/utils/profiler.py``:

* :class:`StepTimer`: wall-clock step timing with an items/s rate,
  EMA-smoothed; on a card it synchronises the card before it reads the
  clock, so a step's time includes its queued device work;
* :func:`trace`: a ``torch.profiler`` trace of the enclosed block (CPU and,
  on a card, CUDA activity), written to ``logdir`` for TensorBoard;
* :func:`annotate`: a named region in that trace (``record_function``).
"""
from __future__ import annotations

import contextlib
import time

import torch

from srbh_tpu_torch import resolve_device


class StepTimer:
    """Items/s of steps on ``device`` (``None`` is the card)."""

    def __init__(self, items_per_step: int, ema: float = 0.9, device=None):
        self.items = items_per_step
        self.ema = ema
        self.device = resolve_device(device)
        self.rate = None
        self._t0 = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """End a step; returns the smoothed items/s."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rate = self.items / (time.perf_counter() - self._t0)
        self.rate = rate if self.rate is None else (
            self.ema * self.rate + (1 - self.ema) * rate)
        self.steps += 1
        return self.rate

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; the trace goes to ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named region of the trace (a context manager)."""
    return torch.profiler.record_function(name)
