"""Step timing, profiler traces and the program's own spans.

Counterpart of ``srbh_tpu/utils/profiler.py``:

* :class:`StepTimer`: wall-clock step timing with an items/s rate,
  EMA-smoothed; on a card it synchronises the card before it reads the
  clock, so a step's time includes its queued device work;
* :func:`trace`: a ``torch.profiler`` trace of the enclosed block (CPU and,
  on a card, CUDA activity), written to ``logdir`` for TensorBoard;
* :func:`annotate`: a named region in that trace (``record_function``).

The port's own spans (not in the JAX package): the city path, the serving
step and the GAN step each open a :func:`span` at their layers
(``predict.city``, ``loader.start``, ``predict.step``,
``predict.sr_features``, ``predict.height_model``, ``predict.capture``,
``predict.replay``, ``predict.copy_out``, ``predict.finalize``,
``predict.write``, ``tiff.encode``, ``gan.step``, ``gan.g_pass``,
``gan.g_adam``, ``gan.d_pass``, ``gan.d_adam``, ``gan.ema``), and so do
the height train step (``train.step``, ``train.sr_features``,
``train.model_pass``, ``train.adam``), SwinIR (``swinir.apply``,
``swinir.body``, ``swinir.rstb``, ``swinir.upsample``) and DAT
(``dat.body``, ``dat.group``, ``dat.spatial_attn``, ``dat.spatial_core``,
``dat.channel_attn``, ``dat.sgfn``, ``dat.upsample``). They record only while a
``torch.profiler`` session records or a :func:`recording` block is open;
otherwise :func:`span` returns one shared object that does nothing, after a
single check: no clock reading, no allocation, no CUDA event.

* ``with profiler.trace(logdir): ...`` puts each span in the trace as a
  range ``srbh.<name>`` on the profiler's own clock, beside the kernels
  (TensorBoard's trace view), and records the spans too;
* ``with profiler.recording(): ...`` then ``profiler.spans()`` gives them as
  a list with no profiler; :func:`clear` empties the store;
* :func:`graph_launch` is an operator's range around a CUDA graph's
  launch, which ties the graph's kernels to the ranges around it.

Each span of :func:`spans` is a dict: ``name``; ``parent``, the index of
its parent in the list (``None`` for a root); ``t0_ns`` / ``t1_ns``
(``time.perf_counter_ns``); ``self_ns``, its length less its children's;
``device_ms``, the stream time between a CUDA event pair recorded at its
ends where it was opened with ``device=True`` while the process used a
card (else ``None``). Under a profiler the host side of every operation is
slower, so a span's host time, and the stream time of work the host paces,
read higher than with :func:`recording` alone. Parents are per thread. The
store keeps the newest :data:`STORE_SPANS` spans.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from srbh_tpu_torch import resolve_device

# the profiler's range of a span: the prefix and the span's name
RANGE_PREFIX = "srbh."
# the spans the store keeps, newest last
STORE_SPANS = 65536


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
    """Profile the enclosed block; the trace goes to ``logdir``. The
    program's spans inside it are recorded, and are ranges ``srbh.<name>``
    of the trace."""
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


class _Off:
    """The span while nothing records: enters and exits as nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_store = collections.deque(maxlen=STORE_SPANS)
_local = threading.local()  # .stack: the thread's open spans
_lock = threading.Lock()
_recording = 0  # open recording() blocks


class _Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "parent", "t0", "t1", "child_ns", "device", "events",
                 "device_ms", "_range")

    def __init__(self, name, device):
        self.name, self.device = name, device
        self.parent = self.t1 = self.events = self.device_ms = None
        self._range = None
        self.child_ns = 0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1]
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        _store.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.t1 - self.t0
        return False


def span(name: str, device: bool = False):
    """A context manager around one layer's work; ``device=True`` also
    times the span's stream work on a card. While nothing records (no
    profiler, no :func:`recording`) it returns a shared object that does
    nothing."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def graph_launch(name: str):
    """An operator's range in the profiler's trace around a call that
    launches a CUDA graph. The profiler ties a kernel to the operator whose
    range was open when it was launched, and so to every range around it;
    a user range (:func:`annotate`, a span's ``srbh.`` range) ties none,
    and a graph's launch has no operator of its own, so without this range
    its kernels would belong to no range. Outside a profiler it returns
    the shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def recording():
    """Record spans in the enclosed block, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    with contextlib.ExitStack() as undo:
        undo.callback(_stop_recording)
        yield


def _stop_recording():
    global _recording
    with _lock:
        _recording -= 1


def spans() -> list:
    """The recorded spans, oldest first, each a dict (module docstring). A
    span whose parent is still open or has left the store is left out with
    it, so a span with no parent is a root. Device times are read behind one
    synchronise of the card."""
    done = [s for s in list(_store) if s.t1 is not None]
    pending = [s for s in done if s.events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    out, index = [], {}
    for s in done:
        if s.parent is None:
            parent = None
        elif id(s.parent) in index:
            parent = index[id(s.parent)]
        else:
            continue
        index[id(s)] = len(out)
        out.append({"name": s.name, "parent": parent,
                    "t0_ns": s.t0, "t1_ns": s.t1,
                    "self_ns": s.t1 - s.t0 - s.child_ns,
                    "device_ms": s.device_ms})
    return out


def clear() -> None:
    """Empty the store of spans."""
    _store.clear()
