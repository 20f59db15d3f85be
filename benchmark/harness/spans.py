"""The benchmark's own spans, installed only in a traced run: host intervals
around the calls into each layer, the same intervals as profiler
annotations (``bench.<name>``, so the trace can say what the host did while
the device idled), and CUDA events around a module's forward.

The program itself records no spans yet; these wrap its objects from the
outside.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "bench."


class Spans:
    """Host spans by name: ``seconds[name]`` lists each interval's length;
    each span is also a profiler annotation ``bench.<name>``."""

    def __init__(self):
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` with every call inside a span ``name``."""

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return wrapped

    def wrap_iter(self, name: str, iterable):
        """``iterable`` with the wait for each item inside a span ``name``."""
        it = iter(iterable)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item


class ForwardTimer:
    """CUDA events around every forward of ``module`` (hooks), with the
    forward inside a profiler annotation ``bench.<name>``. :meth:`ms` gives
    each forward's device milliseconds once the device has finished."""

    def __init__(self, module: torch.nn.Module, name: str):
        self.name = name
        self.pairs = []
        self._open = []
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        rf = torch.profiler.record_function(PREFIX + self.name)
        rf.__enter__()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self._open.append((rf, start))

    def _post(self, module, args, out):
        rf, start = self._open.pop()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rf.__exit__(None, None, None)
        self.pairs.append((start, end))

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]

    def remove(self):
        for h in self._hooks:
            h.remove()
