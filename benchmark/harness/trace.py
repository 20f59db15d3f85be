"""A profiled stretch of a traced run, reduced to what the result reports:
the device's busy seconds (the union of every device operation's
interval), the stretch's length, the device operations that took most
time, the idle time by what the host was doing (each instant of a gap goes
to the innermost ``bench.`` span open then, ``other`` where none is), and
each span's device time (the kernels launched inside it).

On an H100 the trace has been seen to lose the kernels of a window's first
milliseconds, which then read as idle: a stretch starts after a few units
of the window, and lasts many.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from benchmark.harness.spans import PREFIX

STRETCH = PREFIX + "stretch"


class Stretch:
    """``with Stretch() as s:`` profiles the block (host and device
    activity); :meth:`reduce` afterwards."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._rf = torch.profiler.record_function(STRETCH)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self._rf.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        return False

    def reduce(self, top: int = 10) -> dict:
        return reduce_events(self.prof.events(), self.wall_s, top)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    return (e.device_type != DeviceType.CPU and not e.is_user_annotation
            and not e.name.startswith(PREFIX))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, wall_s: float, top: int = 10) -> dict:
    """Reduce profiler events (``prof.events()``; times in microseconds)
    of one stretch. Returns ``busy_s``, ``window_s``, ``device_ops`` and
    ``idle_gaps`` (``[[name, seconds], ...]``, at most ``top`` each) and
    ``span_device_s`` (span name -> list of the device seconds of the
    kernels launched inside each of its intervals)."""
    from torch.autograd import DeviceType
    dev = [e for e in events if _is_device(e)]
    spans = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith(PREFIX)]
    stretch = [e for e in spans if e.name == STRETCH]
    lo = stretch[0].time_range.start if stretch else min(
        (e.time_range.start for e in dev), default=0)
    hi = stretch[0].time_range.end if stretch else max(
        (e.time_range.end for e in dev), default=0)
    busy = _union((max(e.time_range.start, lo), min(e.time_range.end, hi))
                  for e in dev if e.time_range.end > lo
                  and e.time_range.start < hi)
    busy_us = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for e in dev:
        by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]

    gaps = []
    cursor = lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    inner = sorted((e for e in spans if e.name != STRETCH),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in inner]
    idle = defaultdict(float)
    for gs, ge in gaps:
        # the spans open at some instant of the gap
        open_ = [e for e in inner[:bisect.bisect_right(starts, ge)]
                 if e.time_range.end > gs]
        cuts = sorted({gs, ge} | {t for e in open_ for t in
                                  (e.time_range.start, e.time_range.end)
                                  if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            cover = [e for e in open_ if e.time_range.start <= a
                     and e.time_range.end >= b]
            label = (max(cover, key=lambda e: (e.time_range.start,
                                               -e.time_range.end))
                     .name[len(PREFIX):] if cover else "other")
            idle[label] += (b - a) / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]

    span_dev = defaultdict(list)
    for e in inner:
        span_dev[e.name[len(PREFIX):]].append(e.device_time_total / 1e6)
    window_s = (hi - lo) / 1e6 if hi > lo else wall_s
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps_out],
            "span_device_s": dict(span_dev)}
