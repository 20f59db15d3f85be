"""Device time of a short CUDA call, free of the host's launch overhead.

A call that takes less device time than its Python wrapper takes to enqueue
(the window-attention kernel at SwinIR's shapes: both are tens of
microseconds) leaves the card idle between back-to-back calls, and CUDA
events around them then time the host. :func:`device_ms` captures ``calls``
calls in one CUDA graph and times its replays, so the card runs them back to
back. :func:`release` frees what these timings leave allocated, so that a
later measurement of peak memory starts where it would without them.
"""
from __future__ import annotations

import time

import torch


_side: dict[int, torch.cuda.Stream] = {}


def _side_stream() -> torch.cuda.Stream:
    """One warm-up stream per device, reused: libraries such as cuBLAS keep a
    workspace for every stream they run on, until :func:`release`."""
    dev = torch.cuda.current_device()
    if dev not in _side:
        _side[dev] = torch.cuda.Stream()
    return _side[dev]


def device_ms(fn, calls: int = 20, replays: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time per call of ``fn``, in ms,
    from CUDA events around ``replays`` replays of a graph of ``calls``
    calls. ``fn`` must only enqueue work on the current stream."""
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the graph (builds, caches)
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (calls * replays))
    graph.reset()  # give the graph's memory pool back
    return sorted(times)[repeats // 2]


def release() -> None:
    """Frees what :func:`device_ms` leaves allocated: cuBLAS keeps a
    workspace for every stream it has run on (the warm-up stream and the
    graphs' capture stream), and the allocator keeps freed blocks cached."""
    torch.cuda.synchronize()
    _side.clear()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` in ms: the wall time of enqueueing
    ``calls`` calls, without waiting for the card in between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls
