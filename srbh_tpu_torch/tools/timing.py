"""The port's measurement helpers: device times, step times, idle share,
FLOP counts and the records the measurement tools print.

A call that takes less device time than its Python wrapper takes to enqueue
(the window-attention kernel at SwinIR's shapes: both are tens of
microseconds) leaves the card idle between back-to-back calls, and CUDA
events around them then time the host. :func:`device_ms` captures ``calls``
calls in one CUDA graph and times its replays, so the card runs them back to
back. :func:`release` frees what these timings leave allocated, so that a
later measurement of peak memory starts where it would without them.

The tools (``srbh_tpu_torch.bench`` and ``srbh_tpu_torch.tools.*``) time a
step or a request with :func:`step_stats` (a host clock around work that
ends in ``torch.cuda.synchronize()``), take the idle share and the device
time by kernel of one call with :func:`profile_window`, count a model's
FLOPs with :func:`flop_count`, and say where they ran with
:func:`device_record`. Off a card nothing is timed: times are ``None``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import time

import numpy as np
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


# the compute types the tools take by name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# one H100 SXM at its 700 W limit (NVIDIA data sheet): the HBM rate, and the
# dense peaks of float32 off the tensor cores, TF32 and bfloat16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def tf32_state() -> dict:
    """Whether cuDNN's convolutions and cuBLAS's matmuls may run float32 in
    TF32."""
    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


def peak_flop_per_s(dtype: torch.dtype) -> float:
    """The card's dense peak for a convolution-bound model in ``dtype``:
    float32 counts at the TF32 rate when cuDNN may use TF32."""
    if dtype == torch.bfloat16:
        return PEAK_FLOP_PER_S["bfloat16"]
    return PEAK_FLOP_PER_S["tf32" if torch.backends.cudnn.allow_tf32
                           else "float32"]


def nvidia_smi() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    """What a tool's record says of where it ran: the device's name, the
    number of cards and, on a card, ``nvidia-smi``'s name and power limit
    (``None`` on the CPU), and the TF32 settings."""
    if device.type != "cuda":
        return {"device": "cpu", "device_count": 0, "power_limit": None,
                "tf32": tf32_state()}
    return {"device": torch.cuda.get_device_name(device),
            "device_count": torch.cuda.device_count(),
            "power_limit": nvidia_smi(), "tf32": tf32_state()}


WARMUP = 2  # untimed calls before step_stats times (builds, cuDNN's plans)


def step_stats(fn, device: torch.device, repeats: int = 5,
               steps: int = 1) -> dict:
    """Host-clock time of ``fn(i)`` (a step or a request; ``i`` counts the
    calls, so the caller can change inputs from call to call) after
    ``WARMUP`` calls: each of ``repeats`` repeats runs ``steps`` calls back
    to back and ends in ``torch.cuda.synchronize()``. Returns the number of
    repeats and the median and quartiles of their time per call, in ms, and
    ``event_ms``, the median of the same repeats on the card's clock (CUDA
    events recorded where each repeat starts and ends): a second timer to
    hold the host clock against. The card's peak-memory counter is reset
    after the warm-up, so :func:`peak_gib` then reads the timed calls' peak
    (not, say, cuDNN's autotuning in the first calls). Off a card ``fn``
    runs once and every time is ``None``."""
    if device.type != "cuda":
        fn(0)
        return {"repeats": 0, "steps": 0, "median_ms": None, "q1_ms": None,
                "q3_ms": None, "event_ms": None}
    for i in range(WARMUP):
        fn(i)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    times, events, i = [], [], WARMUP
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            fn(i)
            i += 1
        end.record()
        torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0) / steps)
        events.append(start.elapsed_time(end) / steps)
    q1, med, q3 = np.percentile(times, (25, 50, 75)).tolist()
    return {"repeats": repeats, "steps": steps, "median_ms": med, "q1_ms": q1,
            "q3_ms": q3, "event_ms": float(np.median(events))}


def per_second(items: float, stats: dict):
    """``items`` per second at the median of :func:`step_stats`, or ``None``
    where it timed nothing."""
    ms = stats["median_ms"]
    return None if ms is None else 1e3 * items / ms


def profile_window(fn, host_ops: bool = True, top=8) -> dict:
    """Device time by kernel for one call of ``fn`` under ``torch.profiler``,
    and the device's idle share of the call's wall time, ``1 - device busy /
    wall`` (the wall time is the profiled call's, ending in a synchronize).
    ``host_ops=False`` traces the device only (a long call's host ops take
    the profiler minutes to sort). ``kernels`` holds the ``top`` kernels
    (all with ``None``) as (ms, name); ``idle_share`` is ``None`` when the
    profiler saw no device time. In some windows on an H100 the card's
    trace lost the kernels of the window's first milliseconds (their
    launches recorded), which reads as idle time: up to a few ms of a call
    (``tools/_trace.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host_ops
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(ms for ms, _ in rows)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms) if busy else None,
            "kernels": rows[:top]}


def flop_count(module, *inputs, **kwargs) -> int:
    """Floating-point operations (2 per multiply-add) of the ``Conv2d``,
    ``ConvTranspose2d`` and ``Linear`` layers that one forward of ``module``
    on ``inputs`` calls, counted with forward hooks from the shapes alone:
    build ``module`` and its inputs on the meta device and nothing is
    computed. Element-wise work (activations, norms, softmax) is not
    counted."""
    from torch import nn

    macs = 0

    def count(m, args, out):
        nonlocal macs
        if isinstance(m, nn.ConvTranspose2d):
            macs += args[0].numel() * m.out_channels // m.groups * math.prod(m.kernel_size)
        elif isinstance(m, nn.Conv2d):
            macs += out.numel() * m.in_channels // m.groups * math.prod(m.kernel_size)
        else:
            macs += out.numel() * m.in_features

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    with torch.no_grad():
        module(*inputs, **kwargs)
    for h in hooks:
        h.remove()
    return 2 * macs


def emit(records, out: str) -> None:
    """Print each record as one JSON line and write the same lines to
    ``out`` (its directory made if missing), replacing the file."""
    lines = [json.dumps(r) for r in records]
    for line in lines:
        print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("".join(line + "\n" for line in lines))


def tool_device() -> torch.device:
    """The card a tool's ``main`` runs on, with TF32 off so that float32
    means float32 (as in ``chip_smoke.py``); raises without a card, before
    the tool prints anything."""
    from srbh_tpu_torch import resolve_device

    dev = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def peak_gib(device: torch.device):
    """``max_memory_allocated`` in GiB since the last reset, ``None`` off a
    card."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
