#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``srbh_tpu_torch``) on one card.

    python3 chip_smoke.py

Runs from the root of the repository on a machine with one NVIDIA H100 and
the CUDA toolkit (``nvcc``). It builds the Hopper window-attention kernel
from ``srbh_tpu_torch/csrc/``, then drives the port's two serving paths and
its training path:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. the kernel build, with ``-Xptxas -v`` (registers, shared memory, spills;
   a spill fails the run);
3. the kernel against its plain PyTorch version and a float64 reference at
   SwinIR's shapes (d 10, 16, 30 and 64; N 49 and 64; nW up to 100;
   contiguous inputs, strided views of a qkv projection, and bias and mask
   views off an 8-byte boundary; float32 and bfloat16), with device times
   (CUDA events around CUDA-graph replays of back-to-back calls) of the
   kernel, the plain version and ``F.scaled_dot_product_attention`` as a
   yardstick (timed only; the port never calls it), beside the kernel's
   bound, the achieved TB/s, the share of the bound, the wrapper's host time
   per call, and the kernel's time from CUDA events around back-to-back
   Python calls (the method of the first slice, which times the host once
   the kernel is the shorter); then it frees what the timings keep
   allocated (``tools.timing.release``);
4. SwinIR classical-SR x4 at full width (embed 180, 6x6 RSTBs) through
   ``tools.swinir_harness``: the kernel path against the plain path on the
   same weights, the launch count of one forward pass (36), the time per
   image, the kernel's device time per call from the profiler, and the card
   against the CPU on a small input;
5. the flagship height step: the tiny configuration on the card against the
   CPU, then the full-width RRDBNet-23 + EfficientNet-B4 step through
   ``make_city_step`` at batch 32 in float32 and bfloat16: output shapes,
   dtypes, finite values, build-softmax sums, tiles/s and peak memory (and
   the memory allocated when the phase starts);
6. the height model's training path: one ``make_train_step`` of the tiny
   configuration on the card against the CPU (loss, rmse and log-vars
   within 1e-4 x (1 + |b|), parameters by their sign-flip fraction); then
   ``train.trainer.main``, the entry point of ``python -m
   srbh_tpu_torch.train``, at full width (RRDBNet-23 + EfficientNet-B4,
   batch 16 tiles of 64x64, float32) on 64 synthetic GeoTIFF tiles for one
   epoch of 4 steps and a resumed second epoch: finite losses, moved
   log-vars, every height-model parameter and some BatchNorm statistics
   changed, the frozen RRDBNet bit-unchanged, the checkpoint reloading to an
   identical state; the launches of the hand kernel on that path (none);
   train tiles/s of ``make_train_step`` alone on batches already on the
   card in float32 and bfloat16, with peak memory and a ``profile`` line
   each; and the trainer's time per step with its loader in steady state
   (512 tiles, the prefetch fill left out), beside the loader alone and
   the time to the first batch;
7. the city predictor: ``predict_city`` of the tiny configuration on the
   card against the CPU on a synthetic 200x150 city; then a synthetic city
   of 2048 x 2048 source pixels (S2, S1, a WSF disc of half the area, a
   64/56 fishnet of 1369 cells, a checkpoint ``checkpoint20`` of the
   full-width model) through the CLI twin's ``main`` (``python -m
   srbh_tpu_torch.predict``: bfloat16, batch 16, host stitching), with the
   hand kernel's launches counted over it (none): 8192 x 8192 tifs at
   2.5 m, the colormap, classes <= 6, heights where the valid cells lie,
   and a resumed second ``main``; then ``predict_city`` with the device
   stitcher at batch 32 (no fallback; its mosaics against the CLI's), one
   pass's tiles fed to both stitchers (byte-equal mosaics), and the numbers:
   windows/s end to end by stitcher, of the step alone and of the loader
   alone, ms per batch of each stitcher's ``add_batch``, seconds of
   finalize and GeoTIFF writes, device and host peak memory, and a
   ``profile`` line of the device-stitch run.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` are False), so float32 means
float32 in every parity check and every float32 time. Weights are random,
drawn from a seed: no pretrained checkpoint is in the repository.

Any failed check raises and the script exits non-zero. Without a card, or
outside the repository, it exits non-zero and prints no result. On success
the line before the last two is a JSON object ``{"kernels": [...]}``, the
line before the last is ``nvidia-smi``'s name and power limit, and the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

ATTN_TOL_F32 = 2e-5  # as tests/test_pallas_attention.py: f32 sums in another order
ATTN_TOL_BF16 = 3.2e-2  # two bf16 ulps at |o| < 4: the kernel keeps p in f32
SWIN_TOL = 1e-4  # whole model, relative to max(1, max |out|): f32, 36 blocks
FLAGSHIP_TOL = 1e-4  # whole model: |a - b| <= tol * (1 + |b|), card vs CPU, f32
TRAIN_TOL = 1e-4  # train step: loss, rmse, log-vars |a - b| <= tol * (1 + |b|)
# params after one Adam step (every update is +-lr): share of elements that
# differ by more than 1e-4 card vs CPU, as tests/test_train_step_oracle.py
TRAIN_FLIP_SHARE = 0.005
TRAIN_BATCH, TRAIN_TILES, TRAIN_STEPS = 16, 64, 4
LOOP_TILES = 512  # the steady-state loader timing: 32 batches of 16
TIMED_STEPS = 6
SWIN_BATCH = 8  # 64x64 tiles: B_ = 512 windows a call, 94 MB of q/k/v/o > L2
CITY_BATCH = 32
CITY_STEPS = 4
# phase 7: source pixels of the full-width city (20.48 km at 10 m: the order
# of the reference's *_large urban centers), the CLI's batch and the device
# stitcher's, and the quantised-output limit (<= 1 LSB on <= 0.1 % of
# pixels, classes differing on <= 0.1 %)
CITY_SIDE, CLI_BATCH, DEVICE_STITCH_BATCH = 2048, 16, 32
QUANT_SHARE = 1e-3
GRID_KW = dict(s1dir="s1x", s2dir="s2x", gridvalid="isv", nchans=6)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_bytes(h, b_, n, d, dtype, nw):
    """Bytes one call must move: q, k, v read once and o written once, the
    f32 bias (and mask) read once."""
    elt = torch.finfo(dtype).bits // 8
    return 4 * h * b_ * n * d * elt + h * n * n * 4 + (nw or 0) * n * n * 4


def attn_bound_ms(h, b_, n, d, dtype, nw):
    """Least time for one call: its bytes at the HBM rate against its
    4*h*B_*N^2*d operations at the peak rate of the input type."""
    t_bytes = attn_bytes(h, b_, n, d, dtype, nw) / HBM_BYTES_PER_S
    t_ops = 4 * h * b_ * n * n * d / FLOP_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"



def attention_f64(q, k, v, bias, mask):
    """Window attention in float64: a yardstick independent of both the
    kernel and the float32 plain version."""
    h, b_, n, d = q.shape
    s = torch.einsum("hbnd,hbmd->hbnm", q.double() * d ** -0.5, k.double())
    s = s + bias[:, None].double()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(h, b_ // nw, nw, n, n) + mask.double()[None, None]
             ).reshape(h, b_, n, n)
    return torch.einsum("hbnm,hbmd->hbnd", torch.softmax(s, -1), v.double())


def qkv_views(q, k, v):
    """q, k and v as SwinIR hands them to the kernel: strided (heads, B_, N,
    d) views of one (B_, N, 3, heads, d) projection, holding the same
    values."""
    qkv = torch.stack([q, k, v]).permute(2, 3, 0, 1, 4).contiguous()
    return qkv.permute(2, 3, 0, 1, 4).unbind(0)


def off_pair(t):
    """A copy of ``t`` that starts 4 bytes past an 8-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def profile(label, fn, warm=True, host_ops=True):
    """Device time by kernel for one call of ``fn`` (torch.profiler), and the
    device's idle share of the call's wall time, after one call unprofiled
    if ``warm``. ``host_ops=False`` traces the device only (a long call's
    host ops take the profiler minutes to sort). Returns (ms, kernel name)
    rows, empty if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host_ops
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(ms for ms, _ in rows)
    if busy == 0:
        log(f"[profile] {label}: device time not measured (no device events)")
        return []
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiler on), device "
        f"busy {busy:.3f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for ms, key in rows[:8]:
        log(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
    return rows


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")
    return name, smi


def phase_build(wa):
    t0 = time.perf_counter()
    path, out = wa.build_kernel()
    log(f"[build] {path} in {time.perf_counter() - t0:.2f} s")
    spills = []
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"kernel spills registers: {spills}")


def phase_kernel(wa, shift_attn_mask, timing):
    """Kernel vs plain at every listed shape; times at the classical shape
    (device time from CUDA graphs of back-to-back calls: the kernel is
    shorter than its wrapper's host time)."""
    rng = np.random.default_rng(0)
    b = SWIN_BATCH
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, heads, B_, N, d, mask image side (None: unmasked), ws,
               # dtype, layout (contiguous; qkv: q/k/v as views of a qkv
               # projection; offset: bias and mask off an 8-byte boundary), timed
        ("classical", 6, 64 * b, 64, 30, None, 8, f32, "contiguous", True),
        ("classical_masked", 6, 64 * b, 64, 30, 64, 8, f32, "contiguous", True),
        ("classical_qkv", 6, 64 * b, 64, 30, None, 8, f32, "qkv", True),
        ("classical_masked_qkv", 6, 64 * b, 64, 30, 64, 8, f32, "qkv", True),
        ("padded72_nW81", 6, 81 * 2, 64, 30, 72, 8, f32, "contiguous", False),
        ("jpeg_car_N49_nW100", 6, 100 * 2, 49, 30, 70, 7, f32, "contiguous", False),
        ("d16", 4, 16 * 4, 64, 16, 32, 8, f32, "contiguous", False),
        ("d16_offset", 4, 16 * 4, 64, 16, 32, 8, f32, "offset", False),
        ("lightweight_d10_nW16", 6, 16 * b, 64, 10, 32, 8, f32, "contiguous", False),
        ("d64", 3, 16 * 4, 64, 64, 32, 8, f32, "contiguous", False),
        ("classical_bf16", 6, 64 * b, 64, 30, None, 8, bf16, "contiguous", True),
        ("classical_masked_bf16", 6, 64 * b, 64, 30, 64, 8, bf16, "contiguous", True),
        ("classical_qkv_bf16", 6, 64 * b, 64, 30, None, 8, bf16, "qkv", True),
        ("classical_masked_qkv_bf16", 6, 64 * b, 64, 30, 64, 8, bf16, "qkv", True),
        ("jpeg_car_N49_nW100_bf16", 6, 100 * 2, 49, 30, 70, 7, bf16, "contiguous", False),
        ("d64_bf16", 3, 16 * 4, 64, 64, 32, 8, bf16, "contiguous", False),
    ]
    rows = {}
    for name, h, b_, n, d, side, ws, dt, layout, timed in cases:
        mk = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32),
                                     device="cuda")
        q, k, v = (mk(h, b_, n, d).to(dt) for _ in range(3))
        if layout == "qkv":
            q, k, v = qkv_views(q, k, v)
        bias = mk(h, n, n)
        mask = None
        if side is not None:
            mask = torch.tensor(shift_attn_mask(side, side, ws, ws // 2),
                                device="cuda")
        if layout == "offset":
            bias, mask = off_pair(bias), off_pair(mask)
        nw = None if mask is None else mask.shape[0]
        with torch.inference_mode():
            got = wa.window_attention(q, k, v, bias, mask)
            want = wa.window_attention_reference(q, k, v, bias, mask)
            torch.cuda.synchronize()
            exact = attention_f64(q, k, v, bias, mask)
        err = (got.float() - want.float()).abs().max().item()
        err64 = (got.double() - exact).abs().max().item()
        err64_plain = (want.double() - exact).abs().max().item()
        tol = ATTN_TOL_F32 if dt == f32 else ATTN_TOL_BF16
        log(f"[kernel] {name}: (h={h}, B_={b_}, N={n}, d={d}, nW={nw}, "
            f"{str(dt)[6:]}, {layout}) "
            f"max_abs_err={err:.3e} tol={tol:.1e}; against float64: kernel "
            f"{err64:.3e}, plain {err64_plain:.3e}")
        if not (err <= tol and err64 <= tol and got.is_contiguous()):
            raise AssertionError(f"kernel disagrees with plain version at {name}")
        row = dict(max_abs_err=err)
        if timed:
            full = bias[:, None].expand(h, b_, n, n)
            if mask is not None:
                full = full + mask.repeat(b_ // nw, 1, 1)[None]
            full = full.to(dt).contiguous()
            kernel = lambda: wa.window_attention(q, k, v, bias, mask)
            with torch.inference_mode():
                row["ms"] = timing.device_ms(kernel)
                row["events_ms"] = cuda_ms(kernel)
                row["host_ms"] = timing.host_ms(kernel)
                row["plain_ms"] = timing.device_ms(
                    lambda: wa.window_attention_reference(q, k, v, bias, mask))
                row["library_ms"] = timing.device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=full))
            row["bound_ms"], row["bound_by"] = attn_bound_ms(h, b_, n, d, dt, nw)
            row["tb_per_s"] = attn_bytes(h, b_, n, d, dt, nw) / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            log(f"[kernel] {name}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); kernel "
                f"{row['tb_per_s']:.3f} TB/s, {100 * row['share_of_bound']:.1f} % "
                f"of the bound; wrapper host time {row['host_ms']:.4f} ms per call; "
                f"kernel {row['events_ms']:.4f} ms from CUDA events around 20 "
                f"back-to-back calls")
        rows[name] = row
    held = torch.cuda.memory_allocated()
    timing.release()
    log(f"[kernel] memory allocated after the timings: {held / 2**20:.1f} MiB; "
        f"after tools.timing.release: {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    return rows


def phase_swinir(wa, harness):
    rng = np.random.default_rng(1)
    model = harness.define_model("classical_sr", 4, device="cuda", seed=0)
    attns = [m for m in model.modules() if hasattr(m, "use_kernel")]
    x = torch.tensor(rng.uniform(0, 1, (SWIN_BATCH, 64, 64, 3)).astype(np.float32),
                     device="cuda")

    def run(use_kernel):
        for m in attns:
            m.use_kernel = use_kernel
        out = harness.apply(model, x)
        torch.cuda.synchronize()
        return out

    wa.window_attention.launches = 0
    out_k = run(True)
    launches = wa.window_attention.launches
    out_p = run(False)
    if out_k.shape != (SWIN_BATCH, 256, 256, 3) or not torch.isfinite(out_k).all():
        raise AssertionError(f"SwinIR output {tuple(out_k.shape)} not finite/shaped")
    diff = (out_k - out_p).abs().max().item()
    scale = max(1.0, out_p.abs().max().item())
    log(f"[swinir] classical_sr x4, embed 180, 6x6 RSTBs, batch {SWIN_BATCH} "
        f"x 64x64: kernel vs plain max_abs_diff={diff:.3e} "
        f"(tol {SWIN_TOL:.0e} x {scale:.3f}); launches per forward={launches}")
    if launches != 36:
        raise AssertionError(f"expected 36 kernel launches, got {launches}")
    if not diff <= SWIN_TOL * scale:
        raise AssertionError("SwinIR kernel path disagrees with plain path")

    times = {}
    for use_kernel in (True, False, False, True):
        for m in attns:
            m.use_kernel = use_kernel
        t = cuda_ms(lambda: harness.apply(model, x), iters=5, warmup=1)
        times.setdefault(use_kernel, []).append(t / SWIN_BATCH)
    log(f"[swinir] ms per 64x64 image: kernel {times[True]}, plain {times[False]}")
    for m in attns:
        m.use_kernel = True
    prof = profile(f"swinir forward, batch {SWIN_BATCH}, kernel path",
                   lambda: harness.apply(model, x))
    attn = [ms for ms, key in prof if "window_attention_kernel" in key]
    profiled_ms = sum(attn) / launches if attn else None
    log("[swinir] window-attention kernel, profiler: "
        + (f"{profiled_ms:.4f} ms per call" if attn else "not measured"))

    # the card against the CPU on one small input (24x24 -> nW = 9)
    small = rng.uniform(0, 1, (1, 24, 24, 3)).astype(np.float32)
    cpu = copy.deepcopy(model).to("cpu")
    for m in attns:
        m.use_kernel = True
    got = harness.apply(model, small).cpu()
    want = harness.apply(cpu, small)
    diff_cpu = (got - want).abs().max().item()
    scale_cpu = max(1.0, want.abs().max().item())
    log(f"[swinir] 24x24 card vs CPU: max_abs_diff={diff_cpu:.3e} "
        f"(tol {SWIN_TOL:.0e} x {scale_cpu:.3f})")
    if not diff_cpu <= SWIN_TOL * scale_cpu:
        raise AssertionError("SwinIR on the card disagrees with the CPU")
    return launches, diff, times, profiled_ms


def phase_flagship(entry, make_city_step):
    log(f"[flagship] memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    rng = np.random.default_rng(2)
    # tiny configuration: the card against the CPU, same weights, float32
    model, sr, _ = entry.flagship(tiny=True, device="cpu", seed=0)
    g_model, g_sr = copy.deepcopy(model).to("cuda"), copy.deepcopy(sr).to("cuda")
    img = rng.uniform(0, 1, (4, 64, 64, 8)).astype(np.float32)
    want = entry.forward(model, sr, torch.from_numpy(img))
    got = entry.forward(g_model, g_sr, torch.from_numpy(img).cuda())
    for name, a, b in zip(("height", "build", "aggre"), got, want):
        err = ((a.cpu() - b).abs() / (1 + b.abs())).max().item()
        log(f"[flagship] tiny {name} card vs CPU: max |a-b|/(1+|b|)={err:.3e} "
            f"(tol {FLAGSHIP_TOL:.0e})")
        if not err <= FLAGSHIP_TOL:
            raise AssertionError(f"tiny flagship {name} disagrees card vs CPU")
    h_c, b_c = make_city_step(model, sr, dtype=torch.float32, device="cpu")(img)
    h_g, b_g = make_city_step(g_model, g_sr, dtype=torch.float32, device="cuda")(img)
    for name, a, b in (("height u16", h_g, h_c), ("build u8", b_g, b_c)):
        d = (a.cpu().int() - b.int()).abs()
        frac = (d > 0).float().mean().item()
        log(f"[flagship] tiny make_city_step {name}: max LSB diff "
            f"{d.max().item()}, share differing {frac:.2e}")
        if d.max().item() > 1 or frac > 1e-3:
            raise AssertionError(f"tiny make_city_step {name} card vs CPU")

    # full width: RRDBNet-23 + EfficientNet-B4, batch 32 tiles of 64x64
    model, sr, _ = entry.flagship(device="cuda", seed=0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        step = make_city_step(model, sr, dtype=dtype, device="cuda")
        batches = [torch.tensor(rng.uniform(0, 1, (CITY_BATCH, 64, 64, 8))
                                .astype(np.float32), device="cuda")
                   for _ in range(CITY_STEPS)]
        ctx = (torch.autocast("cuda", dtype=dtype) if dtype != torch.float32
               else torch.autocast("cuda", enabled=False))
        with ctx:
            raw = entry.forward(model, sr, batches[0])
        if not all(torch.isfinite(t.float()).all() for t in raw):
            raise AssertionError(f"flagship {dtype} outputs not finite")
        h, b = step(batches[0])
        torch.cuda.synchronize()
        if (h.dtype, tuple(h.shape)) != (torch.uint16, (CITY_BATCH, 256, 256)) or \
           (b.dtype, tuple(b.shape)) != (torch.uint8, (CITY_BATCH, 256, 256, 7)):
            raise AssertionError(f"flagship outputs {h.dtype}{tuple(h.shape)} "
                                 f"{b.dtype}{tuple(b.shape)}")
        sums = b.int().sum(-1)
        off = (sums - 255).abs().max().item()
        if off > 4:  # 7 classes each rounded by at most 0.5
            raise AssertionError(f"build softmax sums off 255 by {off}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in batches:
            step(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tps = CITY_BATCH * CITY_STEPS / dt
        peak = torch.cuda.max_memory_allocated() / 2**30
        name = str(dtype)[6:]
        log(f"[flagship] full width {name}: {tps:.2f} tiles/s at batch "
            f"{CITY_BATCH} ({CITY_STEPS} steps, {dt:.3f} s), peak "
            f"{peak:.2f} GiB, build sums within {off} of 255, height max "
            f"{h.int().max().item()} dm")
        results[name] = tps
        profile(f"flagship make_city_step {name}, batch {CITY_BATCH}",
                lambda: step(batches[0]))
    return results


class ScalarLog:
    """A ``writer`` for ``trainer.main``: keeps every ``add_scalar``."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, epoch):
        self.scalars.setdefault(tag, []).append(float(value))

    def close(self):
        pass


def train_batch(rng, n, tile=64):
    """One host batch of the train step (NHWC, targets at x4)."""
    hr = 4 * tile
    return {
        "image": rng.uniform(0, 1, (n, tile, tile, 8)).astype(np.float32),
        "height": rng.integers(0, 100, (n, hr, hr)).astype(np.float32),
        "weight": rng.uniform(0.5, 2.0, (n, hr, hr)).astype(np.float32),
        "build": rng.integers(0, 7, (n, hr, hr)).astype(np.int32),
        "height_aggre": rng.uniform(0, 100, (n, tile, tile)).astype(np.float32),
        "weight_aggre": rng.uniform(0.5, 2.0, (n, tile, tile)).astype(np.float32),
    }


def write_tiles(root, n):
    """``n`` synthetic tiles (tests/test_e2e_train.py's recipe at 64x64): s2
    uint16 (64, 64, 6), s1 float32 (64, 64, 2), bh uint8 (256, 256), the
    train and validation lists, min-max tables and a height histogram."""
    from srbh_tpu_torch.data.tiff import write_tiff

    rng = np.random.default_rng(3)
    names = [f"t_{i}.tif" for i in range(n)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(os.path.join(root, d))
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for name in names:
        write_tiff(os.path.join(root, "s2c", name),
                   rng.integers(0, 5000, (64, 64, 6)).astype(np.uint16), gt)
        write_tiff(os.path.join(root, "s1c", name),
                   rng.uniform(-25, 5, (64, 64, 2)).astype(np.float32), gt)
        write_tiff(os.path.join(root, "bhc", name),
                   rng.integers(0, 100, (256, 256)).astype(np.uint8),
                   (gt[0], 2.5, 0.0, gt[3], 0.0, -2.5))
    for split in ("train", "val"):
        with open(os.path.join(root, f"dl_{split}.csv"), "w") as f:
            f.writelines(f"{name},s1c,s2c,bhc\n" for name in names)
    np.savetxt(os.path.join(root, "s2c_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "s1c_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(os.path.join(root, "bh_stats.txt"), hist)


def train_tiny_card_vs_cpu():
    """One train step of the tiny configuration on the card and on the CPU
    from the same weights and batch, drop-connect off."""
    from srbh_tpu_torch.models.height_model import SRRegressClsFeature
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.rrdbnet import RRDBNet
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step

    gen = torch.Generator().manual_seed(0)
    sr = init_weights(RRDBNet(num_block=2, num_feat=16, num_grow_ch=8), gen)
    model = init_weights(SRRegressClsFeature(
        "efficientnet-test", super_mid=8, isaggre=True, chans_build=7,
        sr_chans=16, drop_connect_rate=0.0), gen)
    batch = train_batch(np.random.default_rng(4), 4)
    out = {}
    for dev in ("cpu", "cuda"):
        m, s = copy.deepcopy(model).to(dev), copy.deepcopy(sr).to(dev)
        state = TrainState(m)
        metrics = make_train_step(m, s, device=dev)(state, batch, 1e-3)
        out[dev] = ({k: v.cpu() for k, v in metrics.items()},
                    {n: p.detach().cpu() for n, p in m.named_parameters()})
    (want, p_cpu), (got, p_card) = out["cpu"], out["cuda"]
    for key in ("loss", "rmse", "log_vars"):
        err = ((got[key] - want[key]).abs() / (1 + want[key].abs())).max().item()
        log(f"[train] tiny make_train_step {key} card vs CPU: max "
            f"|a-b|/(1+|b|)={err:.3e} (tol {TRAIN_TOL:.0e})")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"tiny train step {key} disagrees card vs CPU")
    bad = sum(int(((p_card[n] - p).abs() > 1e-4).sum()) for n, p in p_cpu.items())
    total = sum(p.numel() for p in p_cpu.values())
    log(f"[train] tiny make_train_step params card vs CPU: {bad} of {total} "
        f"elements beyond 1e-4 (share {bad / total:.2e}, limit "
        f"{TRAIN_FLIP_SHARE})")
    if not bad / total < TRAIN_FLIP_SHARE:
        raise AssertionError("tiny train step params disagree card vs CPU")


def check_trained(state, init_model, init_sr, scalars):
    """What one run of ``trainer.main`` must leave behind."""
    loss, rmse = scalars["train/loss"][-1], scalars["train/rmse"][-1]
    val = scalars["val/rmse"][-1]
    lv = state.log_vars.detach().cpu()
    log(f"[train] trainer.main step {state.step}: train loss {loss:.4f}, rmse "
        f"{rmse:.4f}, val rmse {val:.4f}, log_vars {lv.tolist()}")
    if not all(np.isfinite([loss, rmse, val])) or not bool((lv != 0).all()):
        raise AssertionError("trainer: losses not finite or log_vars unmoved")
    now = {k: v.cpu() for k, v in state.model.state_dict().items()}
    was = init_model.state_dict()
    same = [n for n, _ in init_model.named_parameters()
            if torch.equal(now[n], was[n])]
    stats = [k for k in was if k.endswith("running_mean")
             and not torch.equal(now[k], was[k])]
    n_params = len(list(init_model.parameters()))
    log(f"[train] height-model params: {n_params - len(same)} of {n_params} "
        f"tensors changed; BatchNorm running means changed: {len(stats)}")
    if same or not stats:
        raise AssertionError(f"params unchanged {same[:5]} or no BN stat moved")
    sr_now = {k: v.cpu() for k, v in state.sr_model.state_dict().items()}
    moved = [k for k, v in init_sr.state_dict().items()
             if not torch.equal(sr_now[k], v)]
    log(f"[train] frozen RRDBNet: {len(moved)} of {len(sr_now)} tensors "
        "differ from the seeded init (bit for bit)")
    if moved:
        raise AssertionError(f"the frozen RRDBNet changed: {moved[:5]}")


def check_checkpoint(cfg, state):
    from srbh_tpu_torch.train.checkpoint import load_checkpoint, restore_into_state
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.trainer import build_models

    payload = load_checkpoint(os.path.join(cfg.logdir, "checkpoint"))
    model, _ = build_models(cfg)
    fresh = TrainState(model.to("cuda"))
    restore_into_state(fresh, payload)
    live = state.model.state_dict()
    diff = [k for k, v in fresh.model.state_dict().items()
            if not torch.equal(v, live[k])]
    opt_a, opt_b = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    diff += [f"optimizer {i}.{k}" for i, st in opt_b["state"].items()
             for k, v in st.items() if not torch.equal(
                 torch.as_tensor(opt_a["state"][i][k]).cpu(),
                 torch.as_tensor(v).cpu())]
    if not torch.equal(fresh.log_vars, state.log_vars) or fresh.step != state.step:
        diff.append("log_vars/step")
    log(f"[train] checkpoint (epoch {payload['epoch']}, step "
        f"{payload['step']}) reloads: {len(diff)} tensors differ")
    if diff:
        raise AssertionError(f"checkpoint does not reload identically: {diff[:5]}")


def time_steps(cfg, smi):
    """tiles/s of ``make_train_step`` alone on batches already on the card,
    float32 and bfloat16, with peak memory and a profile of one step."""
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step
    from srbh_tpu_torch.train.trainer import build_models

    rng = np.random.default_rng(5)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                train_batch(rng, TRAIN_BATCH).items()} for _ in range(2)]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        model, sr = build_models(cfg)
        state = TrainState(model.to("cuda"))
        step = make_train_step(model, sr, seed=cfg.seed, dtype=dtype,
                               device="cuda")
        for i in range(2):
            step(state, batches[i % 2], 1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            m = step(state, batches[i % 2], 1e-3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        tps = TRAIN_BATCH * TIMED_STEPS / dt
        if not torch.isfinite(m["loss"]):
            raise AssertionError(f"train step {name} loss not finite")
        log(f"[train] make_train_step {name}, batch {TRAIN_BATCH}, batches on "
            f"the card: {tps:.2f} tiles/s ({1e3 * dt / TIMED_STEPS:.2f} ms per "
            f"step over {TIMED_STEPS} steps), peak {peak:.2f} GiB; {smi}")
        results[name] = dict(tiles_per_s=tps, ms_per_step=1e3 * dt / TIMED_STEPS,
                             peak_gib=peak)
        profile(f"train step {name}, batch {TRAIN_BATCH}",
                lambda: step(state, batches[0], 1e-3))
        del state, step, model, sr
        torch.cuda.empty_cache()
    return results


def time_loader(cfg, smi):
    """The trainer's loop in steady state, loader included: ms per step over
    an epoch of ``LOOP_TILES`` tiles (the synthetic tiles listed again and
    again), leaving out the first ``2 x num_workers`` batches (the loader's
    prefetch fills meanwhile), against the loader alone over the same
    batches; and the time to each epoch's first batch, apart."""
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step
    from srbh_tpu_torch.train.trainer import build_models, make_loader

    with open(os.path.join(cfg.datapath, cfg.trainlist)) as f:
        rows = f.read()
    with open(os.path.join(cfg.datapath, "dl_loop.csv"), "w") as f:
        f.write(rows * (LOOP_TILES // TRAIN_TILES))
    loader = make_loader(cfg, "dl_loop.csv", aug=True, isaggre=True,
                         ishir=True, preweight=cfg.preweight, device="cuda")
    model, sr = build_models(cfg)
    state = TrainState(model.to("cuda"))
    step = make_train_step(model, sr, seed=cfg.seed, device="cuda")
    skip = 2 * cfg.num_workers  # torch's DataLoader prefetches 2 a worker
    timed = {}
    for what in ("loader + step", "loader alone"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            if i == 0:
                timed[f"{what}: first batch"] = 1e3 * (time.perf_counter() - t0)
            if i == skip:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            if what != "loader alone":
                step(state, batch, 1e-3)
        torch.cuda.synchronize()
        timed[what] = 1e3 * (time.perf_counter() - t1) / (len(loader) - skip)
    log(f"[train] trainer loop, float32, batch {cfg.batch_size}, "
        f"{cfg.num_workers} loader processes, steady state (batches "
        f"{skip}..{len(loader) - 1} of {len(loader)}): "
        f"{timed['loader + step']:.2f} ms per step with the loader; loader "
        f"alone {timed['loader alone']:.2f} ms per batch; first batch after "
        f"{timed['loader + step: first batch']:.1f} ms (with steps) and "
        f"{timed['loader alone: first batch']:.1f} ms (alone); {smi}")
    del state, step, model, sr
    torch.cuda.empty_cache()
    return timed


def phase_train(wa, smi):
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.trainer import build_models, main as train_main

    torch.cuda.empty_cache()
    log(f"[train] memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    train_tiny_card_vs_cpu()
    with tempfile.TemporaryDirectory() as root:
        write_tiles(root, TRAIN_TILES)
        cfg = TrainConfig(
            datapath=root, trainlist="dl_train.csv", vallist="dl_val.csv",
            logdir=os.path.join(root, "logs"),
            logdirhr=os.path.join(root, "no_sr_checkpoint"), datastats=root,
            preweight=os.path.join(root, "bh_stats.txt"), s1dir="s1c",
            s2dir="s2c", bhdir="bhc", maxepoch=1, batch_size=TRAIN_BATCH,
            num_workers=8)
        init_model, init_sr = build_models(cfg)
        # the path drives no hand kernel: count its launches all the same
        wa.window_attention.launches = 0
        record = ScalarLog()
        t0 = time.perf_counter()
        state = train_main(cfg, writer=record, max_steps_per_epoch=TRAIN_STEPS,
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wa.window_attention.launches
        log(f"[train] trainer.main, RRDBNet-23 + EfficientNet-B4, batch "
            f"{TRAIN_BATCH}, float32, {TRAIN_STEPS} steps + validation + "
            f"checkpoint: {wall:.2f} s wall (models built on the CPU "
            f"included); window_attention launches on the train path: "
            f"{launches}")
        if state.step != TRAIN_STEPS:
            raise AssertionError(f"trainer took {state.step} steps")
        check_trained(state, init_model, init_sr, record.scalars)
        check_checkpoint(cfg, state)
        cfg.maxepoch = 2
        resumed = train_main(cfg, writer=record, max_steps_per_epoch=TRAIN_STEPS,
                             device="cuda")
        if resumed.step != 2 * TRAIN_STEPS or len(record.scalars["lr"]) != 2:
            raise AssertionError(f"resume: step {resumed.step}")
        check_trained(resumed, init_model, init_sr, record.scalars)
        del state, resumed
        torch.cuda.empty_cache()
        loop = time_loader(cfg, smi)
    steps = time_steps(cfg, smi)
    return {"launches": launches, "steps": steps, "loop_ms": loop}


def write_city(root, name, side_w, side_h, seed):
    """A synthetic city with the port's writers (uncompressed, as the JAX
    package's tests write them): S2 6-band uint16, S1 2-band float32, a WSF
    mask built-up in a central disc of half the area, the 64/56 fishnet
    tagged valid where a cell holds >= 20 built-up pixels, min-max tables."""
    from srbh_tpu_torch.data.grid import fishgrid_stats, write_fishgrid
    from srbh_tpu_torch.data.tiff import write_tiff

    rng = np.random.default_rng(seed)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    os.makedirs(os.path.join(root, "stats"), exist_ok=True)
    path = lambda suffix: os.path.join(root, f"{name}_{suffix}.tif")
    write_tiff(path("s2"), rng.integers(0, 5000, (side_h, side_w, 6),
                                        dtype=np.uint16), gt)
    write_tiff(path("s1"), rng.uniform(-25, 5, (side_h, side_w, 2)
                                       ).astype(np.float32), gt)
    yy, xx = np.ogrid[:side_h, :side_w]
    disc = (yy - side_h / 2) ** 2 + (xx - side_w / 2) ** 2 <= \
        side_h * side_w / (2 * np.pi)
    write_tiff(path("wsf"), disc.astype(np.uint8) * 255, gt)
    write_fishgrid(path("s2"), 64, 56)
    fishgrid_stats(path("wsf"), path("s2")[:-4] + "_grid.shp",
                   condition=(0, 20, 4096))
    np.savetxt(os.path.join(root, "stats", "s2x_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "stats", "s1x_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))


def read_mosaic(paths):
    """(classes, heights) of a (build tif, height tif) pair."""
    from srbh_tpu_torch.data.tiff import TiffReader

    return tuple(TiffReader(p).read()[..., 0] for p in paths)


def compare_mosaics(label, got, want):
    """Two (classes, heights) mosaics within the quantised-output limit;
    returns (share of heights differing, share of classes differing)."""
    (cg, hg), (cw, hw) = got, want
    d = np.abs(hg.astype(np.int32) - hw.astype(np.int32))
    share_h, share_c = float((d > 0).mean()), float((cg != cw).mean())
    log(f"[city] {label}: height max LSB diff {d.max()}, share differing "
        f"{share_h:.2e}; classes differing {share_c:.2e} (limit 1 LSB on "
        f"{QUANT_SHARE:.0e})")
    if d.max() > 1 or share_h > QUANT_SHARE or share_c > QUANT_SHARE:
        raise AssertionError(f"{label}: mosaics differ beyond the limit")
    return share_h, share_c


def city_tiny_card_vs_cpu(entry, root):
    """``predict_city`` of the tiny configuration (float32) on a 200x150
    city: the card (device stitcher) against the CPU (host stitcher)."""
    from srbh_tpu_torch.data.grid import GridImageDataset
    from srbh_tpu_torch.predict.predictor import make_city_step, predict_city

    write_city(root, "tiny", 200, 150, seed=6)
    model, sr, _ = entry.flagship(tiny=True, device="cpu", seed=0)
    with torch.no_grad():  # heights above the clamp at 0
        model.reg.conv_last.bias.fill_(2.0)
    ds = GridImageDataset(root, "tiny", os.path.join(root, "stats"), **GRID_KW)
    paths = {}
    for dev, stitch in (("cpu", "host"), ("cuda", "device")):
        step = make_city_step(copy.deepcopy(model), copy.deepcopy(sr),
                              dtype=torch.float32, device=dev)
        paths[dev] = predict_city(ds, step, os.path.join(root, dev), "tiny",
                                  batch_size=8, stitch=stitch, device=dev)
    log(f"[city] tiny city 200x150, {len(ds)} valid windows")
    compare_mosaics("tiny predict_city card (device stitch) vs CPU (host "
                    "stitch), float32", read_mosaic(paths["cuda"]),
                    read_mosaic(paths["cpu"]))


def check_city_outputs(paths, ds):
    """The CLI's tifs of the full-width city."""
    from srbh_tpu_torch.data.tiff import TiffReader
    from srbh_tpu_torch.predict.colormap import CMAP

    b, h = TiffReader(paths[0]), TiffReader(paths[1])
    side = 4 * CITY_SIDE
    for r in (b, h):
        gt = r.geotransform
        if (r.width, r.height) != (side, side) or (gt[1], gt[5]) != (2.5, -2.5):
            raise AssertionError(f"{r.path}: {r.width}x{r.height}, {gt}")
    cmap = b.info().colormap
    classes, heights = b.read()[..., 0], h.read()[..., 0]
    covered = np.zeros((side, side), bool)
    for x, y, xc, yc in ds.pos:
        covered[4 * y: 4 * (y + yc), 4 * x: 4 * (x + xc)] = True
    nonzero = float((heights[covered] > 0).mean())
    log(f"[city] CLI tifs {side}x{side} at 2.5 m: build {b.dtype} (colormap "
        f"{'yes' if cmap else 'no'}, classes {np.bincount(classes.ravel(), minlength=7).tolist()}), "
        f"height {h.dtype} (compression {h.compression}, max {heights.max()} dm); "
        f"{covered.mean():.3f} of the mosaic under valid cells, {nonzero:.4f} "
        "of it with a height > 0")
    if not cmap or cmap[6] != CMAP[6] or classes.max() > 6 or h.dtype != np.uint16:
        raise AssertionError("build tif: colormap or classes wrong")
    if nonzero < 0.99 or heights[~covered].any():
        raise AssertionError("heights missing under valid cells or set outside")


def time_city_parts(ds, step, timed):
    """One pass of the step's outputs at the device stitcher's batch fed to
    both stitchers (byte-equal mosaics), timing each ``add_batch``, the copy
    to the host, each finalize and the GeoTIFF writes; then the step alone
    on batches already on the card and the loader alone. Returns the host
    stitcher's (classes, heights)."""
    from srbh_tpu_torch.data.pipeline import DataLoader
    from srbh_tpu_torch.predict.device_stitcher import DeviceMosaicAccumulator
    from srbh_tpu_torch.predict.stitcher import MosaicAccumulator
    from srbh_tpu_torch.predict.writers import array2raster, array2raster_rio

    host = MosaicAccumulator(ds.width, ds.height, 7)
    dev = DeviceMosaicAccumulator(ds.width, ds.height, 7, device="cuda")
    loader = DataLoader(ds, batch_size=DEVICE_STITCH_BATCH, num_workers=4,
                        device_put=True, device="cuda", host_keys=("pos",))
    t = dict(copy=0.0, host_add=0.0, device_add=0.0)
    batches = 0
    for batch in loader:
        h, b = step(batch["image"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hn, bn = h.cpu().numpy(), b.cpu().numpy()
        t1 = time.perf_counter()
        host.add_batch(hn, bn, batch["pos"].numpy())
        t2 = time.perf_counter()
        dev.add_batch(h, b, batch["pos"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        t["copy"] += t1 - t0
        t["host_add"] += t2 - t1
        t["device_add"] += t3 - t2
        batches += 1
    t0 = time.perf_counter()
    want = host.finalize()
    t1 = time.perf_counter()
    got = dev.finalize()
    t2 = time.perf_counter()
    equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
    with tempfile.TemporaryDirectory() as out:
        t3 = time.perf_counter()
        array2raster_rio(os.path.join(out, "b.tif"), want[1], ds.s2path,
                         nresolution=2.5, iscmap=True)
        array2raster(os.path.join(out, "h.tif"), want[0], ds.s2path,
                     nresolution=2.5, compress="DEFLATE")
        t4 = time.perf_counter()
    del host, dev
    torch.cuda.empty_cache()
    timed.update({f"{k}_ms_per_batch": 1e3 * v / batches for k, v in t.items()})
    timed.update(host_finalize_s=t1 - t0, device_finalize_s=t2 - t1,
                 tif_writes_s=t4 - t3)
    log(f"[city] identical tiles ({batches} batches of {DEVICE_STITCH_BATCH}) "
        f"into both stitchers: mosaics byte-equal: {equal}; ms per batch: "
        f"copy to host {timed['copy_ms_per_batch']:.2f}, host add_batch "
        f"{timed['host_add_ms_per_batch']:.2f}, device add_batch "
        f"{timed['device_add_ms_per_batch']:.2f}; finalize host "
        f"{timed['host_finalize_s']:.2f} s, device {timed['device_finalize_s']:.2f} s "
        f"(with its copy to the host); two GeoTIFF writes {timed['tif_writes_s']:.2f} s")
    if not equal:
        raise AssertionError("device stitcher != host stitcher on identical tiles")

    x = torch.stack([torch.from_numpy(ds[i]["image"]) for i in
                     range(DEVICE_STITCH_BATCH)]).cuda()
    # the same windows in a batch of 16 and in one of 32: how far bfloat16
    # outputs depend on the batch (cuDNN may pick other kernels)
    (h16, b16), (h32, b32) = step(x[:CLI_BATCH]), step(x)
    d = (h16.int() - h32[:CLI_BATCH].int()).abs()
    timed["batch_dependence"] = dict(
        height_max_lsb=d.max().item(), height_share=(d > 0).float().mean().item(),
        class_share=(b16.int().argmax(-1) != b32[:CLI_BATCH].int().argmax(-1)
                     ).float().mean().item())
    log(f"[city] the same {CLI_BATCH} windows at batch {CLI_BATCH} and "
        f"{DEVICE_STITCH_BATCH}, bfloat16: {timed['batch_dependence']}")
    for bs in (CLI_BATCH, DEVICE_STITCH_BATCH):
        step(x[:bs])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            step(x[:bs])
        torch.cuda.synchronize()
        timed[f"step_alone_windows_per_s_b{bs}"] = 8 * bs / (time.perf_counter() - t0)
    loader = DataLoader(ds, batch_size=CLI_BATCH, num_workers=4,
                        device_put=True, device="cuda", host_keys=("pos",))
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        n += batch["image"].shape[0]
    torch.cuda.synchronize()
    timed["loader_alone_windows_per_s"] = n / (time.perf_counter() - t0)
    log(f"[city] make_city_step alone, bfloat16, batches on the card: "
        f"{timed[f'step_alone_windows_per_s_b{CLI_BATCH}']:.1f} windows/s at batch "
        f"{CLI_BATCH}, {timed[f'step_alone_windows_per_s_b{DEVICE_STITCH_BATCH}']:.1f} "
        f"at batch {DEVICE_STITCH_BATCH}; loader alone (4 processes, batch "
        f"{CLI_BATCH}, to the card): {timed['loader_alone_windows_per_s']:.1f} windows/s")
    return want[1], want[0]


def phase_city(wa, entry, smi):
    import contextlib
    import io
    import resource

    from srbh_tpu_torch.data.grid import GridImageDataset
    from srbh_tpu_torch.predict import __main__ as cli
    from srbh_tpu_torch.predict.predictor import make_city_step, predict_city
    from srbh_tpu_torch.train.checkpoint import save_checkpoint
    from srbh_tpu_torch.train.config import get_args
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.trainer import build_models

    torch.cuda.empty_cache()
    timed = {"memory_at_start_mib": torch.cuda.memory_allocated() / 2**20,
             "host_peak_rss_gib_before": resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 2**20}
    torch.cuda.reset_peak_memory_stats()
    log(f"[city] memory allocated at the start: {timed['memory_at_start_mib']:.1f} MiB")
    t_phase = time.perf_counter()
    stages, last = [], [t_phase]

    def stage(name):
        """Seconds since the last stage, and the host peak RSS so far."""
        now = time.perf_counter()
        stages.append((name, round(now - last[0], 2), round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20, 2)))
        last[0] = now

    with tempfile.TemporaryDirectory() as root:
        city_tiny_card_vs_cpu(entry, os.path.join(root, "tiny"))
        stage("tiny card vs CPU")

        region = os.path.join(root, "data", "urban", "input_data", "s2chn_large")
        t0 = time.perf_counter()
        write_city(region, "synth", CITY_SIDE, CITY_SIDE, seed=7)
        ds = GridImageDataset(region, "synth", os.path.join(region, "stats"),
                              **GRID_KW)
        n_cells = len(GridImageDataset(region, "synth", os.path.join(
            region, "stats"), **dict(GRID_KW, gridvalid=None)))
        timed["city_write_s"] = time.perf_counter() - t0
        logdir = os.path.join(root, "logs")
        argv = ["--datapath", os.path.join(root, "data"), "--logdir", logdir,
                "--logdirhr", os.path.join(root, "no_sr_checkpoint"),
                "--datastats", os.path.join(region, "stats"),
                "--s1dir", "s1x", "--s2dir", "s2x"]
        cfg = get_args(city="globe", argv=argv)
        model, sr = build_models(cfg)  # the CLI builds the same seeded ones
        with torch.no_grad():  # heights above the clamp at 0
            model.reg.conv_last.bias.fill_(2.0)
        os.makedirs(logdir)
        save_checkpoint(logdir, TrainState(model), 20, 0.0)  # + checkpoint20
        stage("city and checkpoint written")
        log(f"[city] synthetic city {CITY_SIDE}x{CITY_SIDE} written in "
            f"{timed['city_write_s']:.2f} s: {n_cells} cells, {len(ds)} valid")

        # the main path: the CLI twin, counted
        inner = cli.predict_cities

        def predict_cities_timed(*args, **kwargs):
            t = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            timed["cli_predict_cities_s"] = time.perf_counter() - t
            return out

        cli.predict_cities = predict_cities_timed
        wa.window_attention.launches = 0
        t0 = time.perf_counter()
        results = cli.main(argv)
        torch.cuda.synchronize()
        timed["cli_main_s"] = time.perf_counter() - t0
        launches = wa.window_attention.launches
        cli.predict_cities = inner
        timed["host_stitch_windows_per_s"] = len(ds) / timed["cli_predict_cities_s"]
        log(f"[city] CLI main (bfloat16, batch {CLI_BATCH}, host stitch): "
            f"{timed['cli_main_s']:.2f} s (models built on the CPU included), "
            f"predict_cities {timed['cli_predict_cities_s']:.2f} s = "
            f"{timed['host_stitch_windows_per_s']:.1f} windows/s end to end; "
            f"window_attention launches on the city path: {launches}; {smi}")
        if len(results) != 1:
            raise AssertionError(f"CLI predicted {len(results)} cities")
        stage("CLI main")
        check_city_outputs(results[0], ds)
        stage("CLI outputs checked")
        stamps = [os.stat(p).st_mtime_ns for p in results[0]]
        t0 = time.perf_counter()
        again = cli.main(argv)
        timed["cli_resume_s"] = time.perf_counter() - t0
        if again != results or [os.stat(p).st_mtime_ns for p in results[0]] != stamps:
            raise AssertionError("a second CLI main rewrote the city")
        log(f"[city] second CLI main (resume): {timed['cli_resume_s']:.2f} s, "
            "nothing rewritten")
        stage("CLI resume")

        # the device stitcher on the same city
        step = make_city_step(model, sr, device="cuda")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            dev_paths = predict_city(ds, step, os.path.join(root, "dev"), "synth",
                                     batch_size=DEVICE_STITCH_BATCH,
                                     stitch="device")
            torch.cuda.synchronize()
            timed["device_stitch_s"] = time.perf_counter() - t0
        if printed.getvalue():
            log(printed.getvalue().strip())
        if "falling back" in printed.getvalue():
            raise AssertionError("the device stitcher fell back to the host")
        timed["device_stitch_windows_per_s"] = len(ds) / timed["device_stitch_s"]
        timed["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[city] predict_city, device stitch, batch {DEVICE_STITCH_BATCH}: "
            f"{timed['device_stitch_s']:.2f} s = "
            f"{timed['device_stitch_windows_per_s']:.1f} windows/s end to end; "
            f"peak device memory {timed['peak_device_gib']:.2f} GiB; {smi}")
        stage("device stitch")
        # bfloat16 outputs depend on the batch (cuDNN picks other kernels), so
        # the device-stitched mosaics are held against the host stitcher fed
        # by the same step at the same batch
        host_mosaic = time_city_parts(ds, step, timed)
        compare_mosaics(f"predict_city device stitch vs the step's tiles through "
                        f"the host stitcher, bfloat16, batch {DEVICE_STITCH_BATCH}",
                        read_mosaic(dev_paths), host_mosaic)
        del host_mosaic
        stage("identical tiles, step and loader alone, compare")
        runs = iter(range(10))
        profile(f"predict_city, device stitch, batch {DEVICE_STITCH_BATCH}",
                lambda: predict_city(ds, step, os.path.join(root, f"prof{next(runs)}"),
                                     "synth", batch_size=DEVICE_STITCH_BATCH,
                                     stitch="device"), warm=False,
                host_ops=False)
        stage("profile of a device-stitch run")
        reader_mib = sum(os.path.getsize(p) for p in (ds.s2path, ds.s1path)) / 2**20
        del model, sr, step
    torch.cuda.empty_cache()
    timed["host_peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    timed["worker_peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
    stage("clean-up")
    timed["phase_s"] = time.perf_counter() - t_phase
    timed["stages"] = stages
    log(f"[city] stages (name, seconds, host peak RSS GiB so far): {stages}")
    log(f"[city] host peak RSS {timed['host_peak_rss_gib']:.2f} GiB (before "
        f"the phase {timed['host_peak_rss_gib_before']:.2f}), largest child "
        f"{timed['worker_peak_rss_gib']:.2f} GiB; the readers hold the city's "
        f"S2 + S1 files whole: {reader_mib:.1f} MiB a process; phase "
        f"{timed['phase_s']:.1f} s")
    return {"launches": launches, **timed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from srbh_tpu_torch import entry
    from srbh_tpu_torch.models.swinir import shift_attn_mask
    from srbh_tpu_torch.ops import window_attention as wa
    from srbh_tpu_torch.predict.predictor import make_city_step
    from srbh_tpu_torch.tools import swinir_harness, timing

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build(wa)
    rows = phase_kernel(wa, shift_attn_mask, timing)
    launches, swin_diff, swin_times, profiled_ms = phase_swinir(wa, swinir_harness)
    phase_flagship(entry, make_city_step)
    train = phase_train(wa, smi)
    log(f"[train] summary {json.dumps(train)}")
    city = phase_city(wa, entry, smi)
    log(f"[city] summary {json.dumps(city)}")

    # the inputs SwinIR gives the kernel: strided views of its qkv projection
    plain, masked = rows["classical_qkv"], rows["classical_masked_qkv"]
    kernel = {
        "name": "window_attention",
        "route": "cuda",
        "source": "srbh_tpu_torch/csrc/window_attention.cu",
        "replaces": "srbh_tpu/ops/pallas/window_attention.py:48 (_attn_kernel)"
                    " and :70 (_attn_kernel_masked)",
        "launches": launches,
        "launches_by_path": {"swinir_forward": launches,
                             "train": train["launches"],
                             "city": city["launches"]},
        "max_abs_err": max(r["max_abs_err"] for n, r in rows.items()
                           if "bf16" not in n),
        "max_abs_err_bf16": max(r["max_abs_err"] for n, r in rows.items()
                                if "bf16" in n),
        "ms": plain["ms"],
        "kernel_ms": plain["ms"],
        "plain_ms": plain["plain_ms"],
        "bound_ms": plain["bound_ms"],
        "bound_by": plain["bound_by"],
        "library_ms": plain["library_ms"],
        "tb_per_s": plain["tb_per_s"],
        "share_of_bound": plain["share_of_bound"],
        "events_ms": plain["events_ms"],
        "swinir_profiled_ms": profiled_ms,
        "masked": {k: masked[k] for k in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "tb_per_s", "share_of_bound", "events_ms")},
        "timed": {n: r for n, r in rows.items() if "ms" in r},
        "shape": [6, 64 * SWIN_BATCH, 64, 30],
        "layout": "strided q/k/v views of the qkv projection",
        "swinir_max_abs_diff": swin_diff,
    }
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
