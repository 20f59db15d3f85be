#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``srbh_tpu_torch``) on one card.

    python3 chip_smoke.py

Runs from the root of the repository on a machine with one NVIDIA H100 and
the CUDA toolkit (``nvcc``). It builds the Hopper window-attention kernel
from ``srbh_tpu_torch/csrc/``, then drives the port's two serving paths, its
two training paths, its two test entry points, its preparation tools and
its parallel modes:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. the kernel build, with ``-Xptxas -v`` (registers, shared memory, spills;
   a spill fails the run);
3. the kernel against its plain PyTorch version and a float64 reference at
   SwinIR's shapes (d 10, 16, 30 and 64; N 49 and 64; nW up to 169, every
   padded size phase 8's harness run gives it;
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
   image, the kernel's device time per call from the profiler, the card
   against the CPU on a small input, and the model in training mode with
   its drop-path (rate 0.1) under ``torch.no_grad()``: the kernel path
   against the plain path from one state of a generator on the card, with
   the kernel's launches;
5. the flagship height step: the tiny configuration on the card against the
   CPU, then the full-width RRDBNet-23 + EfficientNet-B4 step through
   ``make_city_step`` at batch 32 in float32 and bfloat16, through
   ``python -m srbh_tpu_torch.bench``'s ``main``: output shapes, dtypes,
   finite values, build-softmax sums, the ``tools/_trace.py`` guard's
   counts, tiles/s, TFLOP/s, ``mfu``, peak memory, idle share and leading
   kernels (and the memory allocated when the phase starts);
6. the height model's training path: one ``make_train_step`` of the tiny
   configuration on the card against the CPU (loss, rmse and log-vars
   within 1e-4 x (1 + |b|); gradients against float64, and parameters
   wherever the float64 gradient stands clear of float32 noise), and
   the same with the augmentation and normalisation in the step
   (``device_aug``, ``norm``: both devices fed one set of draws); then
   ``train.trainer.main``, the entry point of ``python -m
   srbh_tpu_torch.train``, at full width (RRDBNet-23 + EfficientNet-B4,
   batch 16 tiles of 64x64, float32) on 64 synthetic GeoTIFF tiles for one
   epoch of 4 steps and a resumed second epoch: finite losses, moved
   log-vars, every height-model parameter and some BatchNorm statistics
   changed, the frozen RRDBNet bit-unchanged, the checkpoint reloading to an
   identical state; ``trainer.main`` with ``--device_norm`` for 4 steps;
   ``trainer.main`` with ``--async_checkpoint`` for 2 epochs, each
   written file (``checkpoint1``, ``checkpoint2``, ``checkpoint``) bit-equal
   to CPU clones of the state taken as its ``save_checkpoint`` call
   returned, then a third epoch resumed from it; the time the loop is
   blocked by a synchronous and by an asynchronous save of the full-width
   state (medians of 3), the payload's MiB and the train step's time while
   a write is in flight, beside the card's name and power limit;
   the launches of the hand kernel on these runs (none); train tiles/s of
   ``make_train_step`` alone on batches already on the card in float32 and
   bfloat16, and in float32 with ``device_aug`` and with ``norm`` too, with
   peak memory, idle share and leading kernels each, all through
   ``tools/train_bench.py``'s ``main``; and the trainer's time per step
   with its loader in steady state
   (512 tiles, the prefetch fill left out; the loader raises on an epoch
   short of its 32 batches), beside the loader alone and the time to the
   first batch;
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
   finalize and GeoTIFF writes, and device and host peak memory (the
   device-stitched path's idle share and kernels come from phase 11's
   ``predict_stress``, on a city a quarter the size);
8. the test entry points: ``train.trainer.main_test`` of the tiny
   configuration on the card against the CPU, on one ``torch.save``
   checkpoint (RMSE and ``_he`` rows within
   1e-4 x (1 + |b|), confusion counts within 0.1 % of the pixels, the three
   files alike in lines and columns); ``python -m srbh_tpu_torch.train``
   (the repository's ``train.py``: 20 epochs, then ``main_test`` of
   ``checkpoint20`` on four test lists) at full width (RRDBNet-23 +
   EfficientNet-B4, batch 16, float32) on 32 synthetic train tiles and 16
   test tiles, with ``main_test``'s tiles/s at batch 1; ``--model_variant
   nosuper`` for 2 epochs and its ``main_test``; ``--encoder_weights`` of
   a random B4 state dict in efficientnet-pytorch's form (the grafted
   encoder equal to the widened file, then a step); and the SwinIR harness's
   ``main`` (``python -m srbh_tpu_torch.tools.swinir_harness``) on synthetic
   PNGs: classical SR x4 and colour denoising, whole images and tiles
   smaller than the padded image (16 of the x4 LR, 48 of the noisy
   image), with the hand kernel's launches (36 a forward), ms per image, PSNR /
   SSIM, the written outputs read back, and the kernel path against the
   plain path on one image;
9. the Real-ESRGAN GAN (its step and EMA forward run with
   ``torch.backends.cudnn.benchmark`` on, and the flag is off again after
   the phase): two steps of the tiny configuration (VGG19 perceptual on) on the card against the
   CPU (metrics within 1e-4 x (1 + |b|), spectral norms' u and sigma 1e-5,
   EMA 1e-6); then the recipe's full width (RRDBNet-23 nf 64 gc 32,
   UNetDiscriminatorSN nf 64, VGG19, batch 12, lq 64 -> gt 256, float32)
   through ``train_sr`` on 72 synthetic LR / HR GeoTIFF pairs (6 steps, 4
   loader processes): finite losses, every G and D parameter and every
   norm's u moved, the EMA apart from G, ``net_g`` / ``net_d`` reloading
   identically (``load_sr_generator``); ``eval_sr`` of 12 pairs writing
   ``acc1.txt``; the hand kernel's launches over both (none); ms per step
   of ``train_sr`` in steady state (host stamps as its steps return), eval
   images/s, and the GAN step alone on batches on the card in bfloat16 and
   float32, and in float32 with remat (phase 14's layout option), through
   ``tools/sr_train_bench.py``'s ``main`` (tiles/s, peak memory, the
   device time of one step by kernel);
10. the long tail, run after phase 8 and before the GAN: the remaining
   models (HRFuse, HRFuseX2, GeoNet, RefineResidual, the Geo and Refine
   height variants, EDSR, ESPCN, RRDBNetSimple, the three SRRegress
   ablations), the segmentation and SSIM losses, the ``_pt`` metrics and
   the LPIPS / CLIP / CLIPA / SigLIP towers at small widths on the card
   against the CPU (outputs within 1e-4 of their largest, loss values 1e-5
   relative, input gradients 1e-4 of their largest; the SSIM losses in
   float64); Part A's models at full width on 64x64 tiles in float32
   (the Geo and Refine variants on RRDBNet-23 features at batch 32, the
   SRRegress ablations at batch 8, EDSR, ESPCN and RRDBNetSimple-23 at
   batch 32: tiles/s and peak memory); LPIPS-alex on 12 images of 256x256,
   CLIP ViT-B/16 and SigLIP SO400M card against CPU on one image pair and
   timed on 12, and CLIPA bigG-336 built on the card (images/s); and the
   ``_pt`` metrics against the host float64 metrics on 12 images of
   256x256 (the largest difference and both times);
11. the measurement and serving tools, run after phase 10 and before the
   GAN: each tool's ``main`` once at full width and short length, its JSON
   records parsed and checked (this card's name and power limit; finite,
   positive rates; ``mfu`` at most 1.05; a host-clock step time within
   10 % of the same repeats on the card's clock, CUDA events, and no
   shorter than the device busy time of one profiled step):
   ``profile_flagship`` (float32;
   its ``full`` stage within 10 % of phase 5's bench rate in float32),
   ``conv_microbench``, ``train_diag`` (batch 16), ``loader_bench``,
   ``composed_bench`` (its ``device`` and ``device_norm`` batches
   bit-equal), ``predict_stress`` on a 1024 x 1024 city (the device
   stitcher ran; the two stitchers' outputs byte-equal; the city path's
   idle share and kernels from one device-stitched run under the
   profiler), ``ref_bench``;
   ``export_model`` of the full-width flagship's weights in float32 with a
   symbolic batch, loaded back and held to the eager step at batch 3 and
   32 (floats within 1e-4 x (1 + |b|), quantised outputs within 1 LSB on at
   most 0.1 % of pixels); and ``python -m srbh_tpu_torch.convert --arch
   height`` on the full-width model's weights in the JAX package's npz
   form, the file loaded with ``strict=True`` giving the same step output.
   The bench, ``train_bench`` and ``sr_train_bench`` run in phases 5, 6 and
   9, in place of those phases' own timing loops, so that no rate is timed
   twice. The hand kernel's launches over the phase (none);
12. the preparation path, run after phase 11 and before the GAN: a raw
   city (S2 6-band uint16 in PackBits and S1 2-band float32, 512 x 512
   source pixels at 10 m in EPSG:32650; two WSF tiles in EPSG:4326; 400
   footprints with a floors field, courtyard holes, two-part records and
   records across the raster's edge) prepared with the port alone: the WSF
   tiles mosaicked (``preprocess.mosaic_rasters``), warped to EPSG:32650
   (``products.warp_raster``) and clipped to the S2 extent
   (``main_gen_mask``); the 64/56 fishnet with its ``.prj`` parsed back
   to 32650 and its WSF validity; the footprints burnt at 2.5 m
   (``shp2tif``, ``floor_field_to_height``) as the reference heights; 64
   training tiles, ``generate_allfile`` and ``split_data`` (the splits
   equal to ``RandomState(1).permutation``), ``main_stats`` and
   ``height_histogram`` (equal to a float64 recomputation within 1e-12,
   read back by ``load_stats_table``); then the city CLI at full width on
   the card (bfloat16, batch 16) over the prepared city, and its heights
   scored against the reference (``compare_height_products``,
   ``compare_grid_products``, ``count_valid_samples``: finite numbers,
   well-formed CSVs). The native codec against its plain versions byte for
   byte: PackBits on the S2 raster (MB/s of each), and the C++
   ``add_batch`` against numpy's at phase 7's tile shapes (batch 16 of
   256 x 256, 7 classes) on a 4096^2 canvas, first touch and warm (ms per
   ``add_batch`` and MB/s of each). The hand kernel's launches over the
   phase (none);
13. the parallel modes, run after phase 12 and before the GAN: the card's
   machine has one H100 and NCCL puts one rank on a card, so the process
   group has one rank (``parallel.mesh.initialize_distributed``, NCCL,
   through a file store); the global BatchNorm's multi-rank function
   (``parallel.data._GlobalBatchNorm``) over that one rank against
   ``nn.BatchNorm2d`` (outputs, gradients, running statistics within 1e-4
   x (1 + |b|)); the full-width height step (RRDBNet-23 + EfficientNet-B4,
   batch 16, float32) plain, under DDP, under DDP with the global
   BatchNorm on its multi-rank path (the path of every DDP or FSDP2 step
   over more than one rank; at one rank the module hands the statistics to
   cuDNN) and under FSDP2 of the model and the frozen trunk (as
   ``trainer.main(fsdp=True)`` shards them) from the same weights, the
   first step of each held to the plain one (loss, rmse, log-vars within
   1e-4 x (1 + |b|); parameters by the gradient-noise rule), then each
   one's tiles/s (median and quartiles over 10 steps on the host clock,
   each ending in a synchronise) with the card's name and power limit;
   ``make_city_step(mesh=...)``, ``data`` and
   ``spatial``, byte-equal to the plain step at batch 32, and
   ``stitch_tiles_sharded`` byte-equal to ``stitch_tiles`` on its
   outputs; then ``entry.dryrun_multichip(1)`` (one NCCL process it
   starts). The hand kernel's launches over the phase (none);
14. the layout options, run after phase 13 and before the GAN: each card
   against the CPU at tiny width (the remat height and GAN steps by phases
   6 and 9's rules, the fused and int8 trunks, the int8 sums equal, the
   packed flagship, the dual head); at full width on the card, RRDBNet-23
   fused against literal, the int8 trunk's SNR against float32, the
   packed flagship and the dual head against the literal forms at batch
   32; then once each, with the card's name and power limit, the bench
   under ``SRBH_BENCH_INT8`` and ``SRBH_BENCH_PACKED``, ``train_bench``
   with remat (peak memory beside phase 6's plain step; phase 9 times the
   GAN step with remat beside its plain one, after the GAN shapes'
   autotuning), ``profile_flagship``'s packed and grouped stages beside
   phase 11's literal ones, the city CLI with ``SRBH_PACKED=1`` against
   the literal CLI on phase 7's tiny city, and
   ``srbh_tpu_torch.examples.quickstart`` on the card. The hand kernel's
   launches over the phase (none).

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
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch


ATTN_TOL_F32 = 2e-5  # as tests/test_pallas_attention.py: f32 sums in another order
ATTN_TOL_BF16 = 3.2e-2  # two bf16 ulps at |o| < 4: the kernel keeps p in f32
SWIN_TOL = 1e-4  # whole model, relative to max(1, max |out|): f32, 36 blocks
FLAGSHIP_TOL = 1e-4  # whole model: |a - b| <= tol * (1 + |b|), card vs CPU, f32
TRAIN_TOL = 1e-4  # train step: loss, rmse, log-vars |a - b| <= tol * (1 + |b|)
# the card's float32 train-step gradient against float64: within this share
# of its tensor's largest gradient plus this share of the model's largest (a
# fault of the backward gives errors of the gradient's own size)
TRAIN_GRAD_TOL = (0.1, 1e-4)
TRAIN_BATCH, TRAIN_TILES, TRAIN_STEPS = 16, 64, 4
LOOP_TILES = 512  # the steady-state loader timing: 32 batches of 16
SWIN_BATCH = 8  # 64x64 tiles: B_ = 512 windows a call, 94 MB of q/k/v/o > L2
# phase 8: the harness's HR images (square sides; the x4 LR a quarter, 24 or
# 32 pixels once padded), each task's tile and overlap (a tile smaller than
# every padded image, so each image is cut); the train.py sequence's split
# (2 steps an epoch at batch 16) and loader processes; main_test card vs
# CPU: |a - b| <= tol x (1 + |b|)
HARNESS_SIDES = (64, 72, 80, 96)
HARNESS_TILES = {"classical_sr": (16, 8), "color_dn": (48, 16)}
ENTRY_TRAIN_TILES, ENTRY_TEST_TILES, ENTRY_WORKERS = 32, 16, 4
ENTRY_BATCH = 16
ENTRY_TOL = 1e-4
CITY_BATCH = 32
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
    from srbh_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_FLOP_PER_S

    t_bytes = attn_bytes(h, b_, n, d, dtype, nw) / HBM_BYTES_PER_S
    t_ops = 4 * h * b_ * n * n * d / PEAK_FLOP_PER_S[str(dtype)[6:]]
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
    """Device time by kernel for one call of ``fn`` and the device's idle
    share of the call's wall time (``tools.timing.profile_window``), after
    one call unprofiled if ``warm``. ``host_ops=False`` traces the device
    only (a long call's host ops take the profiler minutes to sort). Returns
    (ms, kernel name) rows, empty if the profiler saw no device time."""
    from srbh_tpu_torch.tools.timing import profile_window

    if warm:
        fn()
    r = profile_window(fn, host_ops, top=None)
    if r["idle_share"] is None:
        log(f"[profile] {label}: device time not measured (no device events)")
        return []
    log(f"[profile] {label}: wall {r['wall_ms']:.3f} ms (profiler on), device "
        f"busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}")
    for ms, key in r["kernels"][:8]:
        log(f"[profile]   {ms:9.3f} ms {100 * ms / r['busy_ms']:5.1f}%  {key[:90]}")
    return r["kernels"]


def phase_device():
    from srbh_tpu_torch.tools.timing import nvidia_smi

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
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
    # every padded image (or tile) phase 8's harness gives the kernel, batch 1
    pad = lambda n: (n // 8 + 1) * 8
    sides = sorted({pad(n // 4) for n in HARNESS_SIDES} | {pad(n) for n in HARNESS_SIDES}
                   | {tile for tile, _ in HARNESS_TILES.values()})
    cases += [(f"harness_{side}_nW{(side // 8) ** 2}", 6, (side // 8) ** 2, 64, 30,
               side, 8, f32, "contiguous", False) for side in sides]
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

    # training mode with the preset's drop-path (0.1, spread over the 36
    # blocks), without gradients: the kernel path and the plain path from
    # one state of one generator on the card
    model.train()
    gen = torch.Generator(device="cuda").manual_seed(7)
    start = gen.get_state()
    outs = {}
    for use_kernel in (True, False):
        for m in attns:
            m.use_kernel = use_kernel
        gen.set_state(start)
        wa.window_attention.launches = 0
        with torch.no_grad():
            outs[use_kernel] = model(x.permute(0, 3, 1, 2), generator=gen)
        torch.cuda.synchronize()
        if use_kernel:
            train_launches = wa.window_attention.launches
    model.eval()
    for m in attns:
        m.use_kernel = True
    rates = [m.drop_path for m in model.modules() if hasattr(m, "drop_path")]
    diff_train = (outs[True] - outs[False]).abs().max().item()
    scale_train = max(1.0, outs[False].abs().max().item())
    moved = (outs[True].permute(0, 2, 3, 1) - out_k).abs().max().item()
    log(f"[swinir] train mode, drop_path_rate 0.1 ({len(rates)} blocks, rates "
        f"{rates[0]:.4f}..{rates[-1]:.4f}), batch {SWIN_BATCH}, one generator "
        f"state: kernel vs plain max_abs_diff={diff_train:.3e} (tol "
        f"{SWIN_TOL:.0e} x {scale_train:.3f}); kernel launches {train_launches}; "
        f"max |train - eval| {moved:.3e}")
    if not (train_launches > 0 and diff_train <= SWIN_TOL * scale_train):
        raise AssertionError("SwinIR train mode: kernel path disagrees with the "
                             "plain path, or the kernel was not launched")
    if not (moved > 0 and torch.isfinite(outs[True]).all()):
        raise AssertionError("SwinIR train mode: drop-path changed nothing")
    return launches, diff, times, profiled_ms, train_launches


def swinir_options(wa, harness, smi):
    """SwinIR classical-SR x4 at full width (embed 180, 6x6 RSTBs) built
    with the official options off, ``qkv_bias=False, patch_norm=False``:
    the kernel path against the plain path on the same weights (the
    phase's bound), the kernel's launches in one forward, ms per image, and
    the card against the CPU on a small input."""
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.swinir import SwinIR

    model = SwinIR(**harness._preset("classical_sr", 4, False), qkv_bias=False,
                   patch_norm=False)
    init_weights(model, torch.Generator().manual_seed(3))
    model = model.eval().cuda()
    keys = list(model.state_dict())
    if any(k.endswith("qkv.bias") or k.startswith("patch_embed.norm")
           for k in keys):
        raise AssertionError("SwinIR options: a qkv bias or patch norm remains")
    attns = [m for m in model.modules() if hasattr(m, "use_kernel")]
    rng = np.random.default_rng(4)
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
    diff = (out_k - out_p).abs().max().item()
    scale = max(1.0, out_p.abs().max().item())
    times = {}
    for use_kernel in (True, False, False, True):
        for m in attns:
            m.use_kernel = use_kernel
        t = cuda_ms(lambda: harness.apply(model, x), iters=5, warmup=1)
        times.setdefault(use_kernel, []).append(t / SWIN_BATCH)
    for m in attns:
        m.use_kernel = True
    small = rng.uniform(0, 1, (1, 24, 24, 3)).astype(np.float32)
    got = harness.apply(model, small).cpu()
    want = harness.apply(copy.deepcopy(model).to("cpu"), small)
    diff_cpu = (got - want).abs().max().item()
    scale_cpu = max(1.0, want.abs().max().item())
    log(f"[swinir] classical_sr x4, qkv_bias False, patch_norm False, embed "
        f"180, 6x6 RSTBs, batch {SWIN_BATCH} x 64x64: kernel vs plain "
        f"max_abs_diff={diff:.3e} (tol {SWIN_TOL:.0e} x {scale:.3f}); launches "
        f"per forward={launches}; ms per image: kernel {times[True]}, plain "
        f"{times[False]}; 24x24 card vs CPU {diff_cpu:.3e} (tol {SWIN_TOL:.0e} x "
        f"{scale_cpu:.3f}); {smi}")
    if out_k.shape != (SWIN_BATCH, 256, 256, 3) or not torch.isfinite(out_k).all():
        raise AssertionError(f"SwinIR options: output {tuple(out_k.shape)}")
    if launches != 36:
        raise AssertionError(f"SwinIR options: {launches} kernel launches, not 36")
    if not (diff <= SWIN_TOL * scale and diff_cpu <= SWIN_TOL * scale_cpu):
        raise AssertionError("SwinIR options: the kernel path disagrees with the "
                             "plain path, or the card with the CPU")
    return {"launches": launches, "max_abs_diff": diff,
            "ms_per_image": times, "card_vs_cpu": diff_cpu}


def phase_flagship(entry, make_city_step, smi):
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

    # full width: RRDBNet-23 + EfficientNet-B4, batch 32 tiles of 64x64,
    # through the bench (its checks: finite outputs, shapes and dtypes,
    # build sums within 4 of 255; the conv guard)
    from srbh_tpu_torch import bench

    records = run_tool("flagship", bench.main, ["--batch", str(CITY_BATCH),
                                                "--repeats", "5"], smi)
    for rec in records:
        log(f"[flagship] full width {rec['dtype']}: {rec['value']:.2f} tiles/s "
            f"at batch {CITY_BATCH}, {rec['tflop_per_s']:.2f} TFLOP/s, mfu "
            f"{rec['mfu']:.4f}, peak {rec['peak_gib']:.2f} GiB, idle share "
            f"{rec['idle_share']:.3f}, build sums within {rec['build_sum_off']} "
            f"of 255, height max {rec['height_max_dm']} dm")
        for ms, key in rec["kernels"][:4]:
            log(f"[flagship]   {rec['dtype']}: {ms:9.3f} ms  {key[:90]}")
    check_convs_seen(records[0])
    return records


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


def write_tiles(root, n, upscale=4):
    """``n`` synthetic tiles (tests/test_e2e_train.py's recipe at 64x64): s2
    uint16 (64, 64, 6), s1 float32 (64, 64, 2), bh uint8 at x``upscale``
    ((256, 256) at 2.5 m by default), the train and validation lists, min-max
    tables and a height histogram."""
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
        hr = 64 * upscale
        write_tiff(os.path.join(root, "bhc", name),
                   rng.integers(0, 100, (hr, hr)).astype(np.uint8),
                   (gt[0], 10.0 / upscale, 0.0, gt[3], 0.0, -10.0 / upscale))
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


def keep_step_grads(state):
    """Have ``state`` keep, on the host, each parameter's gradient as its
    step hands it to Adam; returns the dict it fills."""
    grads, apply = {}, state.apply_gradients

    def keep(lr):
        grads.update({n: p.grad.detach().cpu().double()
                      for n, p in state.model.named_parameters()})
        return apply(lr)

    state.apply_gradients = keep
    return grads


def loss_grads_f64(model, sr, b):
    """The gradient of the train step's loss (aggre + weight losses, log-vars
    0) at the step's starting weights on the batch the model trained on,
    in float64 on the CPU."""
    from srbh_tpu_torch.losses.adaptive import ce_dice_adapt_weight, mse_adapt_weight

    m, s = copy.deepcopy(model).double().train(), copy.deepcopy(sr).double().eval()
    t = {k: torch.as_tensor(v).cpu() for k, v in b.items()}
    t = {k: v.double() if v.is_floating_point() else v for k, v in t.items()}
    image = t["image"].permute(0, 3, 1, 2)
    with torch.no_grad():
        fea = s(image[:, :3], features_only=True)
    h, bl, a = m(image, fea)
    lv = torch.zeros(3, dtype=torch.float64)
    loss = (mse_adapt_weight(h[:, 0], t["height"], t["weight"], lv[0])
            + mse_adapt_weight(a[:, 0], t["height_aggre"], t["weight_aggre"], lv[1])
            + ce_dice_adapt_weight(bl, t["build"], t["weight"], lv[2]))
    loss.backward()
    return {n: p.grad for n, p in m.named_parameters()}


def train_tiny_card_vs_cpu(label="make_train_step", batch=None, remat=False,
                           **step_kw):
    """One train step of the tiny configuration on the card and on the CPU
    from the same weights and batch, drop-connect off. Losses within
    ``TRAIN_TOL``. Parameters by the gradient-noise rule of
    tests/test_torch_train_step.py: Adam's first update is +-lr whatever the
    gradient's size, so an element whose gradient lies within float32
    rounding of 0 may move either way on the two devices. A difference
    beyond 1e-4 is a fault where the float64 gradient stands clear of twice
    the float32 error of the two devices' own gradients (the largest in its
    tensor) plus 1e-6 x the model's largest gradient. So that no fault of
    the card's backward widens the noise that would hide it, the card's
    gradient must lie within ``TRAIN_GRAD_TOL`` of float64: a share of its
    tensor's largest gradient plus a share of the model's. ``remat``
    recomputes the model's fusion stack in the backward pass."""
    from srbh_tpu_torch.models.height_model import SRRegressClsFeature
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.rrdbnet import RRDBNet
    from srbh_tpu_torch.train import steps
    from srbh_tpu_torch.train.state import TrainState

    gen = torch.Generator().manual_seed(0)
    sr = init_weights(RRDBNet(num_block=2, num_feat=16, num_grow_ch=8), gen)
    model = init_weights(SRRegressClsFeature(
        "efficientnet-test", super_mid=8, isaggre=True, chans_build=7,
        sr_chans=16, drop_connect_rate=0.0, remat=remat), gen)
    batch = train_batch(np.random.default_rng(4), 4) if batch is None else batch
    trained_on, augment = dict(batch), steps._augment

    def keep_augmented(*args):  # the batch the CPU's step trains on
        trained_on.update(augment(*args))
        return trained_on

    out = {}
    for dev in ("cpu", "cuda"):
        m, s = copy.deepcopy(model).to(dev), copy.deepcopy(sr).to(dev)
        state = TrainState(m)
        grads = keep_step_grads(state)
        steps._augment = keep_augmented if dev == "cpu" else augment
        metrics = steps.make_train_step(m, s, device=dev, **step_kw)(state, batch, 1e-3)
        out[dev] = ({k: v.cpu() for k, v in metrics.items()},
                    {n: p.detach().cpu() for n, p in m.named_parameters()}, grads)
    steps._augment = augment
    (want, p_cpu, g_cpu), (got, p_card, g_card) = out["cpu"], out["cuda"]
    for key in ("loss", "rmse", "log_vars"):
        err = ((got[key] - want[key]).abs() / (1 + want[key].abs())).max().item()
        log(f"[train] tiny {label} {key} card vs CPU: max "
            f"|a-b|/(1+|b|)={err:.3e} (tol {TRAIN_TOL:.0e})")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"tiny {label} {key} disagrees card vs CPU")
    g64 = loss_grads_f64(model, sr, trained_on)
    scale = max(g.abs().max().item() for g in g64.values())
    rel, absolute = TRAIN_GRAD_TOL
    bad = faults = clear_total = 0
    worst = dict(cpu=0.0, card=0.0)
    off = []
    for n, g in g64.items():
        top = g.abs().max().item()
        e_cpu = (g_cpu[n] - g).abs().max().item()
        e_card = (g_card[n] - g).abs().max().item()
        for dev, e in (("cpu", e_cpu), ("card", e_card)):
            worst[dev] = max(worst[dev], e / (rel * top + absolute * scale))
        if e_card > rel * top + absolute * scale:
            off.append(n)
        clear = g.abs() > 2 * max(e_cpu, e_card) + 1e-6 * scale
        differ = (p_card[n] - p_cpu[n]).abs() > 1e-4
        bad += int(differ.sum())
        faults += int((differ & clear).sum())
        clear_total += int(clear.sum())
    total = sum(p.numel() for p in p_cpu.values())
    log(f"[train] tiny {label} float32 gradients against float64: the largest "
        f"error as a share of its limit ({rel:g} x the tensor's max |g| + "
        f"{absolute:g} x the model's, {scale:.3e}): CPU {worst['cpu']:.3e}, "
        f"card {worst['card']:.3e}; card tensors beyond: {len(off)}")
    log(f"[train] tiny {label} params card vs CPU: {bad} of {total} elements "
        f"beyond 1e-4 (share {bad / total:.2e}); of the {clear_total} whose "
        f"float64 gradient stands clear of float32 noise, {faults} beyond")
    if off or faults:
        raise AssertionError(f"tiny {label} disagrees card vs CPU: gradients "
                             f"{off[:5]}, {faults} clear-gradient params")


def raw_batch(rng, n, tile=64):
    """One host batch of the device-norm step: raw S2 DNs (uint16), S1,
    the height raster (uint8)."""
    return {"s2": rng.integers(0, 5000, (n, tile, tile, 6)).astype(np.uint16),
            "s1": rng.uniform(-25, 5, (n, tile, tile, 2)).astype(np.float32),
            "height": rng.integers(0, 100, (n, 4 * tile, 4 * tile)).astype(np.uint8)}


# the step's normalisation tables (a narrow S2 range, so clipping matters)
NORM = {"s2_off": np.full(6, 1000.0), "s2_scale": np.full(6, 3000.0),
        "s1_off": np.full(2, -25.0), "s1_scale": np.full(2, 30.0)}


def device_aug_tiny_card_vs_cpu():
    """The tiny step with in-step augmentation and normalisation, card
    against CPU. The two devices' generators draw differently, so both
    steps take one set of draws made on the CPU (the step's
    ``draw_augment`` is swapped for the run)."""
    from srbh_tpu_torch.ops.device_aug import draw_augment
    from srbh_tpu_torch.train import steps

    draws = draw_augment(4, torch.Generator().manual_seed(11))
    # each transform fires on some samples and not on others
    draws["flip"] = torch.tensor([True, False, True, False])
    draws["shuffle"] = torch.tensor([True, True, False, False])
    draws["rotate"] = torch.tensor([True, False, False, True])
    log(f"[train] device-aug draws: flip {draws['flip'].tolist()}, shuffle "
        f"{draws['shuffle'].tolist()}, rotate {draws['rotate'].tolist()}, angles "
        f"{[round(a, 2) for a in draws['angle'].tolist()]}")
    steps.draw_augment = lambda n, gen: {k: v.to(gen.device) for k, v in draws.items()}
    train_tiny_card_vs_cpu("make_train_step(device_aug, norm)",
                           raw_batch(np.random.default_rng(12), 4),
                           device_aug=True, norm=NORM)
    steps.draw_augment = draw_augment


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
    """The last checkpoint of ``trainer.main`` restored into a fresh state:
    model, log-vars and step equal to the live state's; Adam's state bit
    for bit with ``cfg.save_opt_state``, else absent from the file and empty
    in the restored optimizer until its first step (the reference's and the
    JAX package's resume)."""
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
    if cfg.save_opt_state:
        diff += [f"optimizer {i}.{k}" for i, st in opt_b["state"].items()
                 for k, v in st.items() if not torch.equal(
                     torch.as_tensor(opt_a["state"][i][k]).cpu(),
                     torch.as_tensor(v).cpu())]
    elif "optimizer" in payload or opt_a["state"]:
        diff.append("optimizer (saved or restored by default)")
    if not torch.equal(fresh.log_vars, state.log_vars) or fresh.step != state.step:
        diff.append("log_vars/step")
    log(f"[train] checkpoint (epoch {payload['epoch']}, step {payload['step']}, "
        f"save_opt_state {cfg.save_opt_state}: optimizer entry "
        f"{'optimizer' in payload}, restored Adam state of "
        f"{len(opt_a['state'])} tensors) reloads: {len(diff)} tensors differ")
    if diff:
        raise AssertionError(f"checkpoint does not reload identically: {diff[:5]}")


def time_steps(smi):
    """tiles/s of ``make_train_step`` alone on batches already on the card,
    through ``tools/train_bench.py``'s ``main``: float32 and bfloat16 with
    host-augmented batches, then float32 with the augmentation
    (``--device_aug``) and also the normalisation (``--norm``) in the step;
    peak memory, idle share and leading kernels of one step each."""
    from srbh_tpu_torch.tools import train_bench

    results = {}
    for label, argv in (("", ["--dtype", "float32", "bfloat16"]),
                        (" device_aug", ["--dtype", "float32", "--device_aug"]),
                        (" device_aug + norm", ["--dtype", "float32", "--norm"])):
        for rec in run_tool("train", train_bench.main, [
                "--batch", str(TRAIN_BATCH), "--repeats", "3", "--steps", "2",
                *argv], smi):
            results[rec["dtype"] + label] = dict(
                tiles_per_s=rec["value"], ms_per_step=rec["median_ms"],
                peak_gib=rec["peak_gib"], idle_share=rec["idle_share"])
            for ms, key in rec["kernels"][:4]:
                log(f"[train]   {rec['dtype']}{label}: {ms:9.3f} ms  {key[:90]}")
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


ASYNC_EPOCHS, SAVE_REPEATS = 2, 3


def _host_state(state, save_opt_state=True):
    """CPU clones of the model's, the log-vars' and (with
    ``save_opt_state``) the optimizer's tensors."""
    opt = state.optimizer.state_dict()["state"] if save_opt_state else {}
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "log_vars": state.log_vars.detach().cpu().clone(),
            "optimizer": {i: {k: torch.as_tensor(v).detach().cpu().clone()
                              for k, v in st.items()} for i, st in opt.items()},
            "step": state.step}


def _differing(payload, clone):
    """Names of the tensors in which a checkpoint payload and a clone differ
    (a clone without optimizer tensors wants a payload without them)."""
    bad = [k for k, v in clone["model"].items()
           if not torch.equal(payload["model"][k], v)]
    if not clone["optimizer"] and "optimizer" in payload:
        bad.append("optimizer (written without save_opt_state)")
    bad += [f"optimizer {i}.{k}" for i, st in clone["optimizer"].items()
            for k, v in st.items()
            if not torch.equal(payload["optimizer"]["state"][i][k], v)]
    if not torch.equal(payload["log_vars"], clone["log_vars"]):
        bad.append("log_vars")
    if payload["step"] != clone["step"]:
        bad.append("step")
    return bad


def check_async_checkpoints(wa, train_main, cfg, root, save_opt_state):
    """``trainer.main`` at full width for ``ASYNC_EPOCHS`` epochs with
    ``--async_checkpoint`` (and ``save_opt_state`` as given: with it, Adam's
    tensors are compared too), each ``save_checkpoint`` call made with
    ``snapshot_every=1`` (every epoch leaves ``checkpoint{epoch}``) and
    recorded by CPU clones of the state taken as the call returns. Training
    goes on while the thread writes; after ``main`` (which joins the last
    write) each ``checkpoint{epoch}``, and ``checkpoint`` as the last, must
    equal its clone bit for bit. Then, with ``save_opt_state``, one epoch
    resumed from the file (the default resume is phase 6's first run's)."""
    from srbh_tpu_torch.train import trainer

    cfg_a = dataclasses.replace(
        cfg, maxepoch=ASYNC_EPOCHS, async_checkpoint=True,
        save_opt_state=save_opt_state,
        logdir=os.path.join(root, f"logs_async_opt_{save_opt_state}"))
    clones, save = {}, trainer.save_checkpoint

    def recording(logdir, state, epoch, best_rmse, snapshot_every=5,
                  is_best=False, save_opt_state=False, async_save=False):
        t0 = time.perf_counter()
        path = save(logdir, state, epoch, best_rmse, snapshot_every=1,
                    is_best=is_best, save_opt_state=save_opt_state,
                    async_save=async_save)
        blocked = 1e3 * (time.perf_counter() - t0)
        written = os.path.exists(os.path.join(logdir, f"checkpoint{epoch}"))
        clones[epoch] = dict(_host_state(state, save_opt_state),
                             blocked_ms=blocked, written_at_return=written,
                             async_save=async_save)
        return path

    wa.window_attention.launches = 0
    trainer.save_checkpoint = recording
    try:
        state = train_main(cfg_a, max_steps_per_epoch=TRAIN_STEPS, device="cuda")
    finally:
        trainer.save_checkpoint = save
    launches = wa.window_attention.launches
    files = {e: f"checkpoint{e}" for e in clones}
    files["last"] = "checkpoint"
    report = {}
    for e, name in files.items():
        clone = clones[ASYNC_EPOCHS if e == "last" else e]
        payload = torch.load(os.path.join(cfg_a.logdir, name), map_location="cpu",
                             weights_only=True)
        bad = _differing(payload, clone)
        report[name] = len(bad)
        if bad:
            raise AssertionError(f"async checkpoint {name} differs from the state "
                                 f"at its call: {bad[:5]}")
    went_on = sum(not torch.equal(v, clones[ASYNC_EPOCHS]["model"][k])
                  for k, v in clones[1]["model"].items())
    log(f"[train] trainer.main --async_checkpoint --save_opt_state "
        f"{save_opt_state}, {ASYNC_EPOCHS} epochs of "
        f"{TRAIN_STEPS} steps: saves {[clones[e]['async_save'] for e in sorted(clones)]} "
        f"asynchronous; loop blocked {[round(clones[e]['blocked_ms'], 1) for e in sorted(clones)]}"
        f" ms; checkpoint{{epoch}} written when the call returned: "
        f"{[clones[e]['written_at_return'] for e in sorted(clones)]}; tensors "
        f"differing from the clone at each call: {report}; tensors epoch 2 "
        f"changed after epoch 1's save: {went_on}; window_attention launches {launches}")
    if state.step != ASYNC_EPOCHS * TRAIN_STEPS or not all(
            clones[e]["async_save"] for e in clones) or not went_on:
        raise AssertionError("async trainer run: wrong step count, a synchronous "
                             "save, or no training after the first save")
    if not save_opt_state:
        return state, launches
    cfg_a.maxepoch = ASYNC_EPOCHS + 1
    resumed = train_main(cfg_a, max_steps_per_epoch=TRAIN_STEPS, device="cuda")
    log(f"[train] resumed from the asynchronous checkpoint of epoch "
        f"{ASYNC_EPOCHS} (save_opt_state {save_opt_state}): step {resumed.step}")
    if resumed.step != (ASYNC_EPOCHS + 1) * TRAIN_STEPS:
        raise AssertionError(f"async resume: step {resumed.step}")
    return resumed, launches


def time_checkpoint_saves(state, cfg, root, smi):
    """How long the training loop waits for a save of the full-width state,
    by default (model and log-vars) and with ``save_opt_state`` (Adam's two
    moments too): ``SAVE_REPEATS`` synchronous saves and as many
    asynchronous ones (each joined before the next), medians; and the train
    step's time while an asynchronous write is in flight against without
    one (the writing thread's pickling takes the GIL from the loop's
    Python)."""
    from srbh_tpu_torch.train import checkpoint as ckpt
    from srbh_tpu_torch.train.steps import make_train_step

    logdir = os.path.join(root, "logs_blocked")
    os.makedirs(logdir)
    step = make_train_step(state.model, state.sr_model, seed=cfg.seed, device="cuda")
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in train_batch(np.random.default_rng(13), TRAIN_BATCH).items()}

    def timed_step():
        t0 = time.perf_counter()
        step(state, batch, 1e-4)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for _ in range(2):
        timed_step()
    alone = [timed_step() for _ in range(5)]
    out = {}
    for save_opt_state in (False, True):
        blocked = {False: [], True: []}
        during, commit = [], []
        for async_save in (False,) * SAVE_REPEATS + (True,) * SAVE_REPEATS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save_checkpoint(logdir, state, 1, 1.0,
                                        save_opt_state=save_opt_state,
                                        async_save=async_save)
            blocked[async_save].append(1e3 * (time.perf_counter() - t0))
            while async_save and not ckpt._pending.done():
                during.append(timed_step())
            if async_save:
                ckpt.wait_for_saves()
                commit.append(1e3 * (time.perf_counter() - t0))
        mib = os.path.getsize(path) / 2**20
        r = {"payload_mib": mib,
             "sync_blocked_ms": float(np.median(blocked[False])),
             "async_blocked_ms": float(np.median(blocked[True])),
             "async_commit_ms": float(np.median(commit)),
             "step_ms_alone": float(np.median(alone)),
             "step_ms_during_commit": float(np.median(during)) if during else None,
             "steps_during_commits": len(during)}
        out["with_opt_state" if save_opt_state else "default"] = r
        log(f"[train] checkpoint save of the full-width state, save_opt_state "
            f"{save_opt_state} ({mib:.1f} MiB): loop "
            f"blocked {r['sync_blocked_ms']:.1f} ms by a synchronous save, "
            f"{r['async_blocked_ms']:.1f} ms by an asynchronous one (medians of "
            f"{SAVE_REPEATS}: {[round(t, 1) for t in blocked[False]]} / "
            f"{[round(t, 1) for t in blocked[True]]}); the asynchronous write done "
            f"{r['async_commit_ms']:.1f} ms after the call; train step "
            f"{r['step_ms_alone']:.1f} ms alone, "
            + (f"{r['step_ms_during_commit']:.1f} ms" if during else "not measured")
            + f" while a write is in flight ({len(during)} steps); {smi}")
        if not r["async_blocked_ms"] < r["sync_blocked_ms"]:
            raise AssertionError("an asynchronous save blocked the loop as long "
                                 "as a synchronous one")
    if not out["default"]["payload_mib"] < out["with_opt_state"]["payload_mib"]:
        raise AssertionError("the default checkpoint is not smaller than the "
                             "one with the optimizer state")
    return out


def phase_train(wa, smi):
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.trainer import build_models, main as train_main

    torch.cuda.empty_cache()
    log(f"[train] memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    train_tiny_card_vs_cpu()
    device_aug_tiny_card_vs_cpu()
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
        counts = {float(st["step"]) for st in resumed.optimizer.state.values()}
        log(f"[train] resumed by default (a fresh Adam): step {resumed.step}, "
            f"Adam's own step counts {sorted(counts)}")
        if resumed.step != 2 * TRAIN_STEPS or len(record.scalars["lr"]) != 2 \
                or counts != {float(TRAIN_STEPS)}:
            raise AssertionError(f"resume: step {resumed.step}, Adam {counts}")
        check_trained(resumed, init_model, init_sr, record.scalars)
        del state, resumed
        torch.cuda.empty_cache()
        # --save_opt_state true: Adam's state in the file, an exact resume
        cfg_exact = dataclasses.replace(cfg, save_opt_state=True, maxepoch=1,
                                        logdir=os.path.join(root, "logs_exact"))
        record = ScalarLog()
        state = train_main(cfg_exact, writer=record,
                           max_steps_per_epoch=TRAIN_STEPS, device="cuda")
        check_checkpoint(cfg_exact, state)
        cfg_exact.maxepoch = 2
        resumed = train_main(cfg_exact, writer=record,
                             max_steps_per_epoch=TRAIN_STEPS, device="cuda")
        counts = {float(st["step"]) for st in resumed.optimizer.state.values()}
        log(f"[train] resumed with --save_opt_state: step {resumed.step}, Adam's "
            f"own step counts {sorted(counts)}")
        if resumed.step != 2 * TRAIN_STEPS or counts != {2.0 * TRAIN_STEPS}:
            raise AssertionError(f"exact resume: step {resumed.step}, Adam {counts}")
        check_trained(resumed, init_model, init_sr, record.scalars)
        del state, resumed
        torch.cuda.empty_cache()
        # python -m srbh_tpu_torch.train --device_norm true: normalisation,
        # augmentation and targets in the step
        cfg_norm = dataclasses.replace(cfg, device_norm=True, maxepoch=1,
                                       logdir=os.path.join(root, "logs_norm"))
        wa.window_attention.launches = 0
        record = ScalarLog()
        t0 = time.perf_counter()
        normed = train_main(cfg_norm, writer=record,
                            max_steps_per_epoch=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        aug_launches = wa.window_attention.launches
        log(f"[train] trainer.main --device_norm, {TRAIN_STEPS} steps + "
            f"validation + checkpoint: {time.perf_counter() - t0:.2f} s wall; "
            f"window_attention launches: {aug_launches}")
        if normed.step != TRAIN_STEPS:
            raise AssertionError(f"--device_norm trainer took {normed.step} steps")
        check_trained(normed, init_model, init_sr, record.scalars)
        del normed
        torch.cuda.empty_cache()
        state, async_default_launches = check_async_checkpoints(
            wa, train_main, cfg, root, save_opt_state=False)
        del state
        torch.cuda.empty_cache()
        resumed, async_launches = check_async_checkpoints(
            wa, train_main, cfg, root, save_opt_state=True)
        saves = time_checkpoint_saves(resumed, cfg, root, smi)
        del resumed
        torch.cuda.empty_cache()
        loop = time_loader(cfg, smi)
    steps = time_steps(smi)
    return {"launches": launches, "device_aug_launches": aug_launches,
            "async_launches": async_launches,
            "async_default_launches": async_default_launches, "saves": saves,
            "steps": steps, "loop_ms": loop}


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


def rss_kib():
    """This process's peak RSS (``VmHWM``, KiB), or its RSS now (``VmRSS``)
    where ``/proc/self/status`` has no peak: unlike ``getrusage``'s
    ``ru_maxrss``, which the kernel updates only on unmaps and exits, both
    count the pages resident now. 0 where the file has neither (a sample
    must not raise ``StopIteration``: torch's loader would end the epoch)."""
    with open("/proc/self/status") as f:
        fields = dict(line.split(":", 1) for line in f if ":" in line)
    value = fields.get("VmHWM", fields.get("VmRSS", "0 kB"))
    return int(value.split()[0])


class CountingWindows(torch.utils.data.Dataset):
    """A city dataset's windows, each sample with the id of the loader
    process that read it, that process's chunk decodes so far and its peak
    RSS (KiB): phase 7's look at the readers inside the workers."""

    def __init__(self, ds):
        self.ds, self.decodes = ds, 0
        for r in (ds.s2, ds.s1):
            r._decode_chunk = self._counted(r, r._decode_chunk)

    def _counted(self, reader, decode):
        def run(idx, shape):
            self.decodes += idx not in reader._cache
            return decode(idx, shape)
        return run

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        sample = self.ds[i]
        info = torch.utils.data.get_worker_info()
        sample.update(worker=np.int64(info.id if info else -1),
                      decodes=np.int64(self.decodes),
                      rss_kib=np.int64(rss_kib()))
        return sample


def loader_pass(ds):
    """One epoch of the city's windows through the loader (4 processes,
    batch ``CLI_BATCH``, to the card, ``prefetch`` 2): windows/s, and per
    process its chunk decodes, its peak RSS over its windows and that
    peak's rise over the RSS at its first window (GiB)."""
    from srbh_tpu_torch.data.pipeline import DataLoader

    loader = DataLoader(CountingWindows(ds), batch_size=CLI_BATCH,
                        num_workers=4, device_put=True, device="cuda",
                        host_keys=("pos", "worker", "decodes", "rss_kib"),
                        prefetch=2)
    seen = {}
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        n += batch["image"].shape[0]
        w = int(batch["worker"][-1])
        first = seen.get(w, {}).get("first_kib", int(batch["rss_kib"][0]))
        peak = max(seen.get(w, {}).get("rss_kib", 0), int(batch["rss_kib"].max()))
        seen[w] = {"first_kib": first, "decodes": int(batch["decodes"][-1]),
                   "rss_kib": peak}
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    return {"windows_per_s": rate,
            "decodes": [seen[w]["decodes"] for w in sorted(seen)],
            "worker_peak_rss_gib": [seen[w]["rss_kib"] / 2**20 for w in sorted(seen)],
            "worker_rss_rise_gib": [(seen[w]["rss_kib"] - seen[w]["first_kib"]) / 2**20
                                    for w in sorted(seen)]}


def check_city_reader(region, step, dev_paths, out, timed, smi):
    """The memory-mapped, caching ``TiffReader`` of the main path against
    an uncached one (``max_cache_bytes=0``, this check's alone): the device
    stitcher's mosaics from the same step at the same batch byte-equal, and
    the loader alone over each, with each process's chunk decodes and RSS."""
    from srbh_tpu_torch.data.grid import GridImageDataset
    from srbh_tpu_torch.data.tiff import TiffReader
    from srbh_tpu_torch.predict.predictor import predict_city

    def dataset(cached):
        ds = GridImageDataset(region, "synth", os.path.join(region, "stats"),
                              **GRID_KW)
        if not cached:
            ds.s2.close()
            ds.s1.close()
            ds.s2 = TiffReader(ds.s2path, max_cache_bytes=0)
            ds.s1 = TiffReader(ds.s1path, max_cache_bytes=0)
        return ds

    paths = predict_city(dataset(False), step, out, "synth",
                         batch_size=DEVICE_STITCH_BATCH, stitch="device")
    equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in
                zip(read_mosaic(paths), read_mosaic(dev_paths)))
    ds = dataset(True)
    chunks = len(ds.s2.chunk_offsets) + len(ds.s1.chunk_offsets)
    passes = {"cached": loader_pass(ds), "uncached": loader_pass(dataset(False))}
    timed["reader"] = dict(passes, mosaics_byte_equal=equal, chunks=chunks)
    for name, r in passes.items():
        log(f"[city] loader alone, {name} reader (4 processes, batch {CLI_BATCH}, "
            f"prefetch 2, to the card): {r['windows_per_s']:.1f} windows/s; chunk "
            f"decodes per process {r['decodes']} (the files hold {chunks} "
            f"strips); process peak RSS {[round(g, 3) for g in r['worker_peak_rss_gib']]} "
            f"GiB, risen by {[round(g, 3) for g in r['worker_rss_rise_gib']]} GiB "
            f"over the epoch; {smi}")
    log(f"[city] device-stitched mosaics, cached reader vs uncached, same step, "
        f"batch {DEVICE_STITCH_BATCH}: byte-equal {equal}")
    if not equal:
        raise AssertionError("the cached reader's mosaics differ from the "
                             "uncached reader's")
    if max(passes["cached"]["decodes"]) > chunks:
        raise AssertionError("a loader process decoded a strip twice")


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
        check_city_reader(region, step, dev_paths, os.path.join(root, "uncached"),
                          timed, smi)
        stage("cached reader against the uncached one")
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
        f"{timed['worker_peak_rss_gib']:.2f} GiB (a forked process starts at "
        f"its parent's RSS); the readers map the city's S2 + S1 files "
        f"({reader_mib:.1f} MiB) and cache what they decode; phase "
        f"{timed['phase_s']:.1f} s")
    return {"launches": launches, **timed}


def write_entry_split(root):
    """``ENTRY_TRAIN_TILES`` + ``ENTRY_TEST_TILES`` synthetic tiles and the
    lists of train.py's globe run: train, validation and test, and the test
    lists of china, eu and usa (the same test tiles)."""
    write_tiles(root, ENTRY_TRAIN_TILES + ENTRY_TEST_TILES)
    names = [f"t_{i}.tif" for i in range(ENTRY_TRAIN_TILES + ENTRY_TEST_TILES)]
    lists = {"datalist_globe_train_0.7.csv": names[:ENTRY_TRAIN_TILES],
             "datalist_globe_test_0.7_val_0.3.csv": names[ENTRY_TRAIN_TILES:]}
    for city in ("globe", "china", "eu", "usa"):
        lists[f"datalist_{city}_test_0.7_test_0.3.csv"] = names[ENTRY_TRAIN_TILES:]
    for listname, rows in lists.items():
        with open(os.path.join(root, listname), "w") as f:
            f.writelines(f"{name},s1c,s2c,bhc\n" for name in rows)
    return ["--datapath", root, "--datastats", root,
            "--preweight", os.path.join(root, "bh_stats.txt"), "--s1dir", "s1c",
            "--s2dir", "s2c", "--bhdir", "bhc",
            "--logdirhr", os.path.join(root, "no_sr_checkpoint"),
            "--num_workers", str(ENTRY_WORKERS)]


def read_acc(logdir, stem):
    """(rmse, seg rows, he rows) of ``main_test``'s three files; NaN for an
    empty field."""
    num = lambda v: float(v) if v else float("nan")
    rmse = float(open(os.path.join(logdir, stem + ".txt")).read())
    seg = [line.split(",") for line in
           open(os.path.join(logdir, stem + "_seg.csv")).read().splitlines()]
    he = [line.split(",") for line in
          open(os.path.join(logdir, stem + "_he.csv")).read().splitlines()]
    if he[0] != ["rmse", "mae", "me", "count"]:
        raise AssertionError(f"{stem}_he.csv header {he[0]}")
    return (rmse, [[num(v) for v in r[:-1]] + [r[-1]] for r in seg],
            np.array([[num(v) for v in r] for r in he[1:]]))


def main_test_tiny_card_vs_cpu(root, argv):
    """``main_test`` of the tiny configuration on the card and on the CPU
    from one checkpoint ``checkpoint20``."""
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import get_args

    cfg = get_args(argv=argv + [
        "--logdir", os.path.join(root, "tiny"), "--checkpoint", "checkpoint20",
        "--encoder_name", "efficientnet-test", "--super_mid", "8",
        "--sr_num_block", "1", "--sr_num_feat", "8", "--sr_num_grow", "8"])
    model, _ = trainer.build_models(cfg)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():  # running statistics drawn, heights above 0
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.normal_(0, 0.1, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 1.5, generator=gen)
        model.reg.conv_last.bias.fill_(4.0)
    os.makedirs(cfg.logdir)
    torch.save({"epoch": 20, "best_rmse": float("inf"), "step": 0,
                "model": model.state_dict(), "log_vars": None},
               os.path.join(cfg.logdir, "checkpoint20"))
    res = {dev: trainer.main_test(cfg, num_sample=0, suffix=dev, device=dev)
           for dev in ("cpu", "cuda")}
    (r_c, seg_c, he_c), (r_g, seg_g, he_g) = (read_acc(cfg.logdir, f"acc20{dev}_0")
                                              for dev in ("cpu", "cuda"))
    shape = lambda rows: [len(r) for r in rows]
    if shape(seg_c) != shape(seg_g) or [r[-1] for r in seg_c] != [r[-1] for r in seg_g] \
            or he_c.shape != (9, 4) or he_g.shape != (9, 4):
        raise AssertionError("main_test files differ in lines or columns card vs CPU")
    ncls = len(seg_c) - 6
    cm_c, cm_g = (np.array([r[:ncls] for r in seg[6:]]) for seg in (seg_c, seg_g))
    pixels = cm_c.sum()
    moved = np.abs(cm_c - cm_g).sum() / 2
    err_rmse = abs(r_g - r_c) / (1 + abs(r_c))
    err_he = float(np.nanmax(np.abs(he_g - he_c) / (1 + np.abs(he_c))))
    log(f"[entry] tiny main_test from one checkpoint20, card vs CPU, "
        f"{ENTRY_TEST_TILES} tiles at batch 1: rmse {r_g:.6f} / {r_c:.6f} "
        f"(|a-b|/(1+|b|) {err_rmse:.3e}), _he rows {err_he:.3e} (tol "
        f"{ENTRY_TOL:.0e}); confusion counts moved {moved:g} of {pixels:g} pixels "
        f"(limit {QUANT_SHARE:.0e}); oa {res['cuda']['oa']:.6f} / {res['cpu']['oa']:.6f}")
    if not (err_rmse <= ENTRY_TOL and err_he <= ENTRY_TOL and cm_g.sum() == pixels
            and moved <= QUANT_SHARE * pixels
            and (np.isnan(he_c) == np.isnan(he_g)).all()):
        raise AssertionError("the tiny main_test disagrees card vs CPU")


def stamp_predict_steps(trainer, stamps):
    """Have ``trainer.main_test``'s predict steps stamp the host clock at
    their second and last call, both synchronised: the steady-state rate of
    the test loop, loader and metrics included. ``stamps`` gets one
    ``[t_second, t_last, calls, step]`` a ``main_test``. Returns the
    undo."""
    inner = trainer.make_predict_step

    def stamped(*args, **kwargs):
        step = inner(*args, **kwargs)
        row = [None, None, 0, step]
        stamps.append(row)

        def run(image):
            out = step(image)
            row[2] += 1
            if row[2] in (2, ENTRY_TEST_TILES):
                torch.cuda.synchronize()
                row[0 if row[2] == 2 else 1] = time.perf_counter()
            return out

        return run

    trainer.make_predict_step = stamped
    return lambda: setattr(trainer, "make_predict_step", inner)


def train_py_sequence(wa, root, argv, smi):
    """``python -m srbh_tpu_torch.train`` at full width: 20 epochs, then
    ``main_test`` of ``checkpoint20`` on the globe, china, eu and usa test
    lists."""
    from srbh_tpu_torch.train import __main__ as train_cli
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.checkpoint import load_checkpoint

    logdir = os.path.join(root, "globe")
    stamps, timed = [], {}
    undo = stamp_predict_steps(trainer, stamps)
    inner_main = trainer.main

    def timed_main(*args, **kwargs):
        t = time.perf_counter()
        out = inner_main(*args, **kwargs)
        torch.cuda.synchronize()
        timed["main_s"] = time.perf_counter() - t
        return out

    trainer.main = timed_main
    wa.window_attention.launches = 0
    t0 = time.perf_counter()
    results = train_cli.main(argv + ["--logdir", logdir])
    timed["sequence_s"] = time.perf_counter() - t0
    launches = wa.window_attention.launches
    trainer.main = inner_main
    undo()
    payload = load_checkpoint(os.path.join(logdir, "checkpoint20"))
    rows = []
    for suffix, num in (("", 100), ("china", 0), ("eu", 0), ("usa", 0)):
        rmse, seg, he = read_acc(logdir, f"acc20{suffix}_{num}")
        cm = np.array([r[:-1] for r in seg[6:]])
        rows.append((suffix or "globe", rmse, len(seg), he.shape))
        # precision and IoU of a class random weights never predict are NaN
        if not (np.isfinite(rmse) and np.isfinite(he).all() and he.shape == (9, 4)
                and cm.sum() == ENTRY_TEST_TILES * 256 * 256):
            raise AssertionError(f"acc20{suffix}_{num}: rmse {rmse}, he {he.shape}, "
                                 f"{cm.sum()} pixels")
    rates = [(ENTRY_TEST_TILES - 2) / (row[1] - row[0]) for row in stamps]
    timed.update(main_test_tiles_per_s=rates, launches=launches)
    log(f"[entry] python -m srbh_tpu_torch.train, RRDBNet-23 + EfficientNet-B4, batch "
        f"16, float32, {ENTRY_TRAIN_TILES} train / {ENTRY_TEST_TILES} test tiles, "
        f"{ENTRY_WORKERS} loader processes: {timed['sequence_s']:.2f} s (main, 20 epochs "
        f"of 2 steps + validation + checkpoints: {timed['main_s']:.2f} s); checkpoint20 "
        f"epoch {payload['epoch']}, step {payload['step']}; acc files (list, rmse, seg "
        f"rows, he shape): {rows}; main_test at batch 1 in steady state: "
        f"{[round(r, 2) for r in rates]} tiles/s; window_attention launches: "
        f"{launches}; {smi}")
    if payload["epoch"] != 20 or payload["step"] != 40 or len(results) != 4 \
            or len(stamps) != 4 or any(row[2] != ENTRY_TEST_TILES for row in stamps):
        raise AssertionError(f"the train.py sequence: epoch {payload['epoch']}, "
                             f"step {payload['step']}, {len(results)} tests")
    image = torch.tensor(np.random.default_rng(15).uniform(0, 1, (1, 64, 64, 8))
                         .astype(np.float32), device="cuda")
    profile("main_test's predict step, batch 1, full width, float32",
            lambda: stamps[-1][3](image))
    return timed


def nosuper_entry(wa, root, argv):
    """``--model_variant nosuper``: 2 epochs, then ``main_test``."""
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import get_args

    cfg = get_args(argv=argv + ["--logdir", os.path.join(root, "nosuper"),
                                "--model_variant", "nosuper", "--maxepoch", "2"])
    wa.window_attention.launches = 0
    t0 = time.perf_counter()
    state = trainer.main(cfg, device="cuda")
    res = trainer.main_test(cfg, num_sample=0, suffix="nosuper")
    wall = time.perf_counter() - t0
    launches = wa.window_attention.launches
    log(f"[entry] trainer.main --model_variant nosuper, 2 epochs + main_test: "
        f"{wall:.2f} s, step {state.step}, rmse {res['rmse']:.4f}, oa "
        f"{res['oa']:.4f}; window_attention launches: {launches}")
    if state.step != 4 or state.sr_model is not None or not np.isfinite(res["rmse"]):
        raise AssertionError(f"nosuper: step {state.step}, {res}")
    return launches


def nosuper_x2_entry(wa, root, smi):
    """``--model_variant nosuper --upscale 2`` at full width (EfficientNet-B4,
    batch 16) on 64x64 tiles with 128x128 height tiles at 5 m: one epoch of
    2 steps, then ``main_test`` at batch 1; heights and classes at 128^2."""
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.steps import make_predict_step

    write_tiles(root, ENTRY_TRAIN_TILES, upscale=2)
    cfg = TrainConfig(
        datapath=root, trainlist="dl_train.csv", vallist="dl_val.csv",
        testlist="dl_val.csv", logdir=os.path.join(root, "logs"),
        logdirhr=os.path.join(root, "no_sr_checkpoint"), datastats=root,
        preweight=os.path.join(root, "bh_stats.txt"), s1dir="s1c",
        s2dir="s2c", bhdir="bhc", maxepoch=1, batch_size=ENTRY_BATCH,
        num_workers=ENTRY_WORKERS, model_variant="nosuper", upscale=2,
        isaggre=False)
    wa.window_attention.launches = 0
    t0 = time.perf_counter()
    state = trainer.main(cfg, device="cuda")
    res = trainer.main_test(cfg, num_sample=0, suffix="x2")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wa.window_attention.launches
    image = np.random.default_rng(16).uniform(0, 1, (2, 64, 64, 8)).astype(np.float32)
    height, logits = make_predict_step(state.model, None, device="cuda")(image)
    _, seg, he = read_acc(cfg.logdir, "acc1x2_0")
    pixels = np.array([r[:-1] for r in seg[6:]]).sum()
    log(f"[entry] trainer.main --model_variant nosuper --upscale 2, "
        f"EfficientNet-B4, batch {ENTRY_BATCH}, {ENTRY_TRAIN_TILES} tiles: 1 "
        f"epoch + main_test at batch 1: {wall:.2f} s, step {state.step}, rmse "
        f"{res['rmse']:.4f}, oa {res['oa']:.4f}; outputs {tuple(height.shape)} "
        f"/ {tuple(logits.shape)}; {pixels:g} test pixels counted; "
        f"window_attention launches: {launches}; {smi}")
    if state.step != ENTRY_TRAIN_TILES // ENTRY_BATCH or not np.isfinite(res["rmse"]) \
            or tuple(height.shape) != (2, 128, 128) \
            or tuple(logits.shape) != (2, 128, 128, cfg.chans_build) \
            or pixels != ENTRY_TRAIN_TILES * 128 * 128 or he.shape != (9, 4):
        raise AssertionError(f"nosuper x2: step {state.step}, {res}, "
                             f"{tuple(height.shape)}, {pixels} pixels")
    return launches


def imagenet_state_dict(name, seed):
    """A random ImageNet state dict of EfficientNet ``name`` in
    efficientnet-pytorch's form: a 3-channel stem, drawn BatchNorm
    statistics, the classifier head."""
    from srbh_tpu_torch.models.efficientnet import EfficientNetEncoder
    from srbh_tpu_torch.models.layers import init_weights

    gen = torch.Generator().manual_seed(seed)
    sd = init_weights(EfficientNetEncoder(name, 3), gen).state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0, 0.1, generator=gen)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=gen)
    last = len({k.split(".")[1] for k in sd if k.startswith("_blocks.")}) - 1
    width = sd[f"_blocks.{last}._project_conv.weight"].shape[0]
    sd.update({"_conv_head.weight": torch.randn(1792, width, 1, 1, generator=gen),
               "_bn1.weight": torch.ones(1792), "_bn1.bias": torch.zeros(1792),
               "_bn1.running_mean": torch.zeros(1792), "_bn1.running_var": torch.ones(1792),
               "_fc.weight": torch.randn(1000, 1792, generator=gen),
               "_fc.bias": torch.zeros(1000)})
    return sd


def encoder_weights_entry(root, argv):
    """``--encoder_weights`` of a torch file: the grafted encoder equals the
    file's (its stem widened to 8 channels), and ``trainer.main`` grafts it
    on a fresh run and takes a step."""
    import contextlib
    import io

    from srbh_tpu_torch.convert import widen_stem
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import get_args

    path = os.path.join(root, "imagenet.pth")
    cfg = get_args(argv=argv + ["--logdir", os.path.join(root, "enc"),
                                "--encoder_weights", path, "--maxepoch", "1"])
    sd = imagenet_state_dict(cfg.encoder_name, 13)
    torch.save(sd, path)
    model, _ = trainer.build_models(cfg)
    trainer.load_encoder_weights(cfg, model)
    got = model.encoder.state_dict()
    want = {k: widen_stem(v, 8) if k == "_conv_stem.weight" else v
            for k, v in sd.items() if k in got}
    diff = [k for k, v in want.items() if not torch.equal(got[k], v.to(got[k].dtype))]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        state = trainer.main(cfg, max_steps_per_epoch=1, device="cuda")
    lines = printed.getvalue().strip().splitlines()
    for line in lines:
        log(line)
    log(f"[entry] --encoder_weights: {cfg.encoder_name} in efficientnet-pytorch's "
        f"form (3-channel stem, classifier head): {len(got)} encoder tensors, "
        f"{len(diff)} differ from the widened file; trainer.main step {state.step}")
    if diff or len(want) != len(got) or state.step != 1 or \
            f"=> encoder initialised from {path}" not in lines:
        raise AssertionError(f"--encoder_weights: {diff[:5]}, step {state.step}")


def write_pngs(root):
    """Smooth BGR PNGs of ``HARNESS_SIDES`` (``gt``) and their 4x4 block
    means (``lq``: ``<name>x4.png``), written by ``data/png.py``."""
    from srbh_tpu_torch.data import png

    rng = np.random.default_rng(14)
    for d in ("gt", "lq"):
        os.makedirs(os.path.join(root, d))
    for i, side in enumerate(HARNESS_SIDES):
        yy, xx = np.mgrid[:side, :side]
        hr = np.stack([128 + 90 * np.sin((xx + 5 * i) / (6.0 + c)) * np.cos(yy / (7.0 + i))
                       for c in range(3)], -1)
        hr = np.clip(hr + rng.normal(0, 6, hr.shape), 0, 255).astype(np.uint8)
        lr = hr.reshape(side // 4, 4, side // 4, 4, 3).mean((1, 3)).round().astype(np.uint8)
        png.imwrite(os.path.join(root, "gt", f"im{i}.png"), hr)
        png.imwrite(os.path.join(root, "lq", f"im{i}x4.png"), lr)


def harness_entry(wa, root, smi):
    """``swinir_harness.main`` (``python -m srbh_tpu_torch.tools.
    swinir_harness``) for classical SR x4 and colour denoising at full width,
    whole images and the task's tiles (``HARNESS_TILES``), from state dicts
    saved here; then the kernel path against the plain path on one image."""
    from srbh_tpu_torch.data import png
    from srbh_tpu_torch.tools import swinir_harness as harness

    write_pngs(root)
    gt, lq = os.path.join(root, "gt"), os.path.join(root, "lq")
    inner_apply, calls = harness.apply, []

    def timed_apply(model, x):
        t = time.perf_counter()
        out = inner_apply(model, x)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t)
        return out

    harness.apply = timed_apply
    runs, launches = [], 0
    for task, scale in (("classical_sr", 4), ("color_dn", 1)):
        weights = os.path.join(root, f"{task}.pth")
        torch.save(harness.define_model(task, scale, device="cpu", seed=1).state_dict(),
                   weights)
        tile_size, overlap = HARNESS_TILES[task]
        for tile in (None, tile_size):
            argv = ["--task", task, "--scale", str(scale), "--folder_gt", gt,
                    "--folder_lq", lq, "--model_path", weights]
            run_dir = os.path.join(root, f"{task}_{tile}")
            out = os.path.join(run_dir, "results", f"swinir_{task}_x{scale}")
            os.makedirs(run_dir)
            here = os.getcwd()
            os.chdir(run_dir)  # main writes to results/ in the working directory
            calls.clear()
            wa.window_attention.launches = 0
            t0 = time.perf_counter()
            res = harness.main(argv + (["--tile", str(tile), "--tile_overlap",
                                        str(overlap)] if tile else []))
            wall = time.perf_counter() - t0
            os.chdir(here)
            n = wa.window_attention.launches
            launches += n
            shapes = [png.imread(os.path.join(out, f"im{i}_SwinIR.png")).shape
                      for i in range(len(HARNESS_SIDES))]
            row = dict(task=task, tile=tile, forwards=len(calls), launches=n,
                       ms_per_image=1e3 * sum(calls) / len(HARNESS_SIDES),
                       ms_per_forward_median=1e3 * float(np.median(calls)),
                       main_s=wall, psnr=res["psnr"], ssim=res["ssim"])
            runs.append(row)
            log(f"[entry] swinir_harness.main {task} x{scale}, tile {tile}, "
                f"{len(HARNESS_SIDES)} images of {HARNESS_SIDES} px: {row}; outputs "
                f"{shapes}; {smi}")
            # whole images: a forward each; tiles: more than one an image
            cut = len(calls) > len(HARNESS_SIDES) if tile else \
                len(calls) == len(HARNESS_SIDES)
            if n != 36 * len(calls) or shapes != [(s, s, 3) for s in HARNESS_SIDES] \
                    or not cut or not np.isfinite([res["psnr"], res["ssim"]]).all():
                raise AssertionError(f"swinir harness {task} tile {tile}: {row}")
    harness.apply = inner_apply

    # one image through the kernel path and the plain path
    model = harness.define_model("classical_sr", 4, device="cpu")
    harness.load_weights(model, os.path.join(root, "classical_sr.pth"), "classical_sr")
    model.cuda()
    lr = png.imread(os.path.join(lq, "im3x4.png"))[..., ::-1].astype(np.float32) / 255
    x = harness.pad_to_window_multiple(lr, 8)[None]
    outs = []
    for use_kernel in (True, False):
        for m in model.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = use_kernel
        outs.append(harness.apply(model, np.ascontiguousarray(x)))
    diff = (outs[0] - outs[1]).abs().max().item()
    scale = max(1.0, outs[1].abs().max().item())
    log(f"[entry] harness image {x.shape[1]}x{x.shape[2]} (nW {(x.shape[1] // 8) ** 2}): "
        f"kernel vs plain max_abs_diff={diff:.3e} (tol {SWIN_TOL:.0e} x {scale:.3f})")
    if not diff <= SWIN_TOL * scale:
        raise AssertionError("the harness's kernel path disagrees with the plain path")
    return runs, launches


def phase_entry(wa, smi):
    """Phase 8: the test entry points."""
    torch.cuda.empty_cache()
    log(f"[entry] memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    t_phase = time.perf_counter()
    timed, stages = {}, []
    with tempfile.TemporaryDirectory() as root:
        argv = write_entry_split(root)
        stages.append(("split written", time.perf_counter() - t_phase))
        main_test_tiny_card_vs_cpu(root, argv)
        stages.append(("tiny main_test card vs CPU", time.perf_counter() - t_phase))
        timed["sequence"] = train_py_sequence(wa, root, argv, smi)
        stages.append(("train.py sequence", time.perf_counter() - t_phase))
        timed["nosuper_launches"] = nosuper_entry(wa, root, argv)
        stages.append(("nosuper", time.perf_counter() - t_phase))
        timed["nosuper_x2_launches"] = nosuper_x2_entry(
            wa, os.path.join(root, "x2"), smi)
        stages.append(("nosuper x2", time.perf_counter() - t_phase))
        encoder_weights_entry(root, argv)
        stages.append(("encoder weights", time.perf_counter() - t_phase))
        timed["harness"], timed["harness_launches"] = harness_entry(
            wa, os.path.join(root, "pngs"), smi)
        stages.append(("swinir harness", time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    timed["phase_s"] = time.perf_counter() - t_phase
    timed["stages_s"] = [(name, round(t, 2)) for name, t in stages]
    log(f"[entry] stages (name, seconds since the phase began): {timed['stages_s']}; "
        f"phase {timed['phase_s']:.1f} s")
    return timed


# phase 10: the long tail. Card vs CPU at small widths: model outputs within
# LT_MODEL_TOL of their largest magnitude, loss values within LT_LOSS_TOL
# relative, input gradients within LT_GRAD_TOL of their largest, the _pt
# metrics within LT_MODEL_TOL relative (the tolerances of the CPU tests
# against the JAX package). SSIM-family losses in float64 on both devices:
# in float32 their values carry ~1e-5 of rounding (tests/test_torch_ssim.py).
LT_MODEL_TOL, LT_LOSS_TOL, LT_GRAD_TOL = 1e-4, 1e-5, 1e-4
LT_TILES, LT_TILES_SR = 32, 8  # full-width batches of 64x64 tiles
LT_WINDOW_S, LT_MIN_CALLS = 1.0, 3  # each rate: >= 1 s of back-to-back calls
LT_IMAGES, LT_SIDE = 12, 256  # LPIPS and the _pt metrics: 12 images of 256^2


def _lt_random(model, seed):
    """Seeded weights with random BatchNorm statistics and affines and
    biases, drawn on the CPU; eval mode."""
    from srbh_tpu_torch.models.layers import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var") or (name.endswith("weight") and t.ndim == 1):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return model.eval()


def _lt_outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _lt_model_card_vs_cpu(name, model, *inputs):
    """One forward on each device; returns the largest relative error."""
    card = copy.deepcopy(model).cuda()
    with torch.no_grad():
        want = _lt_outputs(model(*inputs))
        got = _lt_outputs(card(*(x.cuda() for x in inputs)))
    err = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
              for a, b in zip(got, want))
    if not err <= LT_MODEL_TOL:
        raise AssertionError(f"[long_tail] {name} card vs CPU: {err:.3e}")
    return err


def _lt_loss_card_vs_cpu(name, fn, x, *aux):
    """Value and input gradient of ``fn(x, *aux)`` on each device."""
    res = []
    for dev in ("cpu", "cuda"):
        xd = x.detach().to(dev).requires_grad_(True)
        val = fn(xd, *(a.to(dev) for a in aux))
        val.backward()
        res.append((val.item(), xd.grad.cpu()))
    (want, g_want), (got, g_got) = res
    v_err = abs(got - want) / max(abs(want), 1e-30)
    g_err = (g_got - g_want).abs().max().item() / g_want.abs().max().item()
    if not (v_err <= LT_LOSS_TOL and g_err <= LT_GRAD_TOL):
        raise AssertionError(f"[long_tail] {name} card vs CPU: value {v_err:.3e}, "
                             f"gradient {g_err:.3e}")
    return v_err, g_err


def long_tail_models_card_vs_cpu():
    """Part A's models at small widths, the card against the CPU."""
    from srbh_tpu_torch.models import edsr, height_model, hrfuse, rrdbnet, sr_regress
    from srbh_tpu_torch.models.espcn import ESPCN

    enc, dec = "efficientnet-test", (32, 24, 16, 12, 8)
    gen = torch.Generator().manual_seed(10)
    r = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    trunk = dict(encoder_name=enc, decoder_channels=dec)
    cases = {
        "HRFuse": (hrfuse.HRFuse(24, 16, 3), r(2, 16, 8, 8), r(2, 8, 8, 8)),
        "HRFuseX2": (hrfuse.HRFuseX2(8, 16, 3), r(2, 16, 8, 8), r(2, 8, 32, 32)),
        "GeoNet": (hrfuse.GeoNet(3, 8), r(2, 3, 16, 16)),
        "RefineResidual": (hrfuse.RefineResidual(24, 8, 3), r(2, 16, 16, 16),
                           r(2, 8, 16, 16)),
        "SRRegressClsFeatureGeo": (height_model.SRRegressClsFeatureGeo(
            super_mid=8, geo_mid=4, isaggre=True, chans_build=7, sr_chans=8,
            **trunk), r(2, 11, 32, 32), r(2, 8, 128, 128)),
        "SRRegressClsFeatureRefine": (height_model.SRRegressClsFeatureRefine(
            super_mid=8, isaggre=True, chans_build=7, sr_chans=8, **trunk),
            r(2, 8, 32, 32), r(2, 8, 128, 128)),
        "EDSR": (edsr.EDSR(in_chans=4, n_resblocks=2, n_feats=8,
                           return_features="hr"), r(2, 4, 16, 16)),
        "ESPCN": (ESPCN(4), r(2, 3, 16, 16)),
        "RRDBNetSimple": (rrdbnet.RRDBNetSimple(num_feat=8, num_block=2,
                                                num_grow_ch=8), r(2, 4, 16, 16)),
        "SRRegress": (sr_regress.SRRegress(**trunk), r(1, 8, 8, 8)),
        "SRRegressClsEDSR": (sr_regress.SRRegressClsEDSR(**trunk), r(1, 8, 8, 8)),
        "SRRegressClsDecision": (sr_regress.SRRegressClsDecision(super_mid=8, **trunk),
                                 r(1, 8, 32, 32)),
    }
    errs = {}
    for i, (name, (model, *inputs)) in enumerate(cases.items()):
        errs[name] = _lt_model_card_vs_cpu(name, _lt_random(model, i), *inputs)
    log(f"[long_tail] models card vs CPU, max |a-b| / max |b| (tol "
        f"{LT_MODEL_TOL:.0e}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def long_tail_losses_card_vs_cpu():
    """The segmentation losses, the SSIM losses and the _pt metrics, the
    card against the CPU."""
    from srbh_tpu_torch.losses import segmentation as seg
    from srbh_tpu_torch.losses import ssim_loss
    from srbh_tpu_torch.metrics import image

    gen = torch.Generator().manual_seed(11)
    logits = torch.randn(2, 3, 16, 16, generator=gen) * 1.5
    labels = torch.randint(0, 3, (2, 16, 16), generator=gen)
    bin_logits = torch.randn(2, 1, 16, 16, generator=gen) * 1.5
    target = torch.randint(0, 2, (2, 1, 16, 16), generator=gen).float()
    bd_pred = torch.rand(2, 1, 16, 16, generator=gen)
    bd_target = torch.randint(0, 256, (2, 1, 16, 16), generator=gen).float()
    dist = torch.from_numpy(seg.one_hot_distance_transform(labels.numpy(), 3))
    edts = torch.from_numpy(seg.edts_penalized_map(labels.numpy() > 0) + 1.0)
    dp, dg = torch.rand(2, 16, 16, generator=gen) * 4, torch.rand(2, 16, 16, generator=gen) * 4
    multi = ["soft_dice_loss", "iou_loss", "tversky_loss", "focal_tversky_loss",
             "asym_loss", "ss_loss", "gdice_loss", "gdice_loss_v2",
             "penalty_gdice_loss", "focal_loss", "topk_ce_loss",
             "weighted_ce_loss", "hausdorff_er_loss", "dc_and_ce_loss",
             "dc_and_topk_loss", "explog_loss", "ce_dice_iou_loss"]
    binary = ["bce_ssim_iou_loss", "bce_iou_loss", "bce_ssim_loss", "bce_dice_loss"]
    cases = {n: (getattr(seg, n), logits, labels) for n in multi}
    cases.update({n: (getattr(seg, n), bin_logits, target) for n in binary})
    cases.update({
        "lovasz_softmax": (lambda x, y: seg.lovasz_softmax(torch.softmax(x, 1), y),
                           logits, labels),
        "dist_penalized_ce": (lambda x, y: seg.dist_penalized_ce(x, y, None),
                              logits, labels),
        "dist_binary_dice_loss": (seg.dist_binary_dice_loss, logits[:, :2], labels.clamp(max=1), edts),
        "boundary_loss": (seg.boundary_loss, logits, dist),
        "dc_and_bd_loss": (seg.dc_and_bd_loss, logits, labels, dist),
        "hausdorff_dt_loss": (seg.hausdorff_dt_loss, logits[:, :2], labels.clamp(max=1), dp, dg),
        "ce_mse_loss": (seg.ce_mse_loss, logits, labels, bd_pred, bd_target),
        "bce_ssim_iou_bd_loss": (seg.bce_ssim_iou_bd_loss, bin_logits, target,
                                 bd_pred, bd_target),
        "nll_loss": (seg.nll_loss, torch.log_softmax(torch.randn(64, 3, generator=gen), 1),
                     torch.randint(0, 3, (64,), generator=gen)),
    })
    a = torch.rand(1, 1, 176, 176, generator=gen, dtype=torch.float64) * 255
    b = (a + torch.randn(a.shape, generator=gen, dtype=torch.float64) * 25).clamp(0, 255)
    small = a[:, :, :24, :24] / 255, b[:, :, :24, :24] / 255
    cases.update({
        "ssim_loss (f64)": (lambda x, y: ssim_loss.ssim_loss(x, y, 1.0), *small),
        "log_ssim_loss (f64)": (ssim_loss.log_ssim_loss, *small),
        "ms_ssim_loss (f64)": (ssim_loss.ms_ssim_loss, a, b),
    })
    errs = {name: _lt_loss_card_vs_cpu(name, fn, *args)
            for name, (fn, *args) in cases.items()}
    worst_v = max(errs.items(), key=lambda kv: kv[1][0])
    worst_g = max(errs.items(), key=lambda kv: kv[1][1])
    log(f"[long_tail] {len(errs)} losses card vs CPU: largest value error "
        f"{worst_v[1][0]:.2e} ({worst_v[0]}, tol {LT_LOSS_TOL:.0e}), largest "
        f"gradient error {worst_g[1][1]:.2e} ({worst_g[0]}, tol {LT_GRAD_TOL:.0e})")
    x = torch.rand(3, 3, 32, 32, generator=gen)
    y = (x + torch.randn(x.shape, generator=gen) * 0.1).clamp(0, 1)
    pt_err = 0.0
    for name in ("calculate_psnr_pt", "calculate_ssim_pt", "calculate_cpsnr_pt"):
        for kw in (dict(), dict(crop_border=2, test_y_channel=True)):
            fn = getattr(image, name)
            want, got = fn(x, y, **kw), fn(x.cuda(), y.cuda(), **kw).cpu()
            pt_err = max(pt_err, ((got - want).abs() / want.abs()).max().item())
    log(f"[long_tail] _pt metrics card vs CPU: max relative {pt_err:.2e} "
        f"(tol {LT_MODEL_TOL:.0e})")
    if not pt_err <= LT_MODEL_TOL:
        raise AssertionError("[long_tail] _pt metrics disagree card vs CPU")
    return {"losses": len(errs), "loss_value_err": worst_v[1][0],
            "loss_grad_err": worst_g[1][1], "pt_err": pt_err}


def long_tail_towers_card_vs_cpu():
    """LPIPS, CLIP, CLIPA and SigLIP towers at small widths."""
    from srbh_tpu_torch.models import clip, lpips

    gen = torch.Generator().manual_seed(12)
    cases = {
        "LPIPS": (lpips.LPIPS(), torch.rand(2, 3, 64, 64, generator=gen),
                  torch.rand(2, 3, 64, 64, generator=gen)),
        "CLIP": (clip.CLIPVisionTransformer(32, 8, 16, 2, 2, 8),
                 torch.rand(2, 3, 32, 32, generator=gen)),
        "CLIPA": (clip.CLIPVisionTransformer(28, 7, 16, 2, 2, 8, False, 24, False,
                                             "avg", True),
                  torch.rand(2, 3, 28, 28, generator=gen)),
        "SigLIP": (clip.MAPVisionTransformer(28, 7, 16, 2, 2, 24),
                   torch.rand(2, 3, 28, 28, generator=gen)),
    }
    errs = {name: _lt_model_card_vs_cpu(name, _lt_random(m, 20 + i), *inputs)
            for i, (name, (m, *inputs)) in enumerate(cases.items())}
    log("[long_tail] towers card vs CPU, max |a-b| / max |b|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def _lt_rate(label, fn, items, smi):
    """Items/s of ``fn`` over back-to-back calls that fill at least
    LT_WINDOW_S and LT_MIN_CALLS, synchronised about ten times a window (the
    chunk sized by one synchronised call after the warm-up), and the peak
    memory of the timed calls."""
    with torch.no_grad():
        out = [torch.as_tensor(t) for t in _lt_outputs(fn())]
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"[long_tail] {label}: outputs not finite")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        chunk = math.ceil(LT_WINDOW_S / 10 / (time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats()
        calls, t0 = 0, time.perf_counter()
        while calls < LT_MIN_CALLS or time.perf_counter() - t0 < LT_WINDOW_S:
            for _ in range(chunk):
                fn()
            torch.cuda.synchronize()
            calls += chunk
        secs = time.perf_counter() - t0
    rate = items * calls / secs
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[long_tail] {label}: {rate:.1f} /s ({calls} calls in {secs:.2f} s), "
        f"peak {peak:.2f} GiB, outputs {[tuple(t.shape) for t in out]} ({smi})")
    return {"rate": rate, "peak_gib": peak, "calls": calls, "seconds": secs}


def long_tail_full_width(smi):
    """Part A's models at full width on 64x64 tiles, float32."""
    from srbh_tpu_torch.models import edsr, height_model, rrdbnet, sr_regress
    from srbh_tpu_torch.models.espcn import ESPCN

    gen = torch.Generator().manual_seed(13)
    timed = {}
    x = torch.rand(LT_TILES, 11, 64, 64, generator=gen).cuda()
    sr = _lt_random(rrdbnet.RRDBNet(num_block=23), 30).cuda()
    with torch.no_grad():
        fea = sr(x[:, :3], features_only=True)
    del sr
    for name, model, args in (
            ("SRRegressClsFeatureGeo", height_model.SRRegressClsFeatureGeo(
                isaggre=True, chans_build=7), (x, fea)),
            ("SRRegressClsFeatureRefine", height_model.SRRegressClsFeatureRefine(
                isaggre=True, chans_build=7), (x[:, :8], fea))):
        m = _lt_random(model, 31).cuda()
        timed[name] = _lt_rate(f"{name} batch {LT_TILES} (tiles/s)",
                               lambda: m(*args), LT_TILES, smi)
        del m
    del fea
    xs = x[:LT_TILES_SR, :8]
    for name, model in (("SRRegress", sr_regress.SRRegress()),
                        ("SRRegressClsEDSR", sr_regress.SRRegressClsEDSR()),
                        ("SRRegressClsDecision", sr_regress.SRRegressClsDecision())):
        m = _lt_random(model, 32).cuda()
        timed[name] = _lt_rate(f"{name} batch {LT_TILES_SR} (tiles/s)",
                               lambda: m(xs), LT_TILES_SR, smi)
        if name == "SRRegress":
            with torch.no_grad():
                profile(f"{name} batch {LT_TILES_SR}", lambda: m(xs))
        del m
    for name, model, inp in (
            ("EDSR", edsr.EDSR(), x[:, :3]), ("ESPCN", ESPCN(), x[:, :3]),
            ("RRDBNetSimple", rrdbnet.RRDBNetSimple(), x[:, :4])):
        m = _lt_random(model, 33).cuda()
        timed[name] = _lt_rate(f"{name} batch {LT_TILES} (tiles/s)",
                               lambda: m(inp), LT_TILES, smi)
        del m
    torch.cuda.empty_cache()
    return timed


def long_tail_learned(smi):
    """The learned metrics at full width on random weights."""
    from srbh_tpu_torch.metrics import learned
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.lpips import LPIPS

    gen = torch.Generator().manual_seed(14)
    rng = np.random.default_rng(14)
    timed = {}
    imgs = torch.rand(LT_IMAGES, 3, LT_SIDE, LT_SIDE, generator=gen).cuda()
    imgs2 = (imgs + 0.1 * torch.randn(imgs.shape, generator=gen).cuda()).clamp(0, 1)
    lp = _lt_random(LPIPS(), 40).cuda()
    lp_sd = lp.state_dict()
    timed["lpips"] = _lt_rate(f"LPIPS-alex, {LT_IMAGES} images of {LT_SIDE}^2 "
                              "(images/s)",
                              lambda: learned.calculate_lpips_pt(imgs, imgs2, lp_sd, lp),
                              LT_IMAGES, smi)
    img = rng.uniform(0, 255, (LT_SIDE, LT_SIDE, 3)).astype(np.float32)
    img2 = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.float32)
    for preset in ("clip-ViT-B/16", "siglip-ViT-SO400M-14"):
        tower = _lt_random(learned.clip_vision_model(preset), 41)
        sd = tower.state_dict()
        want = learned.calculate_clipscore(img, img2, sd, model=tower, device="cpu")
        size = tower.image_size
        x_cpu = learned._nearest_torch(torch.from_numpy(img).permute(2, 0, 1)[None] / 255,
                                       size)
        with torch.no_grad():
            f_cpu = tower(x_cpu)
        card = tower.cuda()
        got = learned.calculate_clipscore(img, img2, card.state_dict(), model=card,
                                          device="cuda")
        with torch.no_grad():
            f_card = card(x_cpu.cuda()).cpu()
        err = (f_card - f_cpu).abs().max().item() / f_cpu.abs().max().item()
        score_err = abs(got - want) / abs(want)
        log(f"[long_tail] {preset} at {size}: embedding card vs CPU "
            f"{err:.2e}, CLIPScore {got:.6f} vs {want:.6f} ({score_err:.2e}; "
            f"tol {LT_MODEL_TOL:.0e})")
        if not (err <= LT_MODEL_TOL and score_err <= LT_MODEL_TOL):
            raise AssertionError(f"[long_tail] {preset} disagrees card vs CPU")
        csd = card.state_dict()
        timed[preset] = _lt_rate(
            f"{preset} CLIPScore_pt, {LT_IMAGES} image pairs (images/s)",
            lambda: learned.calculate_clipscore_pt(imgs, imgs2, csd, model=card),
            LT_IMAGES, smi)
        del tower, card, csd, sd
        torch.cuda.empty_cache()
    # CLIPA bigG-336: ~1.8 G parameters, built and drawn on the card
    t0 = time.perf_counter()
    with torch.device("cuda"):
        big = learned.clip_vision_model("clipa-ViT-bigG-14")
    init_weights(big, torch.Generator(device="cuda").manual_seed(42))
    big.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in big.parameters())
    log(f"[long_tail] CLIPA bigG-336 built on the card: {n_params / 1e9:.3f} G "
        f"parameters in {time.perf_counter() - t0:.1f} s")
    bsd = big.state_dict()
    timed["clipa-ViT-bigG-14"] = _lt_rate(
        f"clipa-ViT-bigG-14 CLIPScore_pt, {LT_IMAGES} image pairs (images/s)",
        lambda: learned.calculate_clipscore_pt(imgs, imgs2, bsd,
                                               "clipa-ViT-bigG-14", model=big),
        LT_IMAGES, smi)
    timed["clipa_params"] = n_params
    del big, bsd
    torch.cuda.empty_cache()
    return timed


def long_tail_pt_vs_host(smi):
    """The _pt metrics on the card against the host float64 metrics on 12
    images of 256^2; records the difference and both times, changes
    nothing. The _pt cPSNR keeps the reference's 255^2 numerator on [0, 1]
    images, 20 log10(255) dB above the host's: that offset is taken off
    before the comparison."""
    from srbh_tpu_torch.metrics import image

    rng = np.random.default_rng(15)
    hr = rng.uniform(0, 1, (LT_IMAGES, LT_SIDE, LT_SIDE, 3))
    sr = np.clip(hr + rng.normal(0, 0.05, hr.shape), 0, 1)
    x = torch.tensor(sr.transpose(0, 3, 1, 2), dtype=torch.float32).cuda()
    y = torch.tensor(hr.transpose(0, 3, 1, 2), dtype=torch.float32).cuda()
    out = {}
    for metric in ("psnr", "ssim", "cpsnr"):
        host_fn = getattr(image, f"calculate_{metric}")
        pt_fn = getattr(image, f"calculate_{metric}_pt")
        t0 = time.perf_counter()
        host = np.array([host_fn(a * 255, b * 255) for a, b in zip(sr, hr)])
        host_s = time.perf_counter() - t0
        if metric == "cpsnr":  # the _pt form pools its batch: one image each
            pt = torch.cat([pt_fn(x[i:i + 1], y[i:i + 1])[None]
                            for i in range(LT_IMAGES)])
        else:
            pt = pt_fn(x, y)
        pt = pt.cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt_fn(x, y)
        torch.cuda.synchronize()
        pt_s = time.perf_counter() - t0
        if metric == "cpsnr":  # the reference's 255^2 numerator on [0, 1]
            pt = pt - 20 * np.log10(255.0)
        diff = float(np.abs(pt - host).max())
        out[metric] = {"max_abs_diff": diff, "host_s": host_s, "pt_s": pt_s}
        log(f"[long_tail] {metric} of {LT_IMAGES} images of {LT_SIDE}^2: _pt on "
            f"the card vs host float64: largest difference {diff:.3e}; host "
            f"{host_s:.3f} s, _pt {1e3 * pt_s:.3f} ms ({smi})")
    return out


def phase_long_tail(wa, smi):
    """Phase 10: the remaining models, losses and metrics."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wa.window_attention.launches = 0
    timed = {"models_card_vs_cpu": long_tail_models_card_vs_cpu(),
             "losses_card_vs_cpu": long_tail_losses_card_vs_cpu(),
             "towers_card_vs_cpu": long_tail_towers_card_vs_cpu()}
    timed["card_vs_cpu_s"] = time.perf_counter() - t_phase
    timed["full_width"] = long_tail_full_width(smi)
    timed["learned"] = long_tail_learned(smi)
    timed["pt_vs_host"] = long_tail_pt_vs_host(smi)
    timed["launches"] = wa.window_attention.launches
    timed["phase_s"] = time.perf_counter() - t_phase
    log(f"[long_tail] window_attention launches: {timed['launches']}; phase "
        f"{timed['phase_s']:.1f} s")
    return timed


GAN_BATCH, GAN_LQ, GAN_PAIRS, GAN_EVAL_PAIRS = 12, 64, 72, 12
# the GAN step card vs CPU: the tolerances of tests/test_torch_gan_step.py
GAN_TOL, GAN_SN_TOL, GAN_EMA_TOL = 1e-4, 1e-5, 1e-6
# G and D parameters beyond 1e-4 per step card vs CPU: share of elements
GAN_PARAM_SHARE = 0.005


def write_pairs(root, n):
    """``n`` synthetic SR pairs with the port's writer: LR Sentinel-2 RGB
    uint16 (64, 64, 3), HR GoogleEarth uint8 (256, 256, 3), a list and the
    LR min-max table (the HR side takes the (0, 255) default)."""
    from srbh_tpu_torch.data.tiff import write_tiff

    rng = np.random.default_rng(8)
    for d in ("s2p", "gep"):
        os.makedirs(os.path.join(root, d))
    names = [f"p_{i}.tif" for i in range(n)]
    yy, xx = np.mgrid[:4 * GAN_LQ, :4 * GAN_LQ]
    for i, name in enumerate(names):
        # smooth HR content with edges (so USM has something to sharpen),
        # the LR its 4x block mean in DNs
        hr = np.stack([128 + 100 * np.sin((xx + 7 * i) / (9.0 + c)) *
                       np.cos(yy / (13.0 + i % 5)) for c in range(3)], -1)
        hr = np.clip(hr + rng.normal(0, 6, hr.shape), 0, 255).astype(np.uint8)
        lr = hr.reshape(GAN_LQ, 4, GAN_LQ, 4, 3).mean((1, 3)) * 10
        write_tiff(os.path.join(root, "s2p", name), lr.astype(np.uint16),
                   (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0))
        write_tiff(os.path.join(root, "gep", name), hr,
                   (500000.0, 2.5, 0.0, 4649776.0, 0.0, -2.5))
    for listname, rows in (("train.csv", names), ("eval.csv", names[:GAN_EVAL_PAIRS])):
        with open(os.path.join(root, listname), "w") as f:
            f.writelines(f"{name}\n" for name in rows)
    np.savetxt(os.path.join(root, "s2p_minmax.txt"),
               np.stack([np.zeros(3), np.full(3, 2550.0)]))


def gan_snapshot(state):
    """Host copies of what a GAN step changes: G, its EMA, D (with the
    spectral norms' u) and each norm's sigma."""
    return ({k: v.detach().cpu().clone() for k, v in state.net_g.state_dict().items()},
            {k: v.detach().cpu().clone() for k, v in state.g_ema.state_dict().items()},
            {k: v.detach().cpu().clone() for k, v in state.net_d.state_dict().items()},
            {i: state.net_d.sn_convs()[i].sigma.item() for i in range(8)})


def gan_tiny_card_vs_cpu(remat=False):
    """Two GAN steps of the tiny configuration (NF 8, GC 4, one RRDB, D
    width 8, VGG19 perceptual, batch 2, lq 8 -> gt 32) on the card and on
    the CPU from the same seeded weights and batches; ``remat`` recomputes
    the generator's RRDBs in the backward pass."""
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer

    rng = np.random.default_rng(9)
    batches = [(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
                rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        tr = RealESRGANTrainer(num_block=1, num_feat=8, num_grow_ch=4, disc_feat=8,
                               remat=remat)
        state = tr.init(0, (2, 8, 8, 3), device=dev)
        step = tr.make_step()
        rows = []
        for lq, gt in batches:
            m = step(state, lq, gt)
            rows.append(({k: v.item() for k, v in m.items()}, gan_snapshot(state)))
        out[dev] = rows
    worst = dict(metric=0.0, u=0.0, sigma=0.0, ema=0.0)
    bad = total = 0
    for i, ((m_c, (g_c, e_c, d_c, s_c)), (m_g, (g_g, e_g, d_g, s_g))) in enumerate(
            zip(out["cpu"], out["cuda"])):
        worst["metric"] = max([worst["metric"]] + [abs(m_g[k] - v) / (1 + abs(v))
                                                   for k, v in m_c.items()])
        worst["u"] = max([worst["u"]] + [(d_g[k] - v).abs().max().item()
                                         for k, v in d_c.items() if k.endswith("weight_u")])
        worst["sigma"] = max([worst["sigma"]] + [abs(s_g[j] - s_c[j]) / max(1, abs(s_c[j]))
                                                 for j in s_c])
        worst["ema"] = max([worst["ema"]] + [(e_g[k] - v).abs().max().item()
                                             for k, v in e_c.items()])
        for a, b in ((g_g, g_c), (d_g, d_c)):
            for k, v in b.items():
                if not k.endswith(("weight_u", "weight_v")):
                    bad += int(((a[k] - v).abs() > 1e-4 * (i + 1)).sum())
                    total += v.numel()
    log(f"[gan] tiny GAN step{' (remat)' * remat} card vs CPU over 2 steps: "
        f"metrics max |a-b|/(1+|b|) "
        f"{worst['metric']:.3e} (tol {GAN_TOL:.0e}), SN u {worst['u']:.3e} and sigma "
        f"{worst['sigma']:.3e} (tol {GAN_SN_TOL:.0e}), EMA {worst['ema']:.3e} (tol "
        f"{GAN_EMA_TOL:.0e}); G and D params beyond 1e-4 per step: {bad} of {total} "
        f"(share {bad / total:.2e}, limit {GAN_PARAM_SHARE})")
    if not (worst["metric"] <= GAN_TOL and worst["u"] <= GAN_SN_TOL
            and worst["sigma"] <= GAN_SN_TOL and worst["ema"] <= GAN_EMA_TOL
            and bad / total < GAN_PARAM_SHARE):
        raise AssertionError("the tiny GAN step disagrees card vs CPU")


def check_gan_trained(state, before, last):
    """What ``train_sr`` must leave behind: finite losses, every G and D
    parameter moved, the EMA apart from G, every spectral norm's u moved."""
    g0, e0, d0, _ = before
    g1, e1, d1, _ = gan_snapshot(state)
    finite = all(np.isfinite(v) for v in last.values())
    still_g = [k for k, v in g1.items() if torch.equal(v, g0[k])]
    still_d = [k for k, v in d1.items() if not k.endswith("weight_v")
               and torch.equal(v, d0[k])]
    ema_eq_g = [k for k, v in e1.items() if torch.equal(v, g1[k])]
    log(f"[gan] after train_sr: losses {last}; G tensors unmoved {len(still_g)} "
        f"of {len(g1)}, D tensors (u included) unmoved {len(still_d)} of "
        f"{len(d1) - 8}, EMA tensors equal to G {len(ema_eq_g)}")
    if not finite or still_g or still_d or ema_eq_g:
        raise AssertionError(f"GAN training: finite {finite}, unmoved "
                             f"{(still_g + still_d)[:5]}, EMA = G {ema_eq_g[:5]}")


def check_gan_reload(trainer, state, logdir):
    """``net_g`` through ``load_sr_generator`` and ``net_d`` through its
    state dict, into a state of other seeded weights: identical."""
    from srbh_tpu_torch.train.sr_driver import load_sr_generator

    fresh = trainer.init(1, (GAN_BATCH, GAN_LQ, GAN_LQ, 3), device="cuda")
    load_sr_generator(trainer, logdir, fresh)
    fresh.net_d.load_state_dict(torch.load(os.path.join(logdir, "net_d"),
                                           map_location="cuda", weights_only=True)["params"])
    diff = [f"{name} {k}" for name, a, b in (("net_g", fresh.net_g, state.net_g),
                                             ("ema", fresh.g_ema, state.g_ema),
                                             ("net_d", fresh.net_d, state.net_d))
            for (k, v), w in zip(a.state_dict().items(), b.state_dict().values())
            if not torch.equal(v, w)]
    log(f"[gan] net_g / net_d reload into a fresh state: {len(diff)} tensors differ")
    if diff:
        raise AssertionError(f"SR checkpoints do not reload identically: {diff[:5]}")


def time_gan_steps(smi):
    """tiles/s of the full-width GAN step alone on batches already on the
    card, through ``tools/sr_train_bench.py``'s ``main`` (the step turns
    cuDNN's autotuning on for itself): bfloat16 and float32, then float32
    with each RRDB recomputed in the backward pass (``SRBH_SR_REMAT``, a
    layout option of phase 14's, timed here beside the plain step and
    after the GAN shapes' autotuning), peak memory and the device time by
    kernel of one step each."""
    from srbh_tpu_torch.tools import sr_train_bench

    results = {}
    for remat, dtypes in (("", ["bfloat16", "float32"]), (" remat", ["float32"])):
        os.environ["SRBH_SR_REMAT"] = "1" if remat else ""
        for rec in run_tool("gan", sr_train_bench.main, [
                "--batch", str(GAN_BATCH), "--dtype", *dtypes,
                "--repeats", "3", "--steps", "2"], smi):
            results[rec["dtype"] + remat] = dict(
                tiles_per_s=rec["value"], ms_per_step=rec["median_ms"],
                peak_gib=rec["peak_gib"], idle_share=rec["idle_share"],
                busy_ms=rec["busy_ms"])
            for ms, key in rec["kernels"][:8 if not remat else 4]:
                log(f"[gan]   {rec['dtype']}{remat}: {ms:9.3f} ms "
                    f"{100 * ms / rec['busy_ms']:5.1f}%  {key[:90]}")
    os.environ.pop("SRBH_SR_REMAT")
    return results


def phase_gan(wa, smi):
    """The Real-ESRGAN finetune at the recipe's width through ``train_sr``
    and ``eval_sr``."""
    from srbh_tpu_torch.data.dataset import LRHRPairDataset
    from srbh_tpu_torch.train.sr_driver import eval_sr, train_sr
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer

    torch.cuda.empty_cache()
    log(f"[gan] memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    t_phase = time.perf_counter()
    gan_tiny_card_vs_cpu()
    timed = {"tiny_card_vs_cpu_s": time.perf_counter() - t_phase}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_pairs(root, GAN_PAIRS)
        timed["write_pairs_s"] = time.perf_counter() - t0
        pairs = lambda listname, aug: LRHRPairDataset(
            os.path.join(root, listname), root, root, s2dir="s2p", gedir="gep",
            aug=aug)
        # the recipe: RRDBNet-23 (nf 64, gc 32), UNetDiscriminatorSN nf 64,
        # VGG19 perceptual, float32
        trainer = RealESRGANTrainer()
        t0 = time.perf_counter()
        state = trainer.init(0, (GAN_BATCH, GAN_LQ, GAN_LQ, 3), device="cuda")
        timed["init_s"] = time.perf_counter() - t0
        before = gan_snapshot(state)
        stamps, last = [], {}
        inner = trainer.make_step
        skip, n_steps = 2, GAN_PAIRS // GAN_BATCH  # skip: the loader's workers start

        def timed_make_step():
            """The step, stamped on the host clock as each call returns. The
            steady-state window's two ends (steps ``skip`` and the last)
            synchronise; the steps between run at ``train_sr``'s own pace,
            which waits for the card only at its log lines."""
            step = inner()

            def timed_step(state, lq, gt):
                m = step(state, lq, gt)
                if len(stamps) + 1 in (skip, n_steps):
                    torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                last.update(m)
                return m

            return timed_step

        trainer.make_step = timed_make_step
        logdir = os.path.join(root, "sr")
        wa.window_attention.launches = 0
        t0 = time.perf_counter()
        state = train_sr(trainer, pairs("train.csv", True), logdir, epochs=1,
                         batch_size=GAN_BATCH, num_workers=4, seed=0, state=state,
                         log_every=4, device="cuda")
        timed["train_sr_s"] = time.perf_counter() - t0
        del trainer.make_step
        t0 = time.perf_counter()
        res = eval_sr(trainer, state, pairs("eval.csv", False),
                      txtpath=os.path.join(root, "acc1.txt"), batch_size=8,
                      device="cuda")
        timed["eval_s"] = time.perf_counter() - t0
        launches = wa.window_attention.launches
        lines = open(os.path.join(root, "acc1.txt")).read().splitlines()
        last = {k: v.item() for k, v in last.items()}
        timed["steps"] = len(stamps)
        timed["train_sr_ms_per_step"] = 1e3 * (stamps[-1] - stamps[skip - 1]) / (
            len(stamps) - skip)
        timed["eval_images_per_s"] = GAN_EVAL_PAIRS / timed["eval_s"]
        log(f"[gan] train_sr, RRDBNet-23 + UNetDiscriminatorSN + VGG19, batch "
            f"{GAN_BATCH}, lq {GAN_LQ} -> gt {4 * GAN_LQ}, float32, {GAN_PAIRS} "
            f"pairs = {len(stamps)} steps: {timed['train_sr_s']:.2f} s wall, "
            f"{timed['train_sr_ms_per_step']:.1f} ms per step in steady state "
            f"(steps {skip + 1}..{len(stamps)}, 4 loader processes); eval_sr of "
            f"{GAN_EVAL_PAIRS} pairs {timed['eval_s']:.2f} s = "
            f"{timed['eval_images_per_s']:.2f} images/s, {res}; acc1.txt {lines}; "
            f"window_attention launches over train_sr and eval_sr: {launches}; {smi}")
        if len(stamps) != n_steps or state.step != n_steps:
            raise AssertionError(f"train_sr took {len(stamps)} steps")
        if len(lines) != 6 or lines[0] != "psnr, ssim" or not np.isfinite(
                [res["psnr"], res["ssim"], res["cpsnr"]]).all():
            raise AssertionError(f"eval_sr: {res}, {lines}")
        check_gan_trained(state, before, last)
        t0 = time.perf_counter()
        check_gan_reload(trainer, state, logdir)
        timed["reload_check_s"] = time.perf_counter() - t0
        del state, trainer, before
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    timed["steps_alone"] = time_gan_steps(smi)
    timed["steps_alone_s"] = time.perf_counter() - t0
    timed["phase_s"] = time.perf_counter() - t_phase
    log(f"[gan] phase {timed['phase_s']:.1f} s; cudnn.benchmark after it: "
        f"{torch.backends.cudnn.benchmark}")
    if torch.backends.cudnn.benchmark:
        raise AssertionError("the GAN step left cudnn.benchmark on")
    return {"launches": launches, **timed}


TOOLS_CITY_SIDE = 1024  # predict_stress in phase 11 (phase 7 keeps 2048)
EXPORT_BATCHES = (3, CITY_BATCH)  # one symbolic-batch artifact serves both
BENCH_AGREE = 0.10  # the bench's flagship rate against profile_flagship's full
# a tool's host-clock step time against the same repeats on the card's clock
# (CUDA events) and against the device busy time of one profiled step
TIMER_AGREE = 0.10
MFU_MAX = 1.05


def run_tool(tag, tool_main, argv, smi):
    """Run a tool's ``main(argv)`` once, echo a short line for each JSON
    record it prints, check what every record must hold (this card's name;
    finite, positive rates; ``mfu`` in (0, 1.05]) and return the records."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tool_main(argv)
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in buf.getvalue().splitlines()
               if line.startswith("{")]
    name = torch.cuda.get_device_name(0)
    if not records:
        raise AssertionError(f"{tool_main.__module__} printed no record")
    for rec in records:
        short = {k: rec[k] for k in ("metric", "mode", "num_workers", "stitcher",
                                     "dtype", "batch", "value", "unit",
                                     "median_ms", "q1_ms", "q3_ms", "repeats",
                                     "mfu", "peak_gib", "idle_share")
                 if rec.get(k) is not None}
        log(f"[{tag}] {rec['tool']} {json.dumps(short)}")
        if rec["device"] != name or rec["power_limit"] != smi:
            raise AssertionError(f"{rec['tool']} names {rec['device']!r}, "
                                 f"{rec['power_limit']!r}: not this card")
        for key in ("value", "median_ms", "tflop_per_s", "mfu", "repeats"):
            v = rec.get(key, 1)
            if v is None or not (math.isfinite(v) and v > 0):
                raise AssertionError(f"{rec['tool']} {key} = {v}")
        if rec.get("mfu") is not None and rec["mfu"] > MFU_MAX:
            raise AssertionError(f"{rec['tool']} mfu {rec['mfu']} > {MFU_MAX}")
        check_timers(tag, rec)
    log(f"[{tag}] {tool_main.__module__}.main {' '.join(argv)}: {wall:.1f} s; {smi}")
    return records


def check_timers(tag, rec):
    """Hold a record's host-clock step time (``median_ms``) against a timer
    that does not read the host's clock: the same repeats timed by CUDA
    events (``event_ms``), within ``TIMER_AGREE``; and no step shorter than
    the card's busy time in one profiled step (``busy_ms``). A record
    without those keys passes."""
    med, ev, busy = rec.get("median_ms"), rec.get("event_ms"), rec.get("busy_ms")
    if med is None or ev is None:
        return
    log(f"[{tag}] {rec['tool']} {rec.get('dtype', '')} timers: host {med:.3f} ms, "
        f"card's clock {ev:.3f} ms (ratio {med / ev:.3f}), device busy "
        + ("not profiled" if busy is None else f"{busy:.3f} ms (busy / host "
           f"{busy / med:.3f})"))
    if abs(med / ev - 1) > TIMER_AGREE:
        raise AssertionError(f"{rec['tool']}: host {med} ms against CUDA events {ev} ms")
    if busy is not None and busy > (1 + TIMER_AGREE) * med:
        raise AssertionError(f"{rec['tool']}: a step of {med} ms, but the card "
                             f"was busy {busy} ms in one")


def check_convs_seen(rec):
    """The ``tools/_trace.py`` guard's counts in a record: every conv module
    of the path ran in the timed step, and the profiler saw each call (and
    as many calls made with a module's weights as the reference made: the
    packed and int8 layouts) and tied device time to each."""
    c = rec["convs"]
    log(f"[tools] {rec['tool']} {rec.get('dtype', '')} conv guard: {json.dumps(c)}")
    if not (c["modules_called"] == c["conv_modules"]
            and c["profiled_on_device"] == c["profiled_convs"]
            == c["conv_calls"] + c["reference_unhooked"]
            and c["conv_calls"] >= c["conv_modules"]):
        raise AssertionError(f"{rec['tool']}: the guard missed convolutions: {c}")


def quantised_close(label, got, want):
    d = (got.int() - want.int()).abs()
    share = (d > 0).float().mean().item()
    log(f"[tools] {label}: max LSB diff {d.max().item()}, share differing "
        f"{share:.2e}")
    if d.max().item() > 1 or share > QUANT_SHARE:
        raise AssertionError(f"{label}: beyond 1 LSB on {QUANT_SHARE} of pixels")


def tools_export(root, model, sr, smi):
    """``tools/export_model.py``'s ``main`` on the full-width flagship's
    weights: float32 with a symbolic batch, loaded back and held to the
    eager step at batch 3 and 32 (``EXPORT_BATCHES``). The bfloat16 form
    is held to the eager step in the CPU tests
    (``tests/test_torch_export.py``)."""
    from srbh_tpu_torch.tools import export_model

    dev = next(model.parameters()).device
    ckpt, sr_ckpt = os.path.join(root, "model.pt"), os.path.join(root, "sr.pt")
    path = os.path.join(root, "flagship.pt2")
    torch.save(model.state_dict(), ckpt)
    torch.save(sr.state_dict(), sr_ckpt)
    t0 = time.perf_counter()
    export_model.main([path, "--dtype", "float32", "--ckpt", ckpt,
                       "--sr-ckpt", sr_ckpt])
    fn = export_model.load_exported(path)
    out = {"export_s": time.perf_counter() - t0,
           "export_mb": os.path.getsize(path) / 1e6}
    gen = torch.Generator(device=dev).manual_seed(11)
    for n in EXPORT_BATCHES:
        x = torch.rand((n, 64, 64, 8), generator=gen, device=dev)
        with torch.no_grad():
            got = fn(x)
        with torch.inference_mode():
            want = export_model.Serving(model, sr, torch.float32)(x)
        for k, g, w in zip(("height", "build"), got[:2], want[:2]):
            err = ((g - w).abs() / (1 + w.abs())).max().item()
            log(f"[tools] export float32, batch {n}, {k}: max |a-b|/(1+|b|) "
                f"{err:.3e} (tol {FLAGSHIP_TOL:.0e})")
            if not err <= FLAGSHIP_TOL:
                raise AssertionError(f"export {k} disagrees at batch {n}")
        for k, g, w in zip(("height u16", "build u8"), got[2:], want[2:]):
            quantised_close(f"export float32 batch {n} {k}", g, w)
    log(f"[tools] export float32: {out['export_s']:.1f} s (export, save, "
        f"load), {out['export_mb']:.1f} MB; {smi}")
    return out


def tools_convert(root, model, sr):
    """``python -m srbh_tpu_torch.convert``'s ``main`` on a full-width height
    checkpoint in the JAX package's npz form: the file it writes, loaded
    with ``strict=True`` into a model of other weights, gives the step
    output of the state it came from."""
    from srbh_tpu_torch import convert
    from srbh_tpu_torch.predict.predictor import make_city_step

    dev = next(model.parameters()).device
    tree = convert.height_model_variables(model.state_dict())
    tree["log_vars"] = {"w1": np.float32(0.25), "w2": np.float32(-0.5),
                        "w3": np.float32(0.75)}
    tree["meta"] = {"epoch": np.int32(20), "best_acc": np.float32(3.25)}
    npz, out = os.path.join(root, "height.npz"), os.path.join(root, "checkpoint20")
    convert.save_tree_npz(npz, tree)
    convert.main([npz, out, "--arch", "height"])
    payload = torch.load(out, map_location="cpu", weights_only=True)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for t in fresh.state_dict().values():
            if t.is_floating_point():
                t.uniform_(-1, 1)
    fresh.load_state_dict(payload["state_dict"], strict=True)
    lv = torch.cat(payload["log_vars"]).tolist()
    if (payload["epoch"], payload["best_acc"], lv) != (20, 3.25, [0.25, -0.5, 0.75]):
        raise AssertionError(f"converted bookkeeping {payload['epoch']} "
                             f"{payload['best_acc']} {lv}")
    x = torch.rand((CITY_BATCH, 64, 64, 8), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(12))
    got = make_city_step(fresh, sr, dtype=torch.float32, device=dev)(x)
    want = make_city_step(model, sr, dtype=torch.float32, device=dev)(x)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"[tools] convert --arch height: {os.path.getsize(npz) / 1e6:.1f} MB "
        f"npz -> {os.path.getsize(out) / 1e6:.1f} MB file; strict load; step "
        f"outputs equal: {same}; epoch {payload['epoch']}, best_acc "
        f"{payload['best_acc']}, log_vars {lv}")
    if not same:
        raise AssertionError("the converted checkpoint's step differs")


def phase_tools(wa, smi, flagship):
    """Phase 11: each measurement and serving tool's ``main`` once at full
    width and short length (the bench, ``train_bench`` and
    ``sr_train_bench`` run in phases 5, 6 and 9; ``flagship`` holds phase
    5's bench records), their records checked."""
    from srbh_tpu_torch import entry
    from srbh_tpu_torch.tools import (
        composed_bench,
        conv_microbench,
        loader_bench,
        predict_stress,
        profile_flagship,
        ref_bench,
        train_diag,
    )

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wa.window_attention.launches = 0
    out = {}
    rec = run_tool("tools", profile_flagship.main, [
        "--batch", str(CITY_BATCH), "--dtype", "float32", "--repeats", "3",
        "--stages", ",".join(profile_flagship.PARTS + ("full",))], smi)[0]
    for k, v in rec["stages"].items():
        if not (v["median_ms"] and v["median_ms"] > 0):
            raise AssertionError(f"profile_flagship {k}: {v}")
    log(f"[tools] profile_flagship float32 ms: "
        + ", ".join(f"{k} {v['median_ms']:.3f} ({v['timer']})"
                    for k, v in rec["stages"].items())
        + f"; sum of parts {rec['sum_of_parts_ms']:.3f}")
    out["profile_ms"] = {k: v["median_ms"] for k, v in rec["stages"].items()}
    bench_f32 = next(r for r in flagship if r["dtype"] == "float32")
    ratio = bench_f32["value"] / rec["full_tiles_per_sec"]
    out["bench_float32_vs_profile_full"] = ratio
    log(f"[tools] bench float32 (phase 5) {bench_f32['value']:.2f} tiles/s, "
        f"profile_flagship full {rec['full_tiles_per_sec']:.2f}: ratio {ratio:.3f}")
    if abs(ratio - 1) > BENCH_AGREE:
        raise AssertionError("the bench and profile_flagship's full stage disagree")
    rec = run_tool("tools", conv_microbench.main, ["--batch", str(CITY_BATCH)], smi)[0]
    for k, v in rec["cases"].items():
        log(f"[tools] conv_microbench {k}: {v['ms_per_conv']:.4f} ms/conv, "
            f"{v['tflop_per_s']:.2f} TFLOP/s")
        if not (v["ms_per_conv"] > 0 and math.isfinite(v["tflop_per_s"])):
            raise AssertionError(f"conv_microbench {k}: {v}")
    for rec in run_tool("tools", train_diag.main, ["--batch", str(TRAIN_BATCH),
                                                   "--repeats", "3"], smi):
        log(f"[tools] train_diag batch {rec['batch']}: sr {rec['sr_fwd_ms']:.2f}, "
            f"fwd {rec['loss_fwd_ms']:.2f}, step {rec['step_ms']:.2f} ms, "
            f"allocated {rec['max_memory_allocated_gib']:.2f} GiB, reserved "
            f"{rec['max_memory_reserved_gib']:.2f} GiB")
        if not 0 < rec["sr_fwd_ms"] < rec["step_ms"]:
            raise AssertionError(f"train_diag: {rec}")
    run_tool("tools", loader_bench.main, ["--tiles", "128", "--epochs", "1",
                                          "--workers", "0", "4"], smi)
    recs = run_tool("tools", composed_bench.main, [
        "--batch", str(TRAIN_BATCH), "--tiles", "64", "--workers", "4",
        "--epochs", "1"], smi)
    if not recs[0]["device_equals_device_norm"]:
        raise AssertionError("composed_bench: device != device_norm batches")
    recs = run_tool("tools", predict_stress.main, ["--size", str(TOOLS_CITY_SIDE),
                                                   "--batch", str(CITY_BATCH)], smi)
    ran = [r["stitcher"] for r in recs if r["metric"] == "stress_predict_wallclock"]
    eq = recs[-1]
    if ran != ["device", "host"] or not (eq["build_equal"] and eq["height_equal"]):
        raise AssertionError(f"predict_stress: stitchers {ran}, {eq}")
    dev_rec = recs[1]  # the city path's device time (phase 7 profiles none)
    if dev_rec["idle_share"] is None:
        raise AssertionError("predict_stress: the profiler saw no device time")
    out["city_idle_share"] = dev_rec["idle_share"]
    log(f"[tools] predict_city, device stitch, {TOOLS_CITY_SIDE}x{TOOLS_CITY_SIDE} "
        f"city, batch {CITY_BATCH}, bfloat16, under the profiler: device busy "
        f"{dev_rec['busy_ms']:.1f} ms, idle share {dev_rec['idle_share']:.3f}")
    for ms, key in dev_rec["kernels"][:6]:
        log(f"[tools]   {ms:9.3f} ms {100 * ms / dev_rec['busy_ms']:5.1f}%  {key[:90]}")
    rec = run_tool("tools", ref_bench.main, ["--repeats", "3"], smi)[0]
    check_convs_seen(rec)
    model, sr, _ = entry.flagship(device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as root:
        out.update(tools_export(root, model, sr, smi))
        tools_convert(root, model, sr)
    del model, sr
    torch.cuda.empty_cache()
    out["launches"] = wa.window_attention.launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tools] phase {out['phase_s']:.1f} s; window_attention launches: "
        f"{out['launches']}")
    return out


# phase 12: the preparation path on the card's machine. A raw city of
# PREP_SIDE x PREP_SIDE source pixels at 10 m in EPSG:32650 (5.12 km: a
# district, a quarter of phase 7's side, so that the phase stays within a
# minute), two WSF tiles in EPSG:4326, PREP_BUILDINGS footprints (some with a
# courtyard hole, some of two parts, some crossing the raster's edge), and
# PREP_TILES training tiles cut from it (an 8 x 8 grid of 64 x 64); the stats
# tables held to a float64 recomputation within PREP_STATS_TOL (relative).
# The host blend is timed at phase 7's tile shapes (batch 16 of 256 x 256, 7
# classes) on a BLEND_CANVAS^2 canvas, BLEND_REPEATS batches each way.
PREP_SIDE, PREP_BUILDINGS, PREP_TILES, PREP_STATS_TOL = 512, 400, 64, 1e-12
PREP_EPSG, WSF_EPSG, WSF_RES = 32650, 4326, 1e-4
BLEND_BATCH, BLEND_CANVAS, BLEND_REPEATS = 16, 4096, 6


def _rectangle(cx, cy, w, h, angle, clockwise=True):
    """A closed rectangular ring about (cx, cy), rotated by ``angle``."""
    c, s = math.cos(angle), math.sin(angle)
    corners = [(-w / 2, h / 2), (w / 2, h / 2), (w / 2, -h / 2), (-w / 2, -h / 2)]
    if not clockwise:
        corners = corners[::-1]
    ring = [(cx + x * c - y * s, cy + x * s + y * c) for x, y in corners]
    return np.array(ring + ring[:1], float)


def write_raw_city(citydir, raw, city, rng):
    """Phase 12's raw inputs: S2 (6-band uint16, PackBits) and S1 (2-band
    float32) of ``city`` in ``citydir``, two WSF tiles in EPSG:4326 and a
    footprint shapefile with a floors field in ``raw``. Returns the S2
    array, the S1 array, the WSF tile paths and the footprint path."""
    from srbh_tpu_torch.data import crs
    from srbh_tpu_torch.data.shapefile import ShapeRecord, write_shapefile
    from srbh_tpu_torch.data.tiff import write_tiff

    side = PREP_SIDE
    keys = crs.geokeys_for_epsg(PREP_EPSG)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    s2 = rng.integers(0, 5000, (side, side, 6), dtype=np.uint16)
    s1 = rng.uniform(-25, 5, (side, side, 2)).astype(np.float32)
    write_tiff(os.path.join(citydir, f"{city}_s2.tif"), s2, gt,
               compress="PACKBITS", geo_keys=keys)
    write_tiff(os.path.join(citydir, f"{city}_s1.tif"), s1, gt, geo_keys=keys)
    bounds = (gt[0], gt[3] - 10.0 * side, gt[0] + 10.0 * side, gt[3])
    lon0, lat0, lon1, lat1 = crs.transform_bounds(PREP_EPSG, WSF_EPSG, bounds)
    x0 = math.floor(lon0 / WSF_RES - 20) * WSF_RES
    y0 = math.ceil(lat1 / WSF_RES + 20) * WSF_RES
    w = int(math.ceil((lon1 - x0) / WSF_RES)) + 20
    h = int(math.ceil((y0 - lat0) / WSF_RES)) + 20
    lon = x0 + (np.arange(w) + 0.5) * WSF_RES
    lat = y0 - (np.arange(h) + 0.5) * WSF_RES
    mx, my = (lon0 + lon1) / 2, (lat0 + lat1) / 2
    rx, ry = (lon1 - lon0) / 2.5, (lat1 - lat0) / 2.5
    built = ((lon[None] - mx) / rx) ** 2 + ((lat[:, None] - my) / ry) ** 2 <= 1
    # speckle, too sparse to make a cell valid on its own
    built |= rng.random((h, w)) < 0.002
    wsf = built.astype(np.uint8) * 255
    tiles, mid = [], w // 2
    for name, a, b in (("west", 0, mid + 10), ("east", mid - 10, w)):
        path = os.path.join(raw, f"wsf_{name}.tif")
        write_tiff(path, wsf[:, a:b], (x0 + a * WSF_RES, WSF_RES, 0.0, y0, 0.0,
                                       -WSF_RES),
                   geo_keys=crs.geokeys_for_epsg(WSF_EPSG))
        tiles.append(path)
    records = []
    for i in range(PREP_BUILDINGS):
        cx = rng.uniform(bounds[0] - 30, bounds[2] + 30)
        cy = rng.uniform(bounds[1] - 30, bounds[3] + 30)
        bw, bh = rng.uniform(8, 60, 2)
        angle = rng.uniform(0, math.pi)
        rings = [_rectangle(cx, cy, bw, bh, angle)]
        if i % 10 == 0 and min(bw, bh) > 24:  # a courtyard
            rings.append(_rectangle(cx, cy, bw / 2, bh / 2, angle, False))
        if i % 10 == 1:  # a second part along the first's long axis
            d = bw + 12.0
            rings.append(_rectangle(cx + d * math.cos(angle),
                                    cy + d * math.sin(angle), bw, bh, angle))
        pts = np.concatenate(rings)
        records.append(ShapeRecord(
            (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()),
            {"floors": int(rng.integers(1, 31))}, rings=rings))
    footprints = os.path.join(raw, "footprints.shp")
    write_shapefile(footprints, records, [("floors", "N", 10, 0)],
                    prj_wkt=crs.wkt_for_epsg(PREP_EPSG))
    return s2, s1, tiles, footprints


def _tile_stats(arrays):
    """The float64 per-band tables of a list of (H, W, C) tiles, computed
    here as stats_dataset_globe.py defines them: per tile min, max, mean and
    std; the mean of means, sqrt(E[std^2 + mean^2] - mean^2), and the 2 %
    / 98 % percentiles of the tiles' minima / maxima."""
    a = np.stack([t.astype(np.float64) for t in arrays])  # (n, H, W, C)
    mins, maxs = a.min((1, 2)), a.max((1, 2))
    means, stds = a.mean((1, 2)), a.std((1, 2))
    mean_all = means.mean(0)
    std_all = np.sqrt((stds * stds + means * means).mean(0) - mean_all ** 2)
    return (np.stack([mean_all, std_all]),
            np.stack([np.percentile(mins, 2, axis=0),
                      np.percentile(maxs, 98, axis=0)]))


def _close(label, got, want, tol):
    err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
    if not err <= tol:
        raise AssertionError(f"{label}: relative error {err:.3e} > {tol:.0e}")
    return err


def prepare_tiles(root, city, s2, s1, heights_dm, timed):
    """Step 6 and 7: PREP_TILES tiles (S2, S1, uint8 heights in metres)
    under ``root``, ``generate_allfile`` and ``split_data`` (held to
    ``RandomState(1).permutation``), then ``main_stats`` and
    ``height_histogram`` into ``root/stats`` (held to a float64
    recomputation and read back by ``load_stats_table``). Returns the
    stats directory."""
    from srbh_tpu_torch.data import datalist, stats
    from srbh_tpu_torch.data.tiff import write_tiff
    from srbh_tpu_torch.ops.normalize import load_stats_table

    n_side = int(math.isqrt(PREP_TILES))
    step = PREP_SIDE // n_side
    for d in ("s2x", "s1x", "bhx"):
        os.makedirs(os.path.join(root, d))
    names, parts = [], {"s2x": [], "s1x": [], "bhx": []}
    for r in range(n_side):
        for c in range(n_side):
            name = f"{city}_{r}_{c}.tif"
            names.append(name)
            win = np.s_[r * step: r * step + 64, c * step: c * step + 64]
            hwin = np.s_[4 * r * step: 4 * (r * step + 64),
                         4 * c * step: 4 * (c * step + 64)]
            tiles = {"s2x": s2[win], "s1x": s1[win],
                     "bhx": np.minimum(heights_dm[hwin] // 10, 255
                                       ).astype(np.uint8)}
            for d, arr in tiles.items():
                write_tiff(os.path.join(root, d, name), arr)
                parts[d].append(arr if arr.ndim == 3 else arr[..., None])
    t0 = time.perf_counter()
    listpath = datalist.generate_allfile(root, "s1x", suffix=city)
    split = datalist.split_data(listpath)
    timed["datalists_s"] = time.perf_counter() - t0
    order = sorted(names)
    perm = np.random.RandomState(1).permutation(len(order))
    want = {f"datalist_{city}.csv": order}
    shuffled = [order[i] for i in perm]
    n07 = int(len(order) * 0.7)
    want[f"datalist_{city}_train_0.7.csv"] = shuffled[:n07]
    rest = shuffled[n07:]
    rest = [rest[i] for i in np.random.RandomState(1).permutation(len(rest))]
    n03 = int(len(rest) * 0.33)
    want[f"datalist_{city}_test_0.7_val_0.3.csv"] = rest[:n03]
    want[f"datalist_{city}_test_0.7_test_0.3.csv"] = rest[n03:]
    n09 = int(len(order) * 0.9)
    want[os.path.basename(split[0])] = shuffled[:n09]
    want[os.path.basename(split[1])] = shuffled[n09:]
    for listname, rows in want.items():
        got = [r[0] for r in datalist.read_rows(os.path.join(root, listname))]
        if got != rows:
            raise AssertionError(f"{listname}: not the RandomState(1) split")
    t0 = time.perf_counter()
    statsdir = os.path.join(root, "stats")
    for d, nband in (("s2x", 6), ("s1x", 2)):
        stats.main_stats(root, d, nband, statsdir)
    hist = stats.height_histogram(os.path.join(root, "bhx"), statsdir,
                                  f"bh_stats_{city}")
    timed["stats_s"] = time.perf_counter() - t0
    err = 0.0
    for d in ("s2x", "s1x"):
        meanstd, minmax = _tile_stats(parts[d])
        for kind, table in (("meanstd", meanstd), ("minmax", minmax)):
            got = load_stats_table(os.path.join(statsdir, f"{d}_{kind}.txt"))
            err = max(err, _close(f"{d}_{kind}", got, table, PREP_STATS_TOL))
    want_hist = np.bincount(np.concatenate([t.ravel() for t in parts["bhx"]]),
                            minlength=256).astype(np.float64)
    if not np.array_equal(hist, want_hist) or not np.array_equal(
            np.loadtxt(os.path.join(statsdir, f"bh_stats_{city}.txt")), want_hist):
        raise AssertionError("height histogram != its recomputation")
    jpg = os.path.exists(os.path.join(statsdir, f"bh_stats_{city}_plot.jpg"))
    timed["stats_max_rel_err"] = err
    log(f"[prepare] {len(names)} tiles; datalists {timed['datalists_s']:.2f} s "
        f"(splits equal RandomState(1).permutation); stats tables "
        f"{timed['stats_s']:.2f} s, largest relative error against float64 "
        f"{err:.2e} (limit {PREP_STATS_TOL:.0e}); histogram of {int(hist.sum())} "
        f"pixels equal; plot written: {jpg}")
    return statsdir


def native_vs_plain(s2, smi):
    """The C++ codec and blender against their plain versions, byte for
    byte: PackBits on the S2 raster's bytes, and ``add_batch`` against
    ``add_batch_plain`` at the city CLI's tile shapes; times of each."""
    from srbh_tpu_torch import native
    from srbh_tpu_torch.data import tiff
    from srbh_tpu_torch.predict.stitcher import MosaicAccumulator

    out = {}
    data = s2.tobytes()
    mb = len(data) / 1e6
    t0 = time.perf_counter()
    enc = native.packbits_encode(data)
    t1 = time.perf_counter()
    enc_plain = tiff._packbits_encode(data)
    t2 = time.perf_counter()
    dec = native.packbits_decode(enc, len(data))
    t3 = time.perf_counter()
    dec_plain = tiff._packbits_decode(enc, len(data))
    t4 = time.perf_counter()
    if enc != enc_plain or dec != data or dec_plain != data:
        raise AssertionError("native PackBits != the Python codec")
    out["packbits"] = {"mb": mb, "encode_mb_per_s": mb / (t1 - t0),
                       "encode_plain_mb_per_s": mb / (t2 - t1),
                       "decode_mb_per_s": mb / (t3 - t2),
                       "decode_plain_mb_per_s": mb / (t4 - t3)}
    log(f"[prepare] PackBits on the S2 raster ({mb:.2f} MB, {len(enc) / 1e6:.2f} "
        f"MB packed), byte-equal: encode {out['packbits']['encode_mb_per_s']:.1f} "
        f"MB/s native, {out['packbits']['encode_plain_mb_per_s']:.2f} plain; "
        f"decode {out['packbits']['decode_mb_per_s']:.1f} MB/s native, "
        f"{out['packbits']['decode_plain_mb_per_s']:.1f} plain; {smi}")
    rng = np.random.default_rng(12)
    side = BLEND_CANVAS // 4
    batches = [(rng.integers(0, 3000, (BLEND_BATCH, 256, 256), dtype=np.uint16),
                rng.integers(0, 256, (BLEND_BATCH, 256, 256, 7), dtype=np.uint8),
                np.concatenate([rng.integers(0, side - 64, (BLEND_BATCH, 2)),
                                np.full((BLEND_BATCH, 2), 64)], 1))
               for _ in range(BLEND_REPEATS)]
    tile_bytes = batches[0][0].nbytes + batches[0][1].nbytes
    acc, plain = MosaicAccumulator(side, side, 7), MosaicAccumulator(side, side, 7)
    out["blend"] = {}
    # the first pass writes canvas pages for the first time, as a city's
    # accumulator does; the second adds the same batches to pages in memory
    for rnd in ("first_touch", "warm"):
        t = {"native": 0.0, "plain": 0.0}
        for h, b, pos in batches:
            t0 = time.perf_counter()
            acc.add_batch(h, b, pos)
            t1 = time.perf_counter()
            plain.add_batch_plain(h, b, pos)
            t2 = time.perf_counter()
            t["native"] += t1 - t0
            t["plain"] += t2 - t1
        out["blend"][rnd] = {k: {"ms_per_add_batch": 1e3 * v / BLEND_REPEATS,
                                 "mb_per_s": tile_bytes * BLEND_REPEATS / 1e6 / v}
                             for k, v in t.items()}
        r = out["blend"][rnd]
        log(f"[prepare] add_batch ({rnd}), batch {BLEND_BATCH} of 256x256 (7 "
            f"classes, uint8 build tiles, {tile_bytes / 1e6:.1f} MB a batch) on a "
            f"{BLEND_CANVAS}^2 canvas: C++ {r['native']['ms_per_add_batch']:.2f} "
            f"ms ({r['native']['mb_per_s']:.0f} MB/s of tiles), numpy "
            f"{r['plain']['ms_per_add_batch']:.2f} ms ({r['plain']['mb_per_s']:.0f} "
            f"MB/s); {smi}")
    equal = all(np.array_equal(getattr(acc, k), getattr(plain, k))
                for k in ("height_sum", "build_sum", "weight"))
    del acc, plain
    if not equal:
        raise AssertionError("blend_tiles != the numpy slice adds")
    log("[prepare] the C++ and numpy canvases byte-equal after both passes")
    return out


def score_city(root, city, ref_height, pred_height, grid_shp):
    """``compare_height_products`` of the prediction against the reference,
    then ``compare_grid_products`` and ``count_valid_samples`` on the grid:
    finite numbers and well-formed CSVs."""
    import csv

    from srbh_tpu_torch.tools import products

    sweep = os.path.join(root, "compare.csv")
    rows = products.compare_height_products({city: (ref_height, pred_height)},
                                            sweep)
    with open(sweep, newline="") as f:
        table = list(csv.reader(f))
    if table[0] != ["city", "iou", "rmse", "mae", "me", "count"] or \
            [r[0] for r in table[1:]] != [city, "all"]:
        raise AssertionError(f"{sweep}: {table}")
    for row in rows:
        if not all(math.isfinite(float(row[k])) for k in
                   ("iou", "rmse", "mae", "me")) or row["count"] <= 0:
            raise AssertionError(f"compare_height_products: {row}")
    cols = products.compare_grid_products(
        ref_height, products.VirtualMosaic([pred_height]), grid_shp,
        nresolution=2.5)
    counts = products.count_valid_samples([grid_shp],
                                          os.path.join(root, "num_valid.csv"))
    with open(os.path.join(root, "num_valid.csv"), newline="") as f:
        nv = list(csv.reader(f))
    if nv != [["", "num_valid"], [city, str(counts[city])]] or \
            not all(math.isfinite(v) for v in cols["diou"]):
        raise AssertionError(f"count_valid_samples: {nv}")
    log(f"[prepare] prediction vs the rasterised reference (decimetres): "
        f"iou {rows[0]['iou']}, rmse {rows[0]['rmse']}, mae {rows[0]['mae']}, "
        f"me {rows[0]['me']} over {rows[0]['count']} pixels; grid cells compared "
        f"{sum(1 for v in cols['vrt_count'] if v)}, isv4 {counts[city]}")
    return rows[0]


def phase_prepare(wa, smi):
    """Phase 12: a raw city prepared with the port alone (mosaic, warp and
    clip of the WSF, the fishnet and its .prj, the rasterised reference
    heights, training tiles, datalists and stats), mapped by the city CLI at
    full width on the card and scored against the reference; the native
    codec and blender against their plain versions."""
    from srbh_tpu_torch.data import crs
    from srbh_tpu_torch.data.grid import fishgrid_stats, write_fishgrid
    from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
    from srbh_tpu_torch.predict import __main__ as cli
    from srbh_tpu_torch.tools import preprocess, products
    from srbh_tpu_torch.train.checkpoint import save_checkpoint
    from srbh_tpu_torch.train.config import get_args
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.trainer import build_models

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wa.window_attention.launches = 0
    timed, city = {}, "synth"
    rng = np.random.default_rng(21)
    with tempfile.TemporaryDirectory() as root:
        raw = os.path.join(root, "raw")
        citydir = os.path.join(root, "data", "urban", "input_data", "s2chn_large")
        os.makedirs(raw)
        os.makedirs(citydir)
        s2, s1, wsf_tiles, footprints = write_raw_city(citydir, raw, city, rng)
        timed["raw_written_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        mosaic = os.path.join(raw, "wsf_4326.tif")
        preprocess.mosaic_rasters(wsf_tiles, mosaic)
        warped = os.path.join(raw, "wsf_32650.tif")
        products.warp_raster(mosaic, warped, PREP_EPSG, 10.0, dtype=np.uint8)
        masks = preprocess.main_gen_mask(citydir, warped, citydir)
        s2path = os.path.join(citydir, f"{city}_s2.tif")
        grid = write_fishgrid(s2path, 64, 56)
        with open(grid[:-4] + ".prj") as f:
            prj_code = crs.epsg_of(f.read())
        if masks != [os.path.join(citydir, f"{city}_wsf.tif")] or prj_code != PREP_EPSG:
            raise AssertionError(f"gen-mask {masks}, grid .prj EPSG {prj_code}")
        cells = fishgrid_stats(masks[0], grid, condition=(0, 20, 4096))
        n_valid = sum(1 for r in cells if r.attributes["isv"] == 1)
        timed["wsf_and_grid_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_grid = os.path.join(raw, "grid_2.5m.tif")
        gt25 = (500000.0, 2.5, 0.0, 4649776.0, 0.0, -2.5)
        write_tiff(ref_grid, np.zeros((4 * PREP_SIDE, 4 * PREP_SIDE), np.uint8),
                   gt25, geo_keys=crs.geokeys_for_epsg(PREP_EPSG))
        floors = preprocess.shp2tif(footprints, ref_grid,
                                    os.path.join(raw, "floors.tif"),
                                    attribute="floors")
        heights_dm = (preprocess.floor_field_to_height(floors.astype(np.uint16))
                      * 10).astype(np.uint16)
        ref_height = os.path.join(root, f"{city}_ref_height.tif")
        write_tiff(ref_height, heights_dm, gt25, compress="DEFLATE",
                   geo_keys=crs.geokeys_for_epsg(PREP_EPSG))
        timed["rasterise_s"] = time.perf_counter() - t0
        built = float((floors > 0).mean())
        log(f"[prepare] WSF mosaic -> EPSG:{PREP_EPSG} warp -> clip to the S2 "
            f"extent -> fishnet ({len(cells)} cells, {n_valid} valid, .prj "
            f"EPSG:{prj_code}): {timed['wsf_and_grid_s']:.2f} s; "
            f"{PREP_BUILDINGS} footprints rasterised at 2.5 m "
            f"({4 * PREP_SIDE}^2, {built:.3f} built, max {int(floors.max())} "
            f"floors): {timed['rasterise_s']:.2f} s")
        if not (n_valid and built > 0.01):
            raise AssertionError("no valid cells or no buildings burnt")
        statsdir = prepare_tiles(os.path.join(root, "tiles"), city, s2, s1,
                                 heights_dm, timed)
        logdir = os.path.join(root, "logs")
        argv = ["--datapath", os.path.join(root, "data"), "--logdir", logdir,
                "--logdirhr", os.path.join(root, "no_sr_checkpoint"),
                "--datastats", statsdir, "--s1dir", "s1x", "--s2dir", "s2x"]
        t0 = time.perf_counter()
        model, sr = build_models(get_args(city="globe", argv=argv))
        with torch.no_grad():  # heights above the clamp at 0
            model.reg.conv_last.bias.fill_(2.0)
        os.makedirs(logdir)
        save_checkpoint(logdir, TrainState(model), 20, 0.0)
        del model, sr
        results = cli.main(argv)
        torch.cuda.synchronize()
        timed["cli_main_s"] = time.perf_counter() - t0
        if len(results) != 1:
            raise AssertionError(f"CLI predicted {len(results)} cities")
        pred = TiffReader(results[0][1])
        if (pred.width, pred.height, pred.geotransform) != \
                (4 * PREP_SIDE, 4 * PREP_SIDE, gt25):
            raise AssertionError(f"{results[0][1]}: {pred.width}x{pred.height}")
        log(f"[prepare] checkpoint written and the city CLI (full width, "
            f"bfloat16, batch 16, {n_valid} windows): {timed['cli_main_s']:.2f} s")
        timed["score"] = score_city(root, city, ref_height, results[0][1], grid)
        timed.update(native_vs_plain(s2, smi))
    timed["launches"] = wa.window_attention.launches
    timed["phase_s"] = time.perf_counter() - t_phase
    log(f"[prepare] window_attention launches: {timed['launches']}; phase "
        f"{timed['phase_s']:.1f} s; {smi}")
    if timed["launches"]:
        raise AssertionError("the preparation path launched the hand kernel")
    return timed


PARALLEL_BATCH, PARALLEL_STEPS = 16, 10  # phase 13: 10 timed steps each
# phase 13's parameters against the plain step: an element is a fault beyond
# 1e-4 where the plain step's gradient (weight decay added) stands clear of
# twice this share of its tensor's largest plus 1e-6 x the model's largest
# (the CPU tests' gradient-noise rule), and the share beyond stays under
# the CPU tests' bound for a first step
PARALLEL_NOISE, PARALLEL_SHARE = 0.02, 0.013


def multi_rank_batchnorm():
    """``GlobalBatchNorm2d`` that takes its multi-rank path
    (``_GlobalBatchNorm``: statistics all-gathered, sums all-reduced in the
    backward) at any world size; at one rank it is exact, and the module's
    own form hands that rank to ``nn.BatchNorm2d``."""
    from srbh_tpu_torch.parallel.data import GlobalBatchNorm2d, _GlobalBatchNorm

    class MultiRankBatchNorm2d(GlobalBatchNorm2d):
        def forward(self, x):
            if not self.training:
                return super().forward(x)
            return _GlobalBatchNorm.apply(x.float(), self.weight, self.bias,
                                          self, self.data_group.group).to(x.dtype)

    return MultiRankBatchNorm2d


# phase 13's per-channel BatchNorm gradients (sums over N x H x W float32
# terms, summed in another order by cuDNN): |a - b| <= this x sum |term|
REDUCE_TOL = 1e-5


def check_global_batchnorm(group):
    """``_GlobalBatchNorm`` on the card over the one-rank data group against
    ``nn.BatchNorm2d`` in training mode, two steps at batch 16 at the
    EfficientNet-B4 stem's and last stage's widths: outputs, the input's
    gradient and the running statistics after each step within
    ``TRAIN_TOL`` x (1 + |b|); the weight's and bias's gradients, each a
    channel's sum of ``g * xhat`` / ``g``, within ``REDUCE_TOL`` of the sum
    of the terms' magnitudes, and each one's distance from the float64 sums
    logged in that unit. Returns the errors."""
    from srbh_tpu_torch.parallel.data import global_batchnorm

    gen = torch.Generator(device="cuda").manual_seed(13)
    multi = multi_rank_batchnorm()
    dims = (0, 2, 3)
    errs = {}
    shapes = ((PARALLEL_BATCH, 48, 128, 128), (PARALLEL_BATCH, 448, 8, 8))
    for shape in shapes:
        ref = torch.nn.BatchNorm2d(shape[1]).cuda().train()
        with torch.no_grad():
            ref.weight.uniform_(0.5, 1.5, generator=gen)
            ref.bias.uniform_(-0.5, 0.5, generator=gen)
        glob = global_batchnorm(copy.deepcopy(ref), group)
        glob.__class__ = multi
        for _ in range(2):
            x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
            g = torch.randn(shape, device="cuda", generator=gen)
            out = []
            for bn in (glob, ref):
                xi = x.clone().requires_grad_(True)
                bn.zero_grad()
                y = bn(xi)
                y.backward(g)
                out.append(dict(out=y, grad_x=xi.grad,
                                running_mean=bn.running_mean,
                                running_var=bn.running_var,
                                grad_weight=bn.weight.grad,
                                grad_bias=bn.bias.grad))
            for key in ("out", "grad_x", "running_mean", "running_var"):
                a, b = out[0][key], out[1][key]
                err = ((a - b).abs() / (1 + b.abs())).max().item()
                errs[key] = max(errs.get(key, 0.0), err)
            x64, g64 = x.double(), g.double()
            var, mean = torch.var_mean(x64, dims, correction=0, keepdim=True)
            terms = {"grad_weight": g64 * (x64 - mean) * torch.rsqrt(
                var + ref.eps), "grad_bias": g64}
            for key, t in terms.items():
                size = t.abs().sum(dims)
                exact = t.sum(dims)
                for name, a in (("", out[0][key]),
                                ("_f64_global", out[0][key]),
                                ("_f64_cudnn", out[1][key])):
                    b = out[1][key] if not name else exact
                    err = ((a.double() - b).abs() / size).max().item()
                    errs[key + name] = max(errs.get(key + name, 0.0), err)
        if int(glob.num_batches_tracked) != int(ref.num_batches_tracked):
            raise AssertionError("the global BatchNorm counts its steps apart")
    log("[parallel] _GlobalBatchNorm over the one-rank NCCL group against "
        f"nn.BatchNorm2d, two steps at {shapes[0]} and {shapes[1]}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
        f" (|a-b|/(1+|b|) <= {TRAIN_TOL:.0e}; the parameter gradients "
        f"|a-b| / sum |term| <= {REDUCE_TOL:.0e})")
    elementwise = ("out", "grad_x", "running_mean", "running_var")
    if not (max(errs[k] for k in elementwise) <= TRAIN_TOL
            and max(errs["grad_weight"], errs["grad_bias"]) <= REDUCE_TOL):
        raise AssertionError("the global BatchNorm disagrees with "
                             "nn.BatchNorm2d")
    return errs


def parallel_step_run(mode, model, sr, batch, mesh, smi):
    """One full-width height step from ``model``'s weights in ``mode``
    (``plain``; ``ddp``: DDP over the one-rank data group; ``ddp_multi``:
    the same with the global BatchNorm on its multi-rank path,
    :func:`multi_rank_batchnorm`; ``fsdp``: FSDP2 of the model and the
    frozen trunk, as ``trainer.main(fsdp=True)`` shards them), then
    ``PARALLEL_STEPS`` more timed on the host clock, each ending in a
    synchronise: the first step's metrics, the parameters after it and the
    gradient Adam was handed (weight decay added), whole; tiles/s median
    and quartiles."""
    from torch.distributed.fsdp import FSDPModule

    from srbh_tpu_torch.parallel import mesh as pmesh
    from srbh_tpu_torch.parallel.data import GlobalBatchNorm2d, global_batchnorm
    from srbh_tpu_torch.train.checkpoint import whole
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step

    group = None if mode == "plain" else mesh.get_group(pmesh.DATA_AXIS)
    m = copy.deepcopy(model).cuda()
    groups = None
    if mode == "fsdp":
        global_batchnorm(m, group)
        pmesh.shard_state_fsdp(m, mesh)
        sr = pmesh.shard_state_fsdp(copy.deepcopy(sr).requires_grad_(False),
                                    mesh)
        groups = [sum(isinstance(x, FSDPModule) for x in net.modules())
                  for net in (m, sr)]
        log(f"[parallel] FSDP2 groups: {groups[0]} of the height model, "
            f"{groups[1]} of the frozen trunk")
    state = TrainState(m)
    kept, apply = {}, state.apply_gradients
    decay = state.optimizer.param_groups[0]["weight_decay"]

    def keep(lr):
        if not kept:
            kept.update(whole({n: p.grad + decay * p.detach()
                               for n, p in m.named_parameters()}))
        return apply(lr)

    state.apply_gradients = keep
    step = make_train_step(m, sr, device="cuda", group=group)
    if mode == "ddp_multi":
        multi = multi_rank_batchnorm()
        swapped = [x for x in m.modules() if isinstance(x, GlobalBatchNorm2d)]
        for x in swapped:
            x.__class__ = multi
        log(f"[parallel] ddp_multi: {len(swapped)} BatchNorms on the "
            f"multi-rank path")
    metrics = {k: v.cpu() for k, v in step(state, batch, 1e-3).items()}
    params = {n: t.cpu().clone() for n, t in whole(
        {n: p.detach() for n, p in m.named_parameters()}).items()}
    grads = {n: g.double().cpu() for n, g in kept.items()}
    times = []
    for _ in range(PARALLEL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, 1e-3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    rate = dict(tiles_per_s=PARALLEL_BATCH / med, q1_tiles_per_s=PARALLEL_BATCH / q3,
                q3_tiles_per_s=PARALLEL_BATCH / q1, ms_per_step=1e3 * med,
                steps=PARALLEL_STEPS, fsdp_groups=groups)
    rate["kernels"] = profile(f"parallel {mode} step", lambda: step(
        state, batch, 1e-3), warm=False, host_ops=False)[:8]
    log(f"[parallel] {mode} step, RRDBNet-23 + EfficientNet-B4, batch "
        f"{PARALLEL_BATCH}, float32: {rate['tiles_per_s']:.2f} tiles/s median "
        f"(quartiles {rate['q1_tiles_per_s']:.2f}-{rate['q3_tiles_per_s']:.2f}, "
        f"{PARALLEL_STEPS} steps, {1e3 * med:.2f} ms a step); {smi}")
    del state, step, m
    torch.cuda.empty_cache()
    return metrics, params, grads, rate


def check_parallel_step(mode, got, want):
    """``mode``'s first step against the plain one: loss, rmse and log-vars
    within ``TRAIN_TOL`` x (1 + |b|); parameters by the gradient-noise
    rule."""
    (gm, gp, _, _), (wm, wp, wg, _) = got, want
    for key in ("loss", "rmse", "log_vars"):
        err = ((gm[key] - wm[key]).abs() / (1 + wm[key].abs())).max().item()
        log(f"[parallel] {mode} {key} against the plain step: max "
            f"|a-b|/(1+|b|)={err:.3e} (tol {TRAIN_TOL:.0e})")
        if not err <= TRAIN_TOL:
            raise AssertionError(f"{mode} {key} disagrees with the plain step")
    scale = max(g.abs().max().item() for g in wg.values())
    beyond = faults = total = 0
    for n, g in wg.items():
        clear = g.abs() > 2 * PARALLEL_NOISE * g.abs().max() + 1e-6 * scale
        differ = (gp[n].double() - wp[n].double()).abs() > 1e-4
        beyond += int(differ.sum())
        faults += int((differ & clear).sum())
        total += g.numel()
    log(f"[parallel] {mode} parameters against the plain step: {beyond} of "
        f"{total} beyond 1e-4 (share {beyond / total:.2e}, bound "
        f"{PARALLEL_SHARE:g}); {faults} where the gradient stands clear")
    if faults or beyond / total >= PARALLEL_SHARE:
        raise AssertionError(f"{mode} parameters disagree with the plain step")


def parallel_city(mesh, model, sr):
    """The mesh city step (``data`` and ``spatial``) byte-equal to the plain
    step at batch ``CITY_BATCH``, and the sharded stitcher byte-equal to
    ``stitch_tiles`` on its outputs."""
    from srbh_tpu_torch.predict.device_stitcher import (
        stitch_tiles,
        stitch_tiles_sharded,
    )
    from srbh_tpu_torch.predict.predictor import make_city_step

    image = np.random.default_rng(13).uniform(
        0, 1, (CITY_BATCH, 64, 64, 8)).astype(np.float32)
    want = make_city_step(model, sr, dtype=torch.float32, device="cuda")(image)
    for partition in ("data", "spatial"):
        got = make_city_step(model, sr, dtype=torch.float32, device="cuda",
                             mesh=mesh, partition=partition)(image)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[parallel] make_city_step(mesh, partition={partition!r}) at "
            f"batch {CITY_BATCH}: byte-equal to the plain step: {same}")
        if not same:
            raise AssertionError(f"mesh city step ({partition}) differs")
    tile = image.shape[1]
    pos = np.zeros((CITY_BATCH, 4), np.int64)
    pos[:, 0] = np.arange(CITY_BATCH) % 8 * (tile - 8)  # a 64/56 fishnet, 8 x 4
    pos[:, 1] = np.arange(CITY_BATCH) // 8 * (tile - 8)
    pos[:, 2:] = tile
    hw = (4 * (3 * (tile - 8) + tile), 4 * (7 * (tile - 8) + tile))
    sharded = stitch_tiles_sharded(want[0], want[1], pos, hw, mesh, 4)
    single = stitch_tiles(want[0], want[1], pos, hw, 4)
    same = all(torch.equal(a, b) for a, b in zip(sharded, single))
    log(f"[parallel] stitch_tiles_sharded of {CITY_BATCH} overlapping "
        f"windows: byte-equal to stitch_tiles: {same}; largest weight "
        f"{int(sharded[2].max())}")
    if not same or int(sharded[2].max()) < 2:
        raise AssertionError("sharded stitcher differs")


def phase_parallel(wa, smi):
    """Phase 13: the parallel modes on the one card. The card's machine
    has one H100, and NCCL puts one rank on a card, so the collectives run
    at world size 1: ``initialize_distributed`` (NCCL), the global
    BatchNorm's multi-rank function against ``nn.BatchNorm2d``, the
    full-width height step under DDP (its BatchNorms as at one rank, and
    on their multi-rank path) and FSDP2 against the plain step (first step
    held to it, then the rates of each), the mesh city step and the sharded
    stitcher against the plain ones, and ``dryrun_multichip(1)`` (one NCCL
    process it starts)."""
    import torch.distributed as dist

    from srbh_tpu_torch import entry
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.parallel import mesh as pmesh

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wa.window_attention.launches = 0
    timed = {}
    with tempfile.TemporaryDirectory() as store:
        dev = pmesh.initialize_distributed(f"file://{store}/store", 1, 0)
        mesh = pmesh.make_mesh()
        log(f"[parallel] process group: backend {dist.get_backend()}, world "
            f"size {dist.get_world_size()}, device {dev}; mesh "
            f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")
        model, sr = entry.modules(tiny=False)
        gen = torch.Generator().manual_seed(0)
        init_weights(sr, gen)
        init_weights(model, gen)
        sr = sr.cuda()
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                 train_batch(np.random.default_rng(11), PARALLEL_BATCH).items()}
        timed["global_bn_errors"] = check_global_batchnorm(
            mesh.get_group(pmesh.DATA_AXIS))
        modes = ("ddp", "ddp_multi", "fsdp")
        runs = {mode: parallel_step_run(mode, model, sr, batch, mesh, smi)
                for mode in ("plain",) + modes}
        for mode in modes:
            check_parallel_step(mode, runs[mode], runs["plain"])
        rates = {mode: r[3] for mode, r in runs.items()}
        for mode in modes:
            cost = rates["plain"]["tiles_per_s"] / rates[mode]["tiles_per_s"] - 1
            log(f"[parallel] {mode} at world size 1 against the plain step: "
                f"{100 * cost:+.2f} % time a step; {smi}")
        timed["steps_s"] = time.perf_counter() - t_phase
        del runs
        t0 = time.perf_counter()
        parallel_city(mesh, model.eval().cuda(), sr)
        timed["city_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
    del model, sr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line = entry.dryrun_multichip(1)
    timed["dryrun_s"] = time.perf_counter() - t0
    log(f"[parallel] {line}")
    launches = wa.window_attention.launches
    timed["phase_s"] = time.perf_counter() - t_phase
    log(f"[parallel] window_attention launches over the phase: {launches}; "
        f"phase {timed['phase_s']:.1f} s")
    if launches:
        raise AssertionError("the parallel path launched the hand kernel")
    return {"launches": launches, "rates": rates, "timed": timed,
            "dryrun": line}


# phase 14: the layout options. Card against CPU at tiny width: outputs
# within FLAGSHIP_TOL x (1 + |b|), steps by phase 6's and phase 9's rules,
# int8 sums equal. Full width on the card: the fused trunk within
# LAYOUT_FUSED_TOL of the literal one's largest |feature|, the int8 trunk
# above INT8_SNR_DB against float32 (tests/test_quant.py's bound), the packed
# flagship and the dual head within FLAGSHIP_TOL x (1 + |b|) of the literal
# forms at batch CITY_BATCH. LAYOUT_TRUNK_BATCH tiles for the trunk checks.
LAYOUT_FUSED_TOL, INT8_SNR_DB, LAYOUT_TRUNK_BATCH = 1e-4, 25.0, 8
# (ci, co, k, stride, batch, side) of the int8 sums card vs CPU: conv_first
# (K = 27, padded), a dense-block conv, odd widths at stride 2, a 1x1
INT8_SHAPES = ((3, 64, 3, 1, 2, 16), (160, 32, 3, 1, 2, 16),
               (5, 7, 3, 2, 1, 9), (16, 8, 1, 1, 1, 6))


def _close_rel(label, got, want, tol=FLAGSHIP_TOL):
    """|a - b| <= tol x (1 + |b|) over every pair of tensors."""
    err = max(((a.float().cpu() - b.float().cpu()).abs()
               / (1 + b.float().cpu().abs())).max().item()
              for a, b in zip(got, want))
    log(f"[layout] {label}: max |a-b|/(1+|b|) {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label} disagrees")
    return err


def _tiny_flagship_layouts():
    """The tiny flagship (efficientnet-test, super_mid 8) with its
    BatchNorm statistics drawn, on the CPU, eval mode."""
    from srbh_tpu_torch import entry

    model, sr, _ = entry.flagship(tiny=True, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model, sr


def layout_tiny_card_vs_cpu():
    """Each layout option on the card against the CPU at tiny width."""
    from srbh_tpu_torch.models.dual_head import dual_head_apply
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.rrdbnet import RRDBNet
    from srbh_tpu_torch.ops import quant

    errs = {}
    train_tiny_card_vs_cpu("remat make_train_step", remat=True)
    gan_tiny_card_vs_cpu(remat=True)
    rng = np.random.default_rng(14)
    x = torch.as_tensor(rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32))
    gen = torch.Generator().manual_seed(14)
    trunk = init_weights(RRDBNet(num_block=2, num_feat=16, num_grow_ch=8), gen)
    for name, kw in (("fused", dict(fused=True)), ("int8", dict(quantize=True))):
        m = RRDBNet(num_block=2, num_feat=16, num_grow_ch=8, **kw)
        m.load_state_dict(trunk.state_dict())
        with torch.no_grad():
            want = m(x, features_only=True), m(x)
            got = m.cuda()(x.cuda(), features_only=True), m(x.cuda())
        errs[name] = _close_rel(f"tiny RRDBNet {name} card vs CPU (features, "
                                f"image)", got, want)
    with torch.no_grad():
        lit = trunk(x, features_only=True), trunk(x)
        fused = RRDBNet(num_block=2, num_feat=16, num_grow_ch=8, fused=True)
        fused.load_state_dict(trunk.state_dict())
        _close_rel("tiny RRDBNet fused vs literal, CPU",
                   (fused(x, features_only=True), fused(x)), lit, 1e-5)
    for ci, co, k, stride, b, side in INT8_SHAPES:
        xq = torch.as_tensor(rng.integers(-127, 128, (b, ci, side, side)), dtype=torch.int8)
        wq = torch.as_tensor(rng.integers(-127, 128, (co, ci, k, k)), dtype=torch.int8)
        want = quant.int8_conv_sums(xq, wq, stride)
        got = quant.int8_conv_sums(xq.cuda(), wq.cuda(), stride).cpu()
        log(f"[layout] int8_conv_sums {ci}->{co} k{k} s{stride} on {b}x{side}^2: "
            f"card {tuple(got.shape)} {got.dtype}, equal to the CPU's: "
            f"{torch.equal(got, want)}")
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError("int8_conv_sums differ card vs CPU")
    model, sr = _tiny_flagship_layouts()
    img = torch.as_tensor(rng.uniform(0, 1, (2, 8, 64, 64)).astype(np.float32))
    with torch.no_grad():
        fea = sr(img[:, :3], features_only=True)
        lit = model(img, fea)
        model.compute_mode = "packed"
        want = model(img, fea)
        _close_rel("tiny flagship packed vs literal, CPU", want, lit, 1e-5)
        g_model = copy.deepcopy(model).cuda()
        errs["packed"] = _close_rel("tiny flagship packed card vs CPU",
                                    g_model(img.cuda(), fea.cuda()), want)
        model.compute_mode = "literal"
        mid, super_mid = (model.aggre_height.in_channels,
                          model.hrfeat[-1].conv2.out_channels)
        hf = torch.rand(2, mid, 64, 64, generator=gen)
        bf = torch.rand(2, mid, 64, 64, generator=gen)
        hr = torch.rand(2, super_mid, 256, 256, generator=gen)
        heads = model.reg(hf, hr), model.seg(bf, hr)
        want = dual_head_apply(model, hf, bf, hr)
        _close_rel("tiny dual_head_apply vs the two heads, CPU", want, heads, 1e-5)
        errs["dual_head"] = _close_rel(
            "tiny dual_head_apply card vs CPU",
            dual_head_apply(g_model, hf.cuda(), bf.cuda(), hr.cuda()), want)
    return errs


def layout_full_width(smi):
    """Full width on the card: RRDBNet-23 fused against literal, the int8
    trunk's SNR against float32, the packed flagship and the dual head
    against the literal forms at batch ``CITY_BATCH``."""
    from srbh_tpu_torch import entry
    from srbh_tpu_torch.models.dual_head import dual_head_apply

    out = {}
    model, sr, _ = entry.flagship(device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.rand((LAYOUT_TRUNK_BATCH, 3, 64, 64), generator=gen, device="cuda")
    with torch.no_grad():
        ref = sr(x, features_only=True)
        for name in ("fused", "quantize"):
            layout = copy.deepcopy(sr)
            for m in layout.modules():
                if hasattr(m, name):
                    setattr(m, name, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = layout(x, features_only=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            if name == "fused":
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                out["fused_rel_err"] = err
                log(f"[layout] RRDBNet-23 fused vs literal, float32, batch "
                    f"{LAYOUT_TRUNK_BATCH}: max |a-b| / max |b| {err:.3e} (tol "
                    f"{LAYOUT_FUSED_TOL:.0e}); one pass {ms:.1f} ms (first call)")
                if not err <= LAYOUT_FUSED_TOL:
                    raise AssertionError("the fused trunk disagrees")
            else:
                snr = 10 * math.log10(ref.double().pow(2).sum().item()
                                      / (got - ref).double().pow(2).sum().item())
                out["int8_snr_db"] = snr
                log(f"[layout] RRDBNet-23 int8 trunk vs float32, batch "
                    f"{LAYOUT_TRUNK_BATCH}: SNR {snr:.2f} dB (limit > "
                    f"{INT8_SNR_DB:g}); one pass {ms:.1f} ms (first call)")
                if not snr > INT8_SNR_DB:
                    raise AssertionError("the int8 trunk is not faithful")
            del layout
        img = torch.rand((CITY_BATCH, 8, 64, 64), generator=gen, device="cuda")
        fea = sr(img[:, :3], features_only=True)
        lit = model(img, fea)
        model.compute_mode = "packed"
        packed = model(img, fea)
        model.compute_mode = "literal"
        out["packed_err"] = _close_rel(
            f"full-width flagship packed vs literal, float32, batch {CITY_BATCH}",
            packed, lit)
        hf = torch.rand((CITY_BATCH, 16, 64, 64), generator=gen, device="cuda")
        bf = torch.rand((CITY_BATCH, 16, 64, 64), generator=gen, device="cuda")
        hr = model.hrfeat(fea)
        out["dual_head_err"] = _close_rel(
            f"full-width dual_head_apply vs the two heads, float32, batch "
            f"{CITY_BATCH}", dual_head_apply(model, hf, bf, hr),
            (model.reg(hf, hr), model.seg(bf, hr)))
    del model, sr
    torch.cuda.empty_cache()
    log(f"[layout] full width checked; {smi}")
    return out


def layout_cli_packed(root, smi):
    """The city CLI on phase 7's tiny city (200x150) with the tiny
    configuration, literal and with ``SRBH_PACKED=1``, the same checkpoint:
    the mosaics within the quantised-output limit (bfloat16, batch 16)."""
    from srbh_tpu_torch.predict import __main__ as cli
    from srbh_tpu_torch.train.checkpoint import save_checkpoint
    from srbh_tpu_torch.train.config import get_args
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.trainer import build_models

    region = os.path.join(root, "data", "urban", "input_data", "s2chn_large")
    write_city(region, "tiny", 200, 150, seed=6)
    paths, secs = {}, {}
    for mode in ("literal", "packed"):
        logdir = os.path.join(root, f"logs_{mode}")
        argv = ["--datapath", os.path.join(root, "data"), "--logdir", logdir,
                "--logdirhr", os.path.join(root, "no_sr_checkpoint"),
                "--datastats", os.path.join(region, "stats"),
                "--s1dir", "s1x", "--s2dir", "s2x",
                "--encoder_name", "efficientnet-test", "--super_mid", "8",
                "--sr_num_block", "2", "--sr_num_feat", "16",
                "--sr_num_grow", "8"]
        model, _ = build_models(get_args(city="globe", argv=argv))
        with torch.no_grad():  # heights above the clamp at 0
            model.reg.conv_last.bias.fill_(2.0)
        os.makedirs(logdir)
        save_checkpoint(logdir, TrainState(model), 20, 0.0)
        os.environ["SRBH_PACKED"] = "1" if mode == "packed" else ""
        t0 = time.perf_counter()
        paths[mode] = cli.main(argv)[0]
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    os.environ.pop("SRBH_PACKED")
    shares = compare_mosaics("tiny city CLI, SRBH_PACKED=1 vs literal, "
                             "bfloat16", read_mosaic(paths["packed"]),
                             read_mosaic(paths["literal"]))
    log(f"[layout] tiny city CLI: literal {secs['literal']:.2f} s, packed "
        f"{secs['packed']:.2f} s (models built on the CPU included); {smi}")
    return {"cli_s": secs, "cli_shares": shares}


def layout_tools(smi, train, tools):
    """Each layout switch of the tools once: the bench under
    ``SRBH_BENCH_INT8`` and ``SRBH_BENCH_PACKED``, ``train_bench`` with
    remat (peak memory beside phase 6's plain step; ``sr_train_bench``'s
    remat runs in phase 9, beside the plain GAN step), and
    ``profile_flagship``'s packed and grouped stages beside phase 11's
    literal ones."""
    from srbh_tpu_torch import bench
    from srbh_tpu_torch.tools import profile_flagship, train_bench

    out = {}
    # the int8 trunk in float32 only: its step is ~3x the packed one's
    for var, suffix, dtypes in (("SRBH_BENCH_INT8", "_int8", ["float32"]),
                                ("SRBH_BENCH_PACKED", "_packed",
                                 ["float32", "bfloat16"])):
        os.environ[var] = "1"
        recs = run_tool("layout", bench.main, ["--batch", str(CITY_BATCH),
                                               "--repeats", "2", "--dtype",
                                               *dtypes], smi)
        os.environ.pop(var)
        for rec in recs:
            if not rec["metric"].endswith(suffix):
                raise AssertionError(f"{var}: the bench ran {rec['metric']}")
            out[f"bench{suffix}_{rec['dtype']}"] = dict(
                tiles_per_s=rec["value"], peak_gib=rec["peak_gib"],
                idle_share=rec["idle_share"])
            log(f"[layout] bench{suffix} {rec['dtype']}: {rec['value']:.2f} "
                f"tiles/s, peak {rec['peak_gib']:.2f} GiB, idle share "
                f"{rec['idle_share']:.3f}")
            for ms, key in rec["kernels"][:4]:
                log(f"[layout]   {rec['dtype']}: {ms:9.3f} ms  {key[:90]}")
        check_convs_seen(recs[0])
    os.environ["SRBH_TRAIN_REMAT"] = "1"
    rec = run_tool("layout", train_bench.main, [
        "--batch", str(TRAIN_BATCH), "--dtype", "float32", "--repeats", "2",
        "--steps", "2"], smi)[0]
    os.environ.pop("SRBH_TRAIN_REMAT")
    if not (rec["remat"] and rec["metric"].endswith("_remat")):
        raise AssertionError(f"SRBH_TRAIN_REMAT: {rec['metric']}")
    plain = train["steps"]["float32"]
    out["train_bench_remat"] = dict(tiles_per_s=rec["value"],
                                    ms_per_step=rec["median_ms"],
                                    peak_gib=rec["peak_gib"])
    log(f"[layout] train_bench remat float32, batch {TRAIN_BATCH}: "
        f"{rec['value']:.2f} tiles/s, {rec['median_ms']:.1f} ms a step, peak "
        f"{rec['peak_gib']:.2f} GiB (phase 6, plain: {plain['tiles_per_s']:.2f} "
        f"tiles/s, peak {plain['peak_gib']:.2f} GiB); {smi}")
    stages = profile_flagship.STAGES[-4:]
    rec = run_tool("layout", profile_flagship.main, [
        "--batch", str(CITY_BATCH), "--dtype", "float32", "--repeats", "3",
        "--stages", ",".join(stages)], smi)[0]
    lit = tools["profile_ms"]
    out["profile_ms"] = {k: rec["stages"][k]["median_ms"] for k in stages}
    log(f"[layout] profile_flagship float32, batch {CITY_BATCH}, ms: "
        + ", ".join(f"{k} {out['profile_ms'][k]:.3f}" for k in stages)
        + f"; phase 11's literal: hrfeat {lit['hrfeat']:.3f}, heads "
        f"{lit['heads']:.3f}, full {lit['full']:.3f}; {smi}")
    for k, v in out["profile_ms"].items():
        if not (v and v > 0):
            raise AssertionError(f"profile_flagship {k}: {v}")
    return out


def phase_layout(wa, smi, train, tools):
    """Phase 14: the layout options (remat, the fused dense block, the int8
    trunk, the packed fusion stack, the dual head) card against CPU at tiny
    width, at full width on the card, through each tool's switch once, the
    city CLI with ``SRBH_PACKED=1``, and the port's quickstart example on the
    card."""
    from srbh_tpu_torch.examples import quickstart

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wa.window_attention.launches = 0
    timed = {"tiny": layout_tiny_card_vs_cpu()}
    timed["tiny_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    timed["full"] = layout_full_width(smi)
    timed["full_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed["tools"] = layout_tools(smi, train, tools)
    timed["tools_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        timed.update(layout_cli_packed(os.path.join(root, "cli"), smi))
        timed["cli_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_tif, height_tif = quickstart.main(os.path.join(root, "quickstart"))
        timed["quickstart_s"] = time.perf_counter() - t0
        log(f"[layout] examples.quickstart on the card: {timed['quickstart_s']:.1f} s; "
            f"wrote {os.path.basename(build_tif)}, {os.path.basename(height_tif)}")
    launches = wa.window_attention.launches
    timed["phase_s"] = time.perf_counter() - t_phase
    log(f"[layout] window_attention launches over the phase: {launches}; "
        f"phase {timed['phase_s']:.1f} s (tiny {timed['tiny_s']:.1f}, full width "
        f"{timed['full_s']:.1f}, tools {timed['tools_s']:.1f}, CLI "
        f"{timed['cli_phase_s']:.1f}, quickstart {timed['quickstart_s']:.1f})")
    if launches:
        raise AssertionError("the layout options launched the hand kernel")
    return {"launches": launches, **timed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from srbh_tpu_torch import entry
    from srbh_tpu_torch.models.swinir import shift_attn_mask
    from srbh_tpu_torch.ops import window_attention as wa
    from srbh_tpu_torch.predict.predictor import make_city_step
    from srbh_tpu_torch.tools import swinir_harness, timing

    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build(wa)
    rows = phase_kernel(wa, shift_attn_mask, timing)
    (launches, swin_diff, swin_times, profiled_ms,
     swin_train_launches) = phase_swinir(wa, swinir_harness)
    swin_options = swinir_options(wa, swinir_harness, smi)
    flagship = phase_flagship(entry, make_city_step, smi)
    train = phase_train(wa, smi)
    log(f"[train] summary {json.dumps(train)}")
    city = phase_city(wa, entry, smi)
    log(f"[city] summary {json.dumps(city)}")
    entry_points = phase_entry(wa, smi)
    log(f"[entry] summary {json.dumps(entry_points)}")
    long_tail = phase_long_tail(wa, smi)
    log(f"[long_tail] summary {json.dumps(long_tail)}")
    tools = phase_tools(wa, smi, flagship)
    log(f"[tools] summary {json.dumps(tools)}")
    prepare = phase_prepare(wa, smi)
    log(f"[prepare] summary {json.dumps(prepare)}")
    parallel = phase_parallel(wa, smi)
    log(f"[parallel] summary {json.dumps(parallel)}")
    layout = phase_layout(wa, smi, train, tools)
    log(f"[layout] summary {json.dumps(layout)}")
    gan = phase_gan(wa, smi)
    log(f"[gan] summary {json.dumps(gan)}")
    remat, plain = gan["steps_alone"]["float32 remat"], gan["steps_alone"]["float32"]
    log(f"[gan] sr_train_bench float32, batch {GAN_BATCH}: remat "
        f"{remat['tiles_per_s']:.2f} tiles/s, {remat['ms_per_step']:.1f} ms "
        f"(busy {remat['busy_ms']:.1f}), peak {remat['peak_gib']:.2f} GiB; plain "
        f"{plain['tiles_per_s']:.2f} tiles/s, {plain['ms_per_step']:.1f} ms (busy "
        f"{plain['busy_ms']:.1f}), peak {plain['peak_gib']:.2f} GiB; {smi}")

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
                             "swinir_train_drop_path": swin_train_launches,
                             "swinir_no_qkv_bias_no_patch_norm":
                                 swin_options["launches"],
                             "train": train["launches"],
                             "train_async_checkpoint": train["async_launches"],
                             "train_async_checkpoint_default":
                                 train["async_default_launches"],
                             "train_device_norm": train["device_aug_launches"],
                             "city": city["launches"],
                             "main_test": entry_points["sequence"]["launches"],
                             "nosuper": entry_points["nosuper_launches"],
                             "nosuper_x2": entry_points["nosuper_x2_launches"],
                             "swinir_harness_main": entry_points["harness_launches"],
                             "long_tail": long_tail["launches"],
                             "tools": tools["launches"],
                             "prepare": prepare["launches"],
                             "parallel": parallel["launches"],
                             "layout_options": layout["launches"],
                             "gan": gan["launches"]},
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
