"""Fused window attention for SwinIR: the Hopper kernel, its plain version
and the helper that builds it.

Counterpart of ``srbh_tpu/ops/pallas/window_attention.py``. One CUDA kernel,
``csrc/window_attention.cu``, replaces both Pallas kernels there
(``_attn_kernel`` and ``_attn_kernel_masked``): it takes an optional shift
mask, and window ``b`` uses ``mask[b % nW]``. Unlike the Pallas path it has no
chunk rule, so every ``nW`` that divides the window count runs on the kernel.

Layout follows the JAX package: q, k, v and the output are
``(heads, B_, N, d)``, bias is ``(heads, N, N)``, mask is ``(nW, N, N)``.
The kernel takes q, k and v as views whose last dimension has stride 1 (for
SwinIR, the three slices of its qkv projection, uncopied) and writes a
contiguous output.

The kernel is built at first use with ``nvcc`` into ``build/srbh_tpu_torch/``
beside the package, as a shared library with a plain C interface, and bound
with ``ctypes``. It is forward-only, like the Pallas kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "window_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srbh_tpu_torch"
MAX_N = 64
MAX_D = 64

_lib: Optional[ctypes.CDLL] = None


def window_attention_reference(q, k, v, bias, mask=None):
    """Plain PyTorch version; same semantics as ``window_attention_xla``:
    scores and the output sum are taken in float32, the probabilities are
    rounded to ``q.dtype`` before ``p @ v``."""
    h, b_, n, d = q.shape
    scale = d ** -0.5
    s = torch.einsum("hbnd,hbmd->hbnm", (q * scale).float(), k.float())
    s = s + bias[:, None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(h, b_ // nw, nw, n, n) + mask[None, None].float()
        s = s.reshape(h, b_, n, n)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("hbnm,hbmd->hbnd", p.float(), v.float()).to(q.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel for sm_90a unless this source is already built.

    Returns the library's path and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel), which is also kept in a
    ``.log`` file beside the library. The library's name carries a hash of
    the source, so an edited source is always rebuilt.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libwindow_attention_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)
    return lib, out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build_kernel()
        lib = ctypes.CDLL(str(path))
        for fn in (lib.srbh_window_attention_f32, lib.srbh_window_attention_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, bias, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (heads, B_, N, d) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    h, b_, n, d = q.shape
    if not (1 <= n <= MAX_N and 1 <= d <= MAX_D):
        raise ValueError(f"kernel takes N <= {MAX_N} and d <= {MAX_D}, got "
                         f"N={n}, d={d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if bias.shape != (h, n, n):
        raise ValueError(f"bias must be {(h, n, n)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n)
                             or b_ % mask.shape[0] != 0):
        raise ValueError(f"mask must be (nW, {n}, {n}) with nW dividing "
                         f"B_={b_}, got {tuple(mask.shape)}")
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if t.requires_grad:
            raise RuntimeError("the kernel is forward-only; call it under "
                               "torch.inference_mode() or torch.no_grad()")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("q, k and v must have stride 1 in their last "
                             "dimension")


def copy_width(q, k, v) -> int:
    """Bytes per copy with which the kernel stages q, k and v: the largest
    of 16, 8 and 4 that divides the row length and every row's start
    address, else the element size (plain loads)."""
    elt = q.element_size()
    for width in (16, 8, 4):
        if q.shape[-1] * elt % width == 0 and all(
                t.data_ptr() % width == 0
                and all(s * elt % width == 0 for s in t.stride()[:3])
                for t in (q, k, v)):
            return width
    return elt


def f32_pairs(t):
    """``t`` as a contiguous float32 tensor whose start is 8-byte aligned:
    the kernel reads bias and mask as float2 pairs. A view that starts
    between two pairs is copied (bias and mask are small)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()


def window_attention(q, k, v, bias, mask=None):
    """Fused window attention: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors.

    ``window_attention.launches`` counts the kernel's launches; the plain
    path leaves it alone. On a CUDA tensor this launches the kernel or
    raises: it never falls back to the plain version. The output is a
    contiguous (heads, B_, N, d) tensor.
    """
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no window_attention for device {q.device}")
    _check(q, k, v, bias, mask)
    h, b_, n, d = q.shape
    bias = f32_pairs(bias)
    if mask is not None:
        mask = f32_pairs(mask)
    lib = _load()
    fn = (lib.srbh_window_attention_f32 if q.dtype == torch.float32
          else lib.srbh_window_attention_bf16)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                         for s in t.stride()[:3]))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 h, b_, n, d, 0 if mask is None else mask.shape[0],
                 d ** -0.5, strides, copy_width(q, k, v), stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    window_attention.launches += 1
    return out


window_attention.launches = 0
