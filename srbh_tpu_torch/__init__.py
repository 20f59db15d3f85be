"""PyTorch / CUDA port of ``srbh_tpu`` for NVIDIA Hopper (H100).

The JAX package ``srbh_tpu`` is the reference this port is held against; the
port imports nothing of it. Modules mirror its layout (``ops/``, ``models/``,
``predict/``, ``tools/``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for the card without one raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def compute_type(device, dtype):
    """Every step's compute type: float32 as it is, else ``torch.autocast``
    in ``dtype`` on ``device`` (parameters stay float32, as in the JAX
    package)."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=dtype)
