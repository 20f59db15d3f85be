"""PyTorch / CUDA port of ``srbh_tpu`` for NVIDIA Hopper (H100).

The JAX package ``srbh_tpu`` is the reference this port is held against; the
port imports nothing of it. Modules mirror its layout (``ops/``, ``models/``,
``predict/``, ``tools/``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for the card without one raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
