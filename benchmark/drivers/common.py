"""What the drivers share: the device's clock and memory, the limits of a
cell's checks, and the card's power limit."""
from __future__ import annotations

import json
import math
import os
import subprocess

import numpy as np
import torch

LIMITS_DIR = os.path.join("benchmark", "limits")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def memory_peak(dev: torch.device) -> int:
    """The process's peak of allocated device memory, bytes (0 off a card)."""
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))


def free(dev: torch.device) -> None:
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def host_buffer(shape, dtype, dev: torch.device) -> torch.Tensor:
    """A host tensor the device copies into: pinned when ``dev`` is a card."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(dev).type == "cuda")


def limits(root: str, cell: str) -> dict:
    """``benchmark/limits/<cell>.json``: each compared number's limit."""
    with open(os.path.join(root, LIMITS_DIR, cell + ".json")) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def judge(readings: dict, lims: dict):
    """(correct, checks): every reading at or under its limit; a reading
    that is not a finite number fails. ``checks`` maps name -> (value,
    limit), in the limits' order."""
    checks, ok = {}, True
    for name, lim in lims.items():
        v = readings.get(name)
        v = None if v is None or not math.isfinite(v) else float(v)
        ok = ok and v is not None and v <= lim
        checks[name] = (v, lim)
    return ok, checks


def power_limit(dev: torch.device):
    """``nvidia-smi``'s name and power limit of the card, or ``None``."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def sample_indices(seed: int, salt: int, count: int, below: int) -> list:
    """``count`` distinct indices under ``below``, drawn from the seed."""
    rng = np.random.default_rng([seed, salt])
    return sorted(rng.choice(below, size=min(count, below),
                             replace=False).tolist())


def tf32(on: bool) -> dict:
    """Set cuDNN's and cuBLAS's TF32 switches; returns the old ones."""
    old = {"cudnn": torch.backends.cudnn.allow_tf32,
           "matmul": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    return old


def restore_tf32(old: dict) -> None:
    torch.backends.cudnn.allow_tf32 = old["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = old["matmul"]
