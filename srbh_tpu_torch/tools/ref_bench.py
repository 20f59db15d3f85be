"""The reference topology's serving throughput, at the reference's settings.

    python -m srbh_tpu_torch.tools.ref_bench [--batch 16]

Counterpart of ``srbh_tpu/tools/ref_bench.py:46-121``. The JAX tool runs
torch replicas of the reference topology (RRDBNet-23 nf 64 + the
EfficientNet-B4 U-Net, mymodels.py:233-337, SR/rrdbnet_arch.py:170-240) on
a CPU, for want of a card. The port is that topology, so its twin is the
flagship serving step of ``srbh_tpu_torch.bench`` (the same measurement,
no second copy of the model path) at the reference's own predict-loop
settings (predict_realesanet_feature_globe.py:170-177): float32 with
PyTorch's default TF32 settings (the reference sets none: cuDNN may use
TF32, cuBLAS may not), batch 16, heights ``round(h * 10)`` as uint16 and
build maps ``softmax * 255`` as uint16, both copied to the host. It prints
``reference_topology_tiles_per_sec`` on the card with its TF32 state; the
settings are restored after the run.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import torch

from srbh_tpu_torch import entry, resolve_device
from srbh_tpu_torch.bench import inputs, measure_serving
from srbh_tpu_torch.predict.predictor import make_city_step
from srbh_tpu_torch.tools import timing


def default_tf32():
    """PyTorch's default TF32 settings for the block, restored after it."""
    scope = contextlib.ExitStack()
    for mod, name, default in ((torch.backends.cudnn, "allow_tf32", True),
                               (torch.backends.cuda.matmul, "allow_tf32", False)):
        scope.callback(setattr, mod, name, getattr(mod, name))
        setattr(mod, name, default)
    return scope


def run(batch: int = 16, repeats: int = 10, seed: int = 0, tile: int = 64,
        tiny: bool = False, device=None) -> dict:
    """The record of the reference-settings step on ``device`` (``None`` is
    the card); off a card the step runs once and times are ``None``."""
    dev = resolve_device(device)
    model, sr, _ = entry.flagship(tile=tile, batch=batch, tiny=tiny,
                                  device=dev, seed=seed)
    city_step = make_city_step(model, sr, dtype=torch.float32, device=dev)

    def step(x):
        h, b = city_step(x)
        return h.cpu(), b.to(torch.uint16).cpu()

    with default_tf32():
        rec = measure_serving(step, model, sr, inputs(batch, tile, 2, seed, dev),
                              torch.float32, dev, repeats,
                              entry.flops_per_tile(tiny, tile)["total"])
    h, b = step(inputs(batch, tile, 1, seed, dev)[0])
    if (h.dtype, b.dtype, h.device.type) != (torch.uint16, torch.uint16, "cpu"):
        raise AssertionError(f"reference outputs {h.dtype} {b.dtype} on {h.device}")
    return {"tool": "ref_bench", "metric": "reference_topology_tiles_per_sec",
            **rec}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.ref_bench")
    ap.add_argument("--batch", type=int, default=16,
                    help="the reference's train batch (train.py:97)")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ref_bench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    rec = run(args.batch, args.repeats, args.seed, device=dev)
    timing.emit([rec], args.out)
    return rec


if __name__ == "__main__":
    main()
