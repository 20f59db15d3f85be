"""Serving export: the flagship forward as one ``torch.export`` file.

    python -m srbh_tpu_torch.tools.export_model out.pt2 [--tile 64]
        [--encoder efficientnet-b4] [--blocks 23] [--super-mid 16]
        [--batch N] [--dtype bfloat16] [--ckpt model.pt --sr-ckpt sr.pt]

Counterpart of ``srbh_tpu/tools/export_model.py:32-124``, which serialises
the jitted forward as StableHLO. Here ``torch.export.export`` captures
:class:`Serving` (the frozen RRDBNet features, the height model and the
predictor's post-processing, ``predictor.serving_outputs``) with the
weights in the program, and ``torch.export.save`` writes one ``.pt2``
file; :func:`load_exported` gives back a module that needs no model code:

    fn = load_exported("out.pt2")
    height, build, height_dm, build_u8 = fn(images)  # (B, T, T, 8) float32

The outputs are float heights ``clamp(h, 0)`` and the build softmax (what
the JAX serving function returns), then the predictor's uint16 decimetres
and uint8 softmax x 255. The batch dimension is symbolic
(``torch.export.Dim``) unless ``--batch`` fixes it, so one file serves
every batch size; a fixed-batch file refuses another. The program is
traced on the device the export runs on (the card, from ``main``) and runs
there.

The form of the bfloat16 export: ``torch.autocast`` inside the traced
forward is captured as an autocast region of the program (weights stay
float32 in the file, as in the eager step), so the loaded program runs the
same mixed-precision forward as ``make_city_step(dtype=torch.bfloat16)``.
The export traces the models in eval mode (no drop-connect draws) outside
``inference_mode``; call the loaded module under ``torch.no_grad()``.

``--ckpt`` (a height-model state dict, or a file of the port's
checkpoints) and ``--sr-ckpt`` (an RRDBNet state dict, alone or under
``params_ema`` / ``params``) must be given together: half a checkpoint
would export a random half. Without both, the weights are random, drawn
from ``--seed``.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
from torch import nn

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.predict.predictor import serving_outputs
from srbh_tpu_torch.tools import timing
from srbh_tpu_torch.tools.timing import DTYPES


class Serving(nn.Module):
    """NHWC float32 tiles (B, T, T, 8) -> :func:`serving_outputs` of the
    flagship in compute type ``dtype``."""

    def __init__(self, model, sr, dtype=torch.bfloat16, rgb_idx=(0, 1, 2)):
        super().__init__()
        self.model, self.sr = model.eval(), sr.eval()
        self.dtype, self.rgb_idx = dtype, tuple(rgb_idx)

    def forward(self, image):
        return serving_outputs(self.model, self.sr, image.permute(0, 3, 1, 2),
                               self.rgb_idx, self.dtype)


def export_flagship(model, sr, tile: int = 64, nchans: int = 8,
                    batch: Optional[int] = None, dtype=torch.bfloat16,
                    device=None):
    """The ``torch.export.ExportedProgram`` of :class:`Serving` on ``device``
    (``None`` is the card); ``batch=None`` makes the batch dimension
    symbolic."""
    dev = resolve_device(device)
    serving = Serving(model.to(dev), sr.to(dev), dtype)
    example = torch.zeros((batch or 2, tile, tile, nchans), device=dev)
    dynamic = None if batch else ({0: torch.export.Dim("batch", min=1, max=4096)},)
    return torch.export.export(serving, (example,), dynamic_shapes=dynamic)


def load_exported(path: str):
    """The module of a saved export: ``torch.export.load(path).module()``."""
    return torch.export.load(path).module()


def _state_dict(path: str, keys=()) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return next((sd[k] for k in keys if k in sd), sd)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.export_model")
    ap.add_argument("out")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--encoder", default="efficientnet-b4")
    ap.add_argument("--blocks", type=int, default=23)
    ap.add_argument("--super-mid", type=int, default=16)
    ap.add_argument("--batch", type=int, default=None,
                    help="fixed batch; default exports a symbolic batch dim")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="torch file of the height model's state dict")
    ap.add_argument("--sr-ckpt", default=None,
                    help="torch file of the frozen RRDBNet's state dict")
    args = ap.parse_args(argv)
    if bool(args.ckpt) != bool(args.sr_ckpt):
        ap.error("--ckpt and --sr-ckpt must be given together (a random half "
                 "would export an untrained trunk or model); omit both for a "
                 "random-weights export")
    dev = timing.tool_device()
    sr = RRDBNet(num_block=args.blocks, num_feat=64, num_grow_ch=32)
    model = SRRegressClsFeature(args.encoder, super_mid=args.super_mid,
                                isaggre=True, chans_build=7, sr_chans=64)
    if args.ckpt:
        model.load_state_dict(_state_dict(args.ckpt, ("model", "state_dict")))
        sr.load_state_dict(_state_dict(args.sr_ckpt, ("net_g_ema", "params_ema",
                                                      "params")))
    else:
        gen = torch.Generator().manual_seed(args.seed)
        init_weights(sr, gen)
        init_weights(model, gen)
    program = export_flagship(model, sr, args.tile, batch=args.batch,
                              dtype=DTYPES[args.dtype], device=dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    print(f"{args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB torch.export "
          f"program ({args.dtype}, batch {args.batch or 'symbolic'})")
    return args.out


if __name__ == "__main__":
    main()
