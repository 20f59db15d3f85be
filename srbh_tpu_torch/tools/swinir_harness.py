"""SwinIR test harness: task presets, image pairs, tiled inference and the
metric report, for SwinIR and DAT.

Counterpart of ``srbh_tpu/tools/swinir_harness.py`` (SR/main_test_swinir.py):
``define_model`` (seeded random weights), ``setup``, :func:`get_image_pair`
for the seven tasks, ``pad_to_window_multiple``, ``tiled_inference``,
:func:`run_folder` (PSNR / SSIM / PSNR-B, Y-channel variants, ``*_SwinIR.png``
outputs) and :func:`main`, runnable as ``python -m
srbh_tpu_torch.tools.swinir_harness``; plus :func:`apply`, the NHWC forward.
``arch="dat"`` (``--arch dat``) builds DAT (``models/dat.py``, Chen et al.
2023) in place of SwinIR for the classical SR task, and every entry point
runs it as it runs SwinIR; its outputs are ``*_DAT.png``.

Images are PNG files read and written by ``data/png.py`` with cv2's
conventions (BGR order: the model sees RGB, the metrics and files BGR). The
two JPEG tasks need cv2's JPEG codec and import cv2 in their branch only:
without cv2 they raise ``ImportError``. On a card every window attention of
SwinIR runs the Hopper kernel; DAT's 256-token windows run a library route
(``ops/dat_attention.py``).
"""
from __future__ import annotations

import argparse
import glob
import os
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from srbh_tpu_torch import convert, resolve_device
from srbh_tpu_torch.data import png
from srbh_tpu_torch.metrics.image import (
    bgr2ycbcr,
    calculate_psnr,
    calculate_psnrb,
    calculate_ssim,
)
from srbh_tpu_torch.models.dat import DAT
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.swinir import SwinIR
from srbh_tpu_torch.utils import profiler

TASKS = ("classical_sr", "lightweight_sr", "real_sr", "gray_dn", "color_dn",
         "jpeg_car", "color_jpeg_car")
ARCHS = ("swinir", "dat")
# the derived buffers of a published state dict, recomputed by the models
DERIVED = ("relative_position_index", "attn_mask", "attn_mask_0",
           "attn_mask_1", "rpe_biases")


def _preset(task: str, scale: int, large_model: bool) -> dict:
    """SwinIR arguments per task (SR/main_test_swinir.py:128-192)."""
    base = dict(depths=(6,) * 6, num_heads=(6,) * 6, embed_dim=180,
                window_size=8, mlp_ratio=2, img_range=1.0,
                resi_connection="1conv")
    if task == "classical_sr":
        return dict(base, upscale=scale, in_chans=3, upsampler="pixelshuffle")
    if task == "lightweight_sr":
        return dict(base, upscale=scale, in_chans=3, embed_dim=60,
                    depths=(6,) * 4, num_heads=(6,) * 4,
                    upsampler="pixelshuffledirect")
    if task == "real_sr":
        if large_model:
            return dict(base, upscale=scale, in_chans=3, embed_dim=240,
                        depths=(6,) * 9, num_heads=(8,) * 9,
                        upsampler="nearest+conv", resi_connection="3conv")
        return dict(base, upscale=scale, in_chans=3, upsampler="nearest+conv")
    if task in ("gray_dn", "color_dn"):
        chans = 1 if task == "gray_dn" else 3
        return dict(base, upscale=1, in_chans=chans, out_chans=chans,
                    upsampler="")
    if task in ("jpeg_car", "color_jpeg_car"):
        chans = 1 if task == "jpeg_car" else 3
        return dict(base, upscale=1, in_chans=chans, out_chans=chans,
                    window_size=7, img_range=255.0, upsampler="")
    raise ValueError(f"unknown task {task!r}")


def _dat_preset(task: str, scale: int) -> dict:
    """DAT's arguments (the published ``options/Test/test_DAT_x{2,3,4}.yml``:
    classical SR only)."""
    if task != "classical_sr":
        raise ValueError(f"DAT is published for classical_sr, not {task!r}")
    return dict(upscale=scale, in_chans=3, img_range=1.0, embed_dim=180,
                split_size=(8, 32), depth=(6,) * 6, num_heads=(6,) * 6,
                expansion_factor=4.0, qkv_bias=True, resi_connection="1conv",
                upsampler="pixelshuffle")


def define_model(task: str, scale: int = 1, large_model: bool = False,
                 device=None, seed: int = 0, arch: str = "swinir"):
    """The task's SwinIR preset, or with ``arch="dat"`` DAT's, with seeded
    random weights (DAT's temperatures at their published ones), in eval
    mode on ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    if arch == "dat":
        model = DAT(**_dat_preset(task, scale))
    elif arch == "swinir":
        model = SwinIR(**_preset(task, scale, large_model))
    else:
        raise ValueError(f"unknown arch {arch!r}; one of {ARCHS}")
    init_weights(model, torch.Generator().manual_seed(seed))
    for name, p in model.named_parameters():
        if name.endswith(".temperature"):
            p.data.fill_(1.0)
    if arch == "dat":
        model.prepare()  # the weights were written in place
    return model.eval().to(dev)


def apply(model, x) -> torch.Tensor:
    """Run ``model`` (SwinIR or DAT) on an NHWC image batch (array or
    tensor) on the model's device under ``torch.inference_mode()``; returns
    NHWC. The call is the span ``swinir.apply``."""
    dev = next(model.parameters()).device
    with profiler.span("swinir.apply"):
        x = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
        with torch.inference_mode():
            return model(x).permute(0, 2, 3, 1)


def setup(task: str, scale: int = 1) -> Tuple[int, int]:
    """(crop border, window size) per task (SR/main_test_swinir.py:195-226)."""
    if task in ("classical_sr", "lightweight_sr"):
        return scale, 8
    if task in ("real_sr", "gray_dn", "color_dn"):
        return 0, 8
    if task in ("jpeg_car", "color_jpeg_car"):
        return 0, 7
    raise ValueError(task)


def get_image_pair(task: str, path: str, folder_lq: Optional[str] = None,
                   scale: int = 1, noise: int = 15, jpeg: int = 40):
    """(name, lq HWC float in [0, 1], gt or None), BGR as cv2 reads them
    (SR/main_test_swinir.py:229-275). The denoising tasks draw their noise
    with ``np.random.seed(0)`` in float64, as the reference does."""
    name, ext = os.path.splitext(os.path.basename(path))
    if task in ("classical_sr", "lightweight_sr"):
        gt = png.imread(path, png.IMREAD_COLOR).astype(np.float32) / 255.0
        lq = png.imread(f"{folder_lq}/{name}x{scale}{ext}",
                        png.IMREAD_COLOR).astype(np.float32) / 255.0
    elif task == "real_sr":
        gt = None
        lq = png.imread(path, png.IMREAD_COLOR).astype(np.float32) / 255.0
    elif task == "gray_dn":
        gt = png.imread(path, png.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        np.random.seed(0)
        lq = gt + np.random.normal(0, noise / 255.0, gt.shape)
        gt, lq = gt[..., None], lq[..., None]
    elif task == "color_dn":
        gt = png.imread(path, png.IMREAD_COLOR).astype(np.float32) / 255.0
        np.random.seed(0)
        lq = gt + np.random.normal(0, noise / 255.0, gt.shape)
    elif task == "jpeg_car":
        import cv2  # the JPEG codec

        gt = png.imread(path, png.IMREAD_UNCHANGED)
        if gt.ndim != 2:
            gt = bgr2ycbcr(gt, y_only=True)
        _, enc = cv2.imencode(".jpg", gt, [int(cv2.IMWRITE_JPEG_QUALITY), jpeg])
        lq = cv2.imdecode(enc, 0)
        gt = gt[..., None].astype(np.float32) / 255.0
        lq = lq[..., None].astype(np.float32) / 255.0
    elif task == "color_jpeg_car":
        import cv2  # the JPEG codec

        gt = png.imread(path, png.IMREAD_COLOR)
        _, enc = cv2.imencode(".jpg", gt, [int(cv2.IMWRITE_JPEG_QUALITY), jpeg])
        lq = cv2.imdecode(enc, 1)
        gt = gt.astype(np.float32) / 255.0
        lq = lq.astype(np.float32) / 255.0
    else:
        raise ValueError(task)
    return name, lq, gt


def pad_to_window_multiple(img: np.ndarray, window_size: int) -> np.ndarray:
    """Flip-concat padding to the NEXT window multiple
    (SR/main_test_swinir.py:100-110 — always pads at least one window)."""
    h, w = img.shape[:2]
    h_pad = (h // window_size + 1) * window_size - h
    w_pad = (w // window_size + 1) * window_size - w
    img = np.concatenate([img, img[::-1]], axis=0)[: h + h_pad]
    img = np.concatenate([img, img[:, ::-1]], axis=1)[:, : w + w_pad]
    return img


def tiled_inference(apply_fn: Callable, img_lq: np.ndarray, scale: int,
                    tile: Optional[int] = None, tile_overlap: int = 32,
                    window_size: int = 8) -> np.ndarray:
    """Whole-image or overlap-average tiled inference
    (SR/main_test_swinir.py:278-306). ``apply_fn`` maps an NHWC
    (1,H,W,C) array to a (1,sH,sW,C) tensor, as :func:`apply` does."""
    def run(patch):
        return apply_fn(patch).float().cpu().numpy()[0]

    x = img_lq[None]
    if tile is None:
        return run(x)
    h, w = x.shape[1:3]
    tile = min(tile, h, w)
    if tile % window_size != 0:
        raise ValueError("tile size must be a multiple of window_size")
    stride = tile - tile_overlap
    h_idx = list(range(0, h - tile, stride)) + [h - tile]
    w_idx = list(range(0, w - tile, stride)) + [w - tile]
    E = np.zeros((h * scale, w * scale, x.shape[3]), np.float32)
    W = np.zeros_like(E)
    for hi in h_idx:
        for wi in w_idx:
            out = run(np.ascontiguousarray(x[:, hi: hi + tile, wi: wi + tile]))
            E[hi * scale: (hi + tile) * scale,
              wi * scale: (wi + tile) * scale] += out
            W[hi * scale: (hi + tile) * scale,
              wi * scale: (wi + tile) * scale] += 1
    return E / W


def run_folder(task: str, folder: str, model, scale: int = 1,
               folder_lq: Optional[str] = None, noise: int = 15,
               jpeg: int = 40, tile: Optional[int] = None,
               tile_overlap: int = 32, save_dir: Optional[str] = None,
               device=None) -> dict:
    """Evaluate every image of ``folder`` with ``model`` on ``device``
    (``None`` is the card; without one this raises unless ``device="cpu"``);
    returns the averaged metrics (``None`` where no image gave one) and,
    with ``save_dir``, writes each output as ``<name>_<model class>.png``
    (``_SwinIR``, ``_DAT``)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    border, window_size = setup(task, scale)
    results = OrderedDict((k, []) for k in
                          ("psnr", "ssim", "psnr_y", "ssim_y", "psnrb", "psnrb_y"))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(folder, "*"))):
        name, lq, gt = get_image_pair(task, path, folder_lq, scale, noise, jpeg)
        h_old, w_old = lq.shape[:2]
        # the models take RGB: flip in and out (main_test_swinir.py:63,80);
        # metrics and files stay BGR
        is_color = lq.ndim == 3 and lq.shape[2] == 3
        if is_color:
            lq = lq[:, :, ::-1]
        lq = pad_to_window_multiple(lq, window_size)
        out = tiled_inference(lambda x: apply(model, x), lq.astype(np.float32),
                              scale, tile, tile_overlap, window_size)
        out = out[: h_old * scale, : w_old * scale]
        if is_color:
            out = out[..., ::-1]
        out8 = np.squeeze((np.clip(out, 0, 1) * 255.0).round().astype(np.uint8))
        if save_dir:
            png.imwrite(os.path.join(save_dir,
                                     f"{name}_{type(model).__name__}.png"),
                        out8)
        if gt is None:
            continue
        gt8 = (gt * 255.0).round().astype(np.uint8)
        gt8 = np.squeeze(gt8[: h_old * scale, : w_old * scale])
        results["psnr"].append(calculate_psnr(out8, gt8, crop_border=border))
        results["ssim"].append(calculate_ssim(out8, gt8, crop_border=border))
        if gt8.ndim == 3:
            results["psnr_y"].append(calculate_psnr(
                out8, gt8, crop_border=border, test_y_channel=True))
            results["ssim_y"].append(calculate_ssim(
                out8, gt8, crop_border=border, test_y_channel=True))
        if task in ("jpeg_car", "color_jpeg_car"):
            results["psnrb"].append(calculate_psnrb(out8, gt8, crop_border=border))
            if gt8.ndim == 3:
                results["psnrb_y"].append(calculate_psnrb(
                    out8, gt8, crop_border=border, test_y_channel=True))
    return {k: (sum(v) / len(v) if v else None) for k, v in results.items()}


def load_weights(model, path: str, task: str) -> None:
    """Load ``path`` into ``model``: the JAX package's ``.npz`` of
    ``{"params": ...}`` (through ``convert.swinir_state_dict``; SwinIR
    only), or a torch file holding a state dict with the reference's names,
    alone or under ``params`` (``params_ema`` for ``real_sr``: the
    reference's ``param_key_g``); the reference's derived buffers
    (:data:`DERIVED`) are dropped."""
    if path.endswith(".npz"):
        if not isinstance(model, SwinIR):
            raise ValueError("an .npz holds the JAX package's SwinIR only")
        depths = [len(layer.residual_group.blocks) for layer in model.layers]
        sd = convert.swinir_state_dict(
            {"params": convert.load_tree_npz(path)["params"]}, depths,
            model.upsampler)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("params_ema" if task == "real_sr" else "params", sd)
        sd = {k: v for k, v in sd.items()
              if k.rpartition(".")[2] not in DERIVED}
    model.load_state_dict(sd)


def main(argv=None, device=None) -> dict:
    """``python -m srbh_tpu_torch.tools.swinir_harness [flags]``, the CLI
    of SR/main_test_swinir.py:14-45 on ``device`` (``None`` is the card;
    without one this raises unless ``device="cpu"``). Weights come from
    ``--model_path`` (no download); without it the preset's seeded random
    weights run (smoke mode). ``--arch dat`` runs DAT. Outputs go to
    ``results/{arch}_{task}_x{scale}`` in the working directory."""
    dev = resolve_device(device)
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="color_dn", choices=TASKS)
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--noise", type=int, default=15)
    p.add_argument("--jpeg", type=int, default=40)
    p.add_argument("--large_model", action="store_true")
    p.add_argument("--arch", default="swinir", choices=ARCHS)
    p.add_argument("--model_path", default=None,
                   help="a torch state dict of the model, or the JAX "
                        "package's npz of SwinIR")
    p.add_argument("--folder_lq", default=None)
    p.add_argument("--folder_gt", default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--tile_overlap", type=int, default=32)
    args = p.parse_args(argv)

    folder = args.folder_gt if args.task != "real_sr" else args.folder_lq
    model = define_model(args.task, args.scale, large_model=args.large_model,
                         device="cpu", arch=args.arch)
    if args.model_path:
        load_weights(model, args.model_path, args.task)
    else:
        print("no --model_path: random init (smoke mode)")
    save_dir = f"results/{args.arch}_{args.task}_x{args.scale}"
    res = run_folder(args.task, folder, model, args.scale, args.folder_lq,
                     args.noise, args.jpeg, args.tile, args.tile_overlap,
                     save_dir, device=dev)
    for k, v in res.items():
        if v is not None:
            print(f"-- Average {k.upper()}: {v:.4f}")
    return res


if __name__ == "__main__":
    main()
