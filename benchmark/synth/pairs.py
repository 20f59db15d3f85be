"""Seeded LR / HR pairs in the layout ``LRHRPairDataset`` reads: a CSV
list of file names, ``<root>/s2/<name>`` (uint16, 3 bands, lq x lq),
``<root>/ge/<name>`` (uint8, 3 bands, 4 lq x 4 lq) and the S2 min-max
table ``<stats>/s2_minmax.txt`` (the HR side then scales by 255).

The HR images are smooth random fields with detail (a coarse field
upsampled bilinearly plus fine noise), so that USM sharpening and the
perceptual loss see edges, each with its own brightness and contrast, so
that the images' losses differ as real scenes' do; the LR side is the HR
image area-averaged x4, scaled into the S2 range, with sensor noise. Drawn
on the device in a few calls, written with the benchmark's frozen TIFF
writer.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.synth.tiff import write_tiff

S2_MAX = 4096.0


def make(n: int, lq: int, seed: int, device) -> tuple:
    """(lq uint16 (n, lq, lq, 3), gt uint8 (n, 4 lq, 4 lq, 3)) numpy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x9A125)
    hr = 4 * lq
    coarse = torch.rand((n, 3, hr // 16, hr // 16), generator=gen,
                        device=device)
    field = F.interpolate(coarse, size=(hr, hr), mode="bilinear",
                          align_corners=False)
    fine = torch.rand((n, 3, hr, hr), generator=gen, device=device)
    # each image its own brightness and contrast, as scenes differ
    gain = 0.3 + 0.7 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    lift = 0.2 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    gt = (lift + gain * (0.8 * field + 0.2 * fine)).clamp(0, 1)
    gt_u8 = torch.round(gt * 255).to(torch.uint8)
    low = F.avg_pool2d(gt_u8.float() / 255, 4) * (S2_MAX - 96)
    noise = torch.rand((n, 3, lq, lq), generator=gen, device=device) * 64
    lq_u16 = torch.round(low + noise).to(torch.int32)
    return (lq_u16.permute(0, 2, 3, 1).cpu().numpy().astype(np.uint16),
            gt_u8.permute(0, 2, 3, 1).cpu().numpy())


def write(root: str, lq: np.ndarray, gt: np.ndarray) -> dict:
    """Write the pairs under ``root``; returns the dataset's arguments."""
    for sub in ("s2", "ge", "stats"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"p{i:05d}.tif" for i in range(len(lq))]
    for name, a, b in zip(names, lq, gt):
        write_tiff(os.path.join(root, "s2", name), a)
        write_tiff(os.path.join(root, "ge", name), b)
    datalist = os.path.join(root, "pairs.csv")
    with open(datalist, "w") as f:
        f.writelines(name + "\n" for name in names)
    stats = os.path.join(root, "stats")
    np.savetxt(os.path.join(stats, "s2_minmax.txt"),
               np.array([[0.0] * 3, [S2_MAX] * 3]))
    return {"datalist": datalist, "rootname": root, "datastats": stats}


def normalised(lq: np.ndarray, gt: np.ndarray) -> tuple:
    """The float32 NCHW tensors the step must see for these pairs: the LR
    side min-max scaled by the table (in float64) and clipped to [0, 1],
    the HR side over 255."""
    x = ((lq.astype(np.float32) - np.zeros(3)) / np.full(3, S2_MAX)).clip(0, 1)
    y = (gt.astype(np.float32) - np.zeros(3, np.float32)) / np.full(
        3, 255.0, np.float32)
    return (torch.from_numpy(x).float().permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(y).float().permute(0, 3, 1, 2).contiguous())
