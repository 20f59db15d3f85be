"""LPIPS perceptual distance: an AlexNet trunk and learned linear heads
(NCHW).

Counterpart of ``srbh_tpu/models/lpips.py`` (``lpips.LPIPS(net='alex')``,
used by SR/psnr_ssim.py:563-602): the fixed scaling layer, AlexNet's five
post-ReLU taps, each unit-normalised over the channels with the epsilon
outside the square root (``a / (sqrt(sum a^2) + 1e-10)``, lpips'
``normalize_tensor``), the squared difference weighted by a 1x1 ``lin``
conv without bias, the spatial mean, summed over the taps.

State-dict names are lpips' own: ``scaling_layer.shift`` / ``.scale``,
``net.slice{s}.{i}.*`` with torchvision's ``features`` indices (convs at 0,
3, 6, 8 and 10) and ``lin{t}.model.1.weight`` (index 0 is the Dropout,
identity in eval mode). No pretrained weights are in the repository;
:func:`convert_lpips_alex` takes lpips' or torchvision's files.
"""
from __future__ import annotations

from typing import List, Mapping

import torch
from torch import nn

# lpips.ScalingLayer's constants (RGB)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet.features: (index, out_ch, kernel, stride, pad) of each
# conv, and lpips' slices of those indices (a ReLU after each conv, a 3x3 /
# 2 max-pool at 2 and 5)
_ALEX_CONVS = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
               (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))
_SLICES = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))
ALEX_CHANNELS = tuple(c[1] for c in _ALEX_CONVS)


def _alexnet_layers() -> dict:
    layers, in_ch = {}, 3
    for idx, out_ch, k, s, p in _ALEX_CONVS:
        layers[idx] = nn.Conv2d(in_ch, out_ch, k, s, p)
        layers[idx + 1] = nn.ReLU()
        in_ch = out_ch
    layers[2] = layers[5] = None  # max-pools, made per slice
    return layers


class AlexNetFeatures(nn.Module):
    """AlexNet's trunk in lpips' five slices; returns the five taps."""

    def __init__(self):
        super().__init__()
        layers = _alexnet_layers()
        for s, (a, b) in enumerate(_SLICES, 1):
            seq = nn.Sequential()
            for i in range(a, b):
                seq.add_module(str(i), layers[i] or nn.MaxPool2d(3, 2))
            setattr(self, f"slice{s}", seq)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for s in range(1, len(_SLICES) + 1):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _unit(x):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10)


class LPIPS(nn.Module):
    """LPIPS-alex of NCHW image pairs -> (N,). The caller picks the input
    range (lpips documents [-1, 1]; the reference feeds [0, 1])."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = AlexNetFeatures()
        for t, ch in enumerate(ALEX_CHANNELS):
            setattr(self, f"lin{t}", NetLinLayer(ch))

    def forward(self, x0, x1):
        f0 = self.net(self.scaling_layer(x0))
        f1 = self.net(self.scaling_layer(x1))
        total = 0.0
        for t, (a, b) in enumerate(zip(f0, f1)):
            d = getattr(self, f"lin{t}")((_unit(a) - _unit(b)) ** 2)
            total = total + d.mean(dim=(1, 2, 3))
        return total


def trunk_conv_name(idx: int) -> str:
    """The state-dict name of the conv at torchvision ``features`` index
    ``idx``: ``net.slice{s}.{idx}``."""
    s = next(s for s, (a, b) in enumerate(_SLICES, 1) if a <= idx < b)
    return f"net.slice{s}.{idx}"


def scaling_state_dict() -> dict:
    """lpips' scaling constants under their state-dict names."""
    return {f"scaling_layer.{k}": v
            for k, v in ScalingLayer().state_dict().items()}


def convert_lpips_alex(sd: Mapping) -> dict:
    """An ``lpips.LPIPS(net='alex')`` state dict (``net.slice{s}.{i}.*``,
    ``lin{t}.model.1.weight``), or a bare torchvision AlexNet's
    (``features.{i}.*``), -> :class:`LPIPS`'s state dict, with lpips'
    scaling constants. A trunk-only file gives no ``lin`` heads: load it with
    ``strict=False`` beside heads from elsewhere. Other keys are dropped; a
    missing trunk conv raises ``KeyError``."""
    out = scaling_state_dict()
    for t, (idx, *_rest) in enumerate(_ALEX_CONVS):
        name = trunk_conv_name(idx)
        src = next((pre for pre in (name, f"features.{idx}")
                    if f"{pre}.weight" in sd), None)
        if src is None:
            raise KeyError(f"no trunk weights for conv{t} (features.{idx})")
        for p in ("weight", "bias"):
            out[f"{name}.{p}"] = torch.as_tensor(sd[f"{src}.{p}"])
        lin = f"lin{t}.model.1.weight"
        if lin in sd:
            out[lin] = torch.as_tensor(sd[lin])
    return out
