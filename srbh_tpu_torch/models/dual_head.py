"""Both HRFuseResidual heads of the height model as one grouped stream.

Counterpart of ``srbh_tpu/models/dual_head.py``: the height (``reg``) and
build (``seg``) heads have one topology and run over the same inputs'
shapes, so :func:`dual_head_apply` computes them together, every conv a
2-group conv over the two heads' channels side by side. ``fuse.0`` reads
``cat(upsampled decoder features, HR features)``: its kernel is split into
the rows of the decoder features (grouped over the two heads) and those of
the shared HR features (one dense conv giving both heads' sums), so the HR
features are not copied. BatchNorms use their running statistics:
inference only. The heads' outputs equal ``model.reg`` / ``model.seg``
(``tests/test_torch_dual_head.py``).

It reads the model's own parameters, from the model or its state dict (the
reference's names), and declares none.
"""
from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.ops.shuffle import pixel_shuffle

EPS = 1e-5


def _conv(x, w, groups=1, bias=None):
    return F.conv2d(x, w.to(x.dtype), None if bias is None
                    else bias.to(x.dtype), padding=w.shape[-1] // 2,
                    groups=groups)


def _stack(sd, a: str, b: str, name: str) -> torch.Tensor:
    """The two heads' OIHW kernels as one 2-group kernel."""
    return torch.cat([sd[f"{a}.{name}"], sd[f"{b}.{name}"]])


def _bn_grouped(x, sd, a: str, b: str, name: str):
    """Inference BatchNorm of the 2-head stream: each head's affine."""
    p = {k: torch.cat([sd[f"{a}.{name}.{k}"], sd[f"{b}.{name}.{k}"]])
         for k in ("weight", "bias", "running_mean", "running_var")}
    inv = torch.rsqrt(p["running_var"] + EPS)
    mul = (p["weight"] * inv).to(x.dtype)
    add = (p["bias"] - p["running_mean"] * p["weight"] * inv).to(x.dtype)
    return x * mul[:, None, None] + add[:, None, None]


def _basic_block_grouped(x, sd, a: str, b: str):
    """Two same-shape BasicBlocks (``a``, ``b`` prefixes) as one 2-group
    stream."""
    out = torch.relu(_bn_grouped(_conv(x, _stack(sd, a, b, "conv1.weight"), 2),
                                 sd, a, b, "bn1"))
    out = _bn_grouped(_conv(out, _stack(sd, a, b, "conv2.weight"), 2),
                      sd, a, b, "bn2")
    identity = x
    if f"{a}.downsample.0.weight" in sd:
        identity = _bn_grouped(
            _conv(x, _stack(sd, a, b, "downsample.0.weight"), 2),
            sd, a, b, "downsample.1")
    return torch.relu(out + identity)


def dual_head_apply(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                    height_fea: torch.Tensor, build_fea: torch.Tensor,
                    hr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``reg`` and ``seg`` heads of ``model`` (an
    ``SRRegressClsFeature`` or its state dict) as one grouped stream.
    ``height_fea`` / ``build_fea``: the decoders' (N, C, H, W) outputs;
    ``hr``: the HR features (N, C', 4H, 4W). Returns (height, build)."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    # the upsampler: conv + pixel shuffle octaves, grouped; each head's
    # channels shuffle within their own half
    x = torch.cat([height_fea, build_fea], dim=1)
    i = 0
    while f"reg.upsampler.{i}.weight" in sd:
        x = _conv(x, _stack(sd, "reg", "seg", f"upsampler.{i}.weight"), 2,
                  _stack(sd, "reg", "seg", f"upsampler.{i}.bias"))
        half = x.shape[1] // 2
        x = torch.cat([pixel_shuffle(x[:, :half], 2),
                       pixel_shuffle(x[:, half:], 2)], dim=1)
        i += 2
    # fuse.0 over cat(x_head, hr): the decoder rows grouped, the HR rows
    # of both heads one dense conv
    lr_c = x.shape[1] // 2
    fa, fb = "reg.fuse.0", "seg.fuse.0"

    def split(name):
        wa, wb = sd[f"{fa}.{name}"], sd[f"{fb}.{name}"]
        return (torch.cat([wa[:, :lr_c], wb[:, :lr_c]]),
                torch.cat([wa[:, lr_c:], wb[:, lr_c:]]))

    k_lr, k_hr = split("conv1.weight")
    out = torch.relu(_bn_grouped(_conv(x, k_lr, 2) + _conv(hr, k_hr),
                                 sd, fa, fb, "bn1"))
    out = _bn_grouped(_conv(out, _stack(sd, fa, fb, "conv2.weight"), 2),
                      sd, fa, fb, "bn2")
    d_lr, d_hr = split("downsample.0.weight")
    idn = _bn_grouped(_conv(x, d_lr, 2) + _conv(hr, d_hr), sd, fa, fb,
                      "downsample.1")
    x = torch.relu(out + idn)
    x = _basic_block_grouped(x, sd, "reg.fuse.1", "seg.fuse.1")
    x = _basic_block_grouped(x, sd, "reg.fuse.2", "seg.fuse.2")
    half = x.shape[1] // 2
    height = _conv(x[:, :half], sd["reg.conv_last.weight"],
                   bias=sd["reg.conv_last.bias"])
    build = _conv(x[:, half:], sd["seg.conv_last.weight"],
                  bias=sd["seg.conv_last.bias"])
    return height, build
