"""Shared building blocks (NCHW), counterparts of ``srbh_tpu/models/layers.py``.

* ``tconv`` pads ``k//2`` on both sides, as ``nn.Conv2d(padding=k//2)``.
* ``TorchBatchNorm`` takes the flax momentum of the JAX package and returns an
  ``nn.BatchNorm2d`` with torch momentum ``1 - momentum``.
* Module and parameter names are the reference's torch names, so reference
  state dicts load by name.
* The space-to-depth forms (``ops/s2d.py``) of the basic block, the
  inference BatchNorm and the upsampler (``packed_output=True``) compute
  with the literal modules' own parameters: inference only.
* :func:`remat` recomputes a module's activations in the backward pass.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from srbh_tpu_torch.ops import s2d
from srbh_tpu_torch.ops.shuffle import pixel_shuffle


def tconv(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
          bias: bool = True) -> nn.Conv2d:
    """Conv with torch padding semantics (``k//2`` both sides)."""
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride, kernel_size // 2,
                     bias=bias)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def TorchBatchNorm(num_features: int, momentum: float = 0.9,
                   eps: float = 1e-5) -> nn.BatchNorm2d:
    """BatchNorm2d from the JAX package's flax-convention momentum."""
    return nn.BatchNorm2d(num_features, eps=eps, momentum=1.0 - momentum)


class _FirstPassBuffers:
    """The recompute's context: puts the module's buffers (BatchNorm
    running statistics and ``num_batches_tracked``) back as the first pass
    left them, so that a recomputed training forward updates them once."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __enter__(self):
        self.saved = [(b, b.clone()) for b in self.module.buffers()]

    def __exit__(self, *exc):
        with torch.no_grad():
            for b, kept in self.saved:
                b.copy_(kept)


def remat(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, non-reentrant): the
    counterpart of flax's ``nn.remat``. The values and gradients are the
    plain call's; BatchNorm statistics are updated by the first pass only.
    Without autograd it is the plain call."""
    if not torch.is_grad_enabled():
        return module(*args)
    # the whole module is recomputed (no early stop), so that every op of
    # it runs the same number of times in each backward
    with set_checkpoint_early_stop(False):
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _FirstPassBuffers(module)))


def bn_eval_packed(bn: nn.BatchNorm2d, xp: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm of a packed tensor (running statistics, the
    per-channel affine tiled over the four offsets)."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    mul = (bn.weight * inv).to(xp.dtype)
    add = (bn.bias - bn.running_mean * bn.weight * inv).to(xp.dtype)
    return (xp * s2d.tile_channel_param(mul)[:, None, None]
            + s2d.tile_channel_param(add)[:, None, None])


class ConvBNAct(nn.Sequential):
    """Conv3x3 -> BatchNorm -> ReLU; children ``0`` (conv) and ``1`` (bn) are
    smp's ``Conv2dReLU`` names."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            tconv(in_ch, out_ch, 3, bias=False),
            TorchBatchNorm(out_ch),
            nn.ReLU(),
        )


class BasicBlock(nn.Module):
    """ResNet-v1 basic block with a 1x1 projection shortcut when the stride
    or the width changes (SR/HRfuse.py:115-159 naming: conv1/bn1/conv2/bn2/
    downsample.{0,1})."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = tconv(in_ch, planes, 3, stride, bias=False)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = tconv(planes, planes, 3, 1, bias=False)
        self.bn2 = TorchBatchNorm(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                tconv(in_ch, planes, 1, stride, bias=False),
                TorchBatchNorm(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)

    def forward_packed(self, xp, kin_perm=None):
        """The block on a parity-0 packed tensor, to a parity-0 packed
        tensor (inference only, stride 1). ``kin_perm`` (``s2d.concat_perm``)
        when ``xp`` concatenates separately packed inputs."""
        if self.training or self.conv1.stride != (1, 1):
            raise ValueError("packed BasicBlock is inference-only, stride 1")
        out = s2d.conv3x3_packed(xp, 0, self.conv1.weight, kin_perm=kin_perm)
        out = torch.relu(bn_eval_packed(self.bn1, out))
        out = bn_eval_packed(self.bn2,
                             s2d.conv3x3_packed(out, 1, self.conv2.weight))
        identity = xp
        if self.downsample is not None:
            identity = bn_eval_packed(self.downsample[1], s2d.conv1x1_packed(
                xp, self.downsample[0].weight, kin_perm=kin_perm))
        return torch.relu(out + identity)


class PixelShuffle(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return pixel_shuffle(x, self.scale)


class PixelShuffleUpsampler(nn.Sequential):
    """Conv + depth-to-space ladder: x2 per octave for power-of-two scales, a
    single x3 step for scale 3. Convs sit at even indices (``{2k}``).
    ``packed_output=True`` (power-of-two scales) leaves out the last
    shuffle and returns the parity-0 packed form of the output: a channel
    gather of the last conv's (``s2d.ps_to_pack_perm``)."""

    def __init__(self, scale: int, n_feats: int):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [tconv(n_feats, 4 * n_feats, 3), PixelShuffle(2)]
        elif scale == 3:
            layers += [tconv(n_feats, 9 * n_feats, 3), PixelShuffle(3)]
        else:
            raise NotImplementedError(f"scale {scale}")
        super().__init__(*layers)
        self.pow2 = scale & (scale - 1) == 0

    def forward(self, x, packed_output: bool = False):
        if not packed_output:
            return super().forward(x)
        if not self.pow2:
            raise NotImplementedError("packed_output needs a power-of-2 scale")
        if not len(self):
            return s2d.pack(x)  # scale 1: no octave
        for layer in list(self)[:-1]:
            x = layer(x)
        n_feats = x.shape[1] // 4
        return x[:, torch.as_tensor(s2d.ps_to_pack_perm(n_feats),
                                    device=x.device)]


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init, drawn on the generator's device (a CPU generator
    gives every device the same weights; a CUDA one builds a large model in
    place on the card): conv and linear weights U(+-1/sqrt(fan_in))
    (torch's default scale), biases 0, norms scale 1 / shift 0, BN running
    stats 0 / 1. Other parameters (SwinIR's relative-position tables, the
    CLIP towers' embeddings) N(0, 0.02) clipped to 2 std. Returns
    ``module``."""
    dev = generator.device
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            m.weight.copy_(torch.empty(m.weight.shape, device=dev).uniform_(
                -bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.copy_(torch.empty(p.shape, device=dev).normal_(
                0.0, 0.02, generator=generator).clamp_(-0.04, 0.04))
    return module


def param_count(params) -> int:
    """Number of parameters of a module (its ``parameters()``), a state dict
    or an iterable of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(p.numel() for p in params)
