"""GAN discriminators of SR training (NCHW).

Counterparts of ``srbh_tpu/models/discriminators.py`` (SR/rrdbnet_arch.py):

* :class:`UNetDiscriminatorSN` (:244-303): a U-Net of LeakyReLU(0.2) convs,
  ``conv0`` and ``conv9`` plain and ``conv1``-``conv8`` spectral-normalised,
  bilinear x2 upsampling (``align_corners=False``) and skip connections;
* :class:`VGGStyleDiscriminator` (:306-384): conv / BatchNorm stages with
  stride-2 4x4 convs and a 100-wide linear head, input 128 or 256. As in
  the JAX package, its 4x4 convs pad 2 (``tconv``'s ``k // 2``) where the
  reference's pad 1, so its head sees 5x5 maps, not 4x4, and ``linear1``
  takes ``8 * num_feat * 25`` inputs (a reference checkpoint's 4x4 head
  does not fit either package).

The spectral norm is the JAX package's (flax ``SpectralNorm``), not
``torch.nn.utils.spectral_norm``: every forward runs one power iteration
from the stored ``u`` (``v = n(W^T u)``, ``u' = n(W v)``, with
``n(x) = x / sqrt(sum x^2 + 1e-12)``, ``u'`` and ``v`` without gradient),
divides the weight by ``sigma = u'^T W v`` where it is not 0, and stores
``u'``, ``v`` and ``sigma`` only when called with ``train=True``. (Torch's
module skips the iteration in eval mode, so the two give another ``sigma``
where the GAN step applies D with ``train=False``.) The iteration runs in
float32 under autocast. The state-dict names are the reference's:
``conv{i}.weight_orig``, ``conv{i}.weight_u``, ``conv{i}.weight_v``; ``sigma``
is kept apart from the state dict, since no forward reads it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import TorchBatchNorm, tconv

SN_EPS = 1e-12


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


class SNConv2d(nn.Module):
    """A bias-free conv whose weight is divided by its spectral norm, flax
    ``SpectralNorm``'s way (see the module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        nn.init.kaiming_uniform_(self.weight_orig, a=5 ** 0.5)
        k = in_ch * kernel_size * kernel_size
        self.register_buffer("weight_u", _l2n(torch.randn(out_ch)))
        self.register_buffer("weight_v", _l2n(torch.randn(k)))
        self.register_buffer("sigma", torch.ones(()), persistent=False)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """Seeded draws on the CPU: the weight U(+-1/sqrt(fan_in)) (as
        ``layers.init_weights`` draws conv weights), ``u`` and ``v`` unit
        normal directions."""
        w = self.weight_orig
        bound = w[0].numel() ** -0.5
        w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
        for buf in (self.weight_u, self.weight_v):
            buf.copy_(_l2n(torch.randn(buf.shape, generator=generator)))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight_orig
        with torch.autocast(w.device.type, enabled=False):
            mat = w.reshape(w.shape[0], -1)
            with torch.no_grad():
                v = _l2n(mat.t() @ self.weight_u)
                u = _l2n(mat @ v)
            sigma = u @ (mat @ v)
            w = (mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
                 ).view_as(w)
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
                self.sigma.copy_(sigma)
        return w

    def forward(self, x, update_stats: bool = False):
        return F.conv2d(x, self.normalized_weight(update_stats), None,
                        self.stride, self.padding)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class UNetDiscriminatorSN(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = tconv(num_in_ch, nf, 3)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2, 1)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3, 1, 1)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3, 1, 1)
        self.conv6 = SNConv2d(nf * 2, nf, 3, 1, 1)
        self.conv7 = SNConv2d(nf, nf, 3, 1, 1)
        self.conv8 = SNConv2d(nf, nf, 3, 1, 1)
        self.conv9 = tconv(nf, 1, 3)

    def sn_convs(self):
        return [getattr(self, f"conv{i}") for i in range(1, 9)]

    def forward(self, x, train: bool = False):
        """Logits (N, 1, H, W); ``train`` stores the power iteration's
        ``u``, ``v`` and ``sigma``."""
        x0 = _lrelu(self.conv0(x))
        x1 = _lrelu(self.conv1(x0, train))
        x2 = _lrelu(self.conv2(x1, train))
        x3 = _lrelu(self.conv3(x2, train))
        x4 = _lrelu(self.conv4(_up2(x3), train))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv5(_up2(x4), train))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv6(_up2(x5), train))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv7(x6, train))
        out = _lrelu(self.conv8(out, train))
        return self.conv9(out)


class VGGStyleDiscriminator(nn.Module):
    """``conv0_0`` (bias), then stride-2 stages ``conv{i}_1`` / ``bn{i}_1``
    (and ``conv{i}_0`` / ``bn{i}_0`` from stage 1), ``linear1`` (100) and
    ``linear2`` (1). BatchNorm momentum 0.9 in flax's convention."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 input_size: int = 128):
        super().__init__()
        if input_size not in (128, 256):
            raise ValueError(f"input_size must be 128 or 256, got {input_size}")
        self.input_size = input_size
        nf = num_feat
        self.conv0_0 = tconv(num_in_ch, nf, 3)
        self.conv0_1 = tconv(nf, nf, 4, 2, bias=False)
        self.bn0_1 = TorchBatchNorm(nf)
        widths = [nf, nf * 2, nf * 4, nf * 8, nf * 8] + [nf * 8] * (input_size == 256)
        self.stages = len(widths) - 1
        for i in range(1, len(widths)):
            setattr(self, f"conv{i}_0", tconv(widths[i - 1], widths[i], 3, bias=False))
            setattr(self, f"bn{i}_0", TorchBatchNorm(widths[i]))
            setattr(self, f"conv{i}_1", tconv(widths[i], widths[i], 4, 2, bias=False))
            setattr(self, f"bn{i}_1", TorchBatchNorm(widths[i]))
        self.linear1 = nn.Linear(nf * 8 * 5 * 5, 100)
        self.linear2 = nn.Linear(100, 1)

    def _bn(self, name, x, train):
        bn = getattr(self, name)
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, train, bn.momentum, bn.eps)

    def forward(self, x, train: bool = False):
        """Logits (N, 1); ``train`` normalises by the batch's statistics and
        updates the running ones."""
        if x.shape[-1] != self.input_size:
            raise ValueError(f"input must be {self.input_size} wide, got {x.shape[-1]}")
        feat = _lrelu(self.conv0_0(x))
        feat = _lrelu(self._bn("bn0_1", self.conv0_1(feat), train))
        for i in range(1, self.stages + 1):
            feat = _lrelu(self._bn(f"bn{i}_0", getattr(self, f"conv{i}_0")(feat), train))
            feat = _lrelu(self._bn(f"bn{i}_1", getattr(self, f"conv{i}_1")(feat), train))
        feat = _lrelu(self.linear1(feat.flatten(1)))
        return self.linear2(feat)
