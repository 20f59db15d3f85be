"""RRDBNet, the (Real-)ESRGAN generator and frozen feature extractor.

(N, C, H, W) tensors, in the input's memory format: the serving step runs
it channels-last (``predict/predictor.py:make_city_step``), the GAN's
trainer contiguous.

Counterpart of ``srbh_tpu/models/rrdbnet.py``: 23 residual-in-residual
dense blocks of 5 growth convs
with LeakyReLU 0.2 and 0.2-scaled residuals, a trunk skip, two nearest-x2 +
conv stages, then ``conv_hr``. ``features_only=True`` returns ``conv_hr``'s
output *without* the LeakyReLU that the image path applies
(SR/rrdbnet_arch.py:225-240). State-dict names are the reference's:
``conv_first``, ``body.{i}.rdb{r}.conv{c}``, ``conv_body``, ``conv_up1/2``,
``conv_hr``, ``conv_last``.

:class:`RRDBNetSimple` is the older generator (SR/RRDBNet.py:14-78, the JAX
package's ``RRDBNetSimple``): a 4-channel input, the same dense blocks, and
two nearest-x2 + conv stages before ``HRconv`` and ``conv_last``, under the
old names ``RRDB_trunk.{i}.RDB{r}.conv{c}``, ``trunk_conv``, ``upconv1/2``,
``HRconv``.

The JAX package's layout options, each off by default and each with the
same parameters (converted checkpoints load into every mode):

* ``fused=True`` (:class:`ResidualDenseBlock`, :class:`RRDB`,
  :class:`RRDBNet`, :class:`RRDBNetSimple`): the dense block regrouped by
  input source. Each conv's kernel is split by the source it reads (x, x1,
  .., x4), the source-j slices of convs j+1..5 are stacked output-wise at
  call time into one wide conv per source, and the partial sums are added
  before each LeakyReLU: the same sums in another grouping.
* ``quantize=True`` (:class:`RRDBNet`): every trunk conv and every dense
  block conv through ``ops/quant.py:int8_conv`` (int8 x int8 summed in
  int32); ``conv_last`` stays float, as in the JAX package.
* ``remat=True`` (:class:`RRDBNet`): each RRDB's activations recomputed in
  the backward pass (``models.layers.remat``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import remat as remat_call
from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.ops.quant import int8_conv
from srbh_tpu_torch.ops.resize import upsample_nearest
from srbh_tpu_torch.ops.shuffle import pixel_unshuffle


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _apply(conv: nn.Conv2d, x, quantize: bool):
    """``conv(x)``, or its int8 form (``ops/quant.py``) in ``x``'s type."""
    if quantize:
        return int8_conv(x, conv.weight, conv.bias, out_dtype=x.dtype)
    return conv(x)


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with a 0.2-scaled residual; ``fused`` and
    ``quantize`` as the module docstring says (``quantize`` wins)."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 fused: bool = False, quantize: bool = False):
        super().__init__()
        nf, gc = num_feat, num_grow_ch
        self.fused, self.quantize = fused, quantize
        self.conv1 = tconv(nf, gc)
        self.conv2 = tconv(nf + gc, gc)
        self.conv3 = tconv(nf + 2 * gc, gc)
        self.conv4 = tconv(nf + 3 * gc, gc)
        self.conv5 = tconv(nf + 4 * gc, nf)

    def forward(self, x):
        if self.fused and not self.quantize:
            return self._fused(x)
        q = self.quantize
        x1 = _lrelu(_apply(self.conv1, x, q))
        x2 = _lrelu(_apply(self.conv2, torch.cat([x, x1], 1), q))
        x3 = _lrelu(_apply(self.conv3, torch.cat([x, x1, x2], 1), q))
        x4 = _lrelu(_apply(self.conv4, torch.cat([x, x1, x2, x3], 1), q))
        x5 = _apply(self.conv5, torch.cat([x, x1, x2, x3, x4], 1), q)
        return x5 * 0.2 + x

    def _fused(self, x):
        """One wide conv per source (``srbh_tpu/models/rrdbnet.py:133-162``):
        source j's slice of convs j+1..5, stacked output-wise."""
        convs = (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5)
        nf, gc = self.conv5.out_channels, self.conv1.out_channels
        src = [slice(0, nf)] + [slice(nf + j * gc, nf + (j + 1) * gc)
                                for j in range(4)]
        stacked = [torch.cat([convs[i].weight[:, src[j]] for i in range(j, 5)])
                   for j in range(5)]
        bias_all = torch.cat([c.bias for c in convs])
        a = F.conv2d(x, stacked[0], bias_all, padding=1).split(
            [gc, gc, gc, gc, nf], 1)
        x1 = _lrelu(a[0])
        b = F.conv2d(x1, stacked[1], padding=1).split([gc, gc, gc, nf], 1)
        x2 = _lrelu(a[1] + b[0])
        c = F.conv2d(x2, stacked[2], padding=1).split([gc, gc, nf], 1)
        x3 = _lrelu(a[2] + b[1] + c[0])
        d = F.conv2d(x3, stacked[3], padding=1).split([gc, nf], 1)
        x4 = _lrelu(a[3] + b[2] + c[1] + d[0])
        e = F.conv2d(x4, stacked[4], padding=1)
        x5 = a[4] + b[3] + c[2] + d[1] + e
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32,
                 fused: bool = False, quantize: bool = False):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch, fused, quantize)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch, fused, quantize)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch, fused, quantize)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN generator, scale 1/2/4 (scale < 4 pixel-unshuffles the input);
    ``fused``, ``quantize`` and ``remat`` as the module docstring says."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, fused: bool = False,
                 quantize: bool = False, remat: bool = False):
        super().__init__()
        self.scale = scale
        self.num_feat = num_feat
        self.quantize, self.remat = quantize, remat
        in_ch = num_in_ch * {4: 1, 2: 4, 1: 16}[scale]
        self.conv_first = tconv(in_ch, num_feat)
        self.body = nn.Sequential(
            *[RRDB(num_feat, num_grow_ch, fused, quantize)
              for _ in range(num_block)])
        self.conv_body = tconv(num_feat, num_feat)
        self.conv_up1 = tconv(num_feat, num_feat)
        self.conv_up2 = tconv(num_feat, num_feat)
        self.conv_hr = tconv(num_feat, num_feat)
        self.conv_last = tconv(num_feat, num_out_ch)

    def forward(self, x, features_only: bool = False):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        q = self.quantize
        feat = _apply(self.conv_first, x, q)
        if self.remat:
            body = feat
            for block in self.body:
                body = remat_call(block, body)
        else:
            body = self.body(feat)
        feat = feat + _apply(self.conv_body, body, q)
        feat = _lrelu(_apply(self.conv_up1, upsample_nearest(feat, 2), q))
        feat = _lrelu(_apply(self.conv_up2, upsample_nearest(feat, 2), q))
        hr = _apply(self.conv_hr, feat, q)
        if features_only:
            return hr
        return self.conv_last(_lrelu(hr))


class _RRDBSimple(nn.Module):
    """:class:`RRDB` under the old generator's names ``RDB1..3``."""

    def __init__(self, num_feat: int, num_grow_ch: int, fused: bool = False):
        super().__init__()
        self.RDB1 = ResidualDenseBlock(num_feat, num_grow_ch, fused)
        self.RDB2 = ResidualDenseBlock(num_feat, num_grow_ch, fused)
        self.RDB3 = ResidualDenseBlock(num_feat, num_grow_ch, fused)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNetSimple(nn.Module):
    """The older x4 ESRGAN generator."""

    def __init__(self, num_in_ch: int = 4, num_out_ch: int = 3,
                 num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32, fused: bool = False):
        super().__init__()
        self.conv_first = tconv(num_in_ch, num_feat)
        self.RRDB_trunk = nn.Sequential(
            *[_RRDBSimple(num_feat, num_grow_ch, fused)
              for _ in range(num_block)])
        self.trunk_conv = tconv(num_feat, num_feat)
        self.upconv1 = tconv(num_feat, num_feat)
        self.upconv2 = tconv(num_feat, num_feat)
        self.HRconv = tconv(num_feat, num_feat)
        self.conv_last = tconv(num_feat, num_out_ch)

    def forward(self, x):
        feat = self.conv_first(x)
        feat = feat + self.trunk_conv(self.RRDB_trunk(feat))
        feat = _lrelu(self.upconv1(upsample_nearest(feat, 2)))
        feat = _lrelu(self.upconv2(upsample_nearest(feat, 2)))
        return self.conv_last(_lrelu(self.HRconv(feat)))
