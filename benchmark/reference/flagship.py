"""Plain reference of the flagship's serving forward, float32.

Written from the published architecture, with the parameter names of the
reference repository (lauraset/Super-resolution-building-height-estimation,
mymodels.py and SR/rrdbnet_arch.py) so that one state dict loads into it
and into the port:

* Real-ESRGAN's ``RRDBNet`` (Wang et al. 2021): ``conv_first``, 23 RRDBs of
  three 5-conv dense blocks (growth 32, LeakyReLU 0.2, residuals scaled
  0.2), ``conv_body``, two nearest x2 + conv stages, ``conv_hr``; the
  features are ``conv_hr``'s output;
* ``SRRegressClsFeature``: an EfficientNet encoder (TF-SAME padding,
  squeeze-excite from the block's input width, BatchNorm eps 1e-3), two
  smp U-Net decoders (256, 128, 64, 32, 16), a 3-block ResNet adapter on the
  SR features, two pixel-shuffle x4 fusion heads (height, build) and the
  64x64 aggregation conv;
* the predictor's post-processing: heights ``clamp(h, 0)``, build softmax.

Copied in shape from ``srbh_tpu_torch/models/{rrdbnet,height_model,hrfuse,
efficientnet,unet_decoder,layers}.py`` (the port, at the commit that added
the benchmark) with every layout option left out; it imports nothing of the
port. Inference only (BatchNorm from running statistics).

Every convolution is a :class:`Conv`: with ``fp8`` set (:func:`set_fp8`)
its input and weight are rounded to float8 e4m3, each tensor scaled so that
its largest magnitude maps to 448, before a float32 convolution: the
reference in the precision below the port's bfloat16, the comparison's
control.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at one scale for the whole tensor."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with an optional float8 rounding of its operands."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return self._conv_forward(fp8_round(x), fp8_round(self.weight),
                                  self.bias)


def set_fp8(module: nn.Module, on: bool = True) -> nn.Module:
    for m in module.modules():
        if isinstance(m, Conv):
            m.fp8 = on
    return module


def conv(cin, cout, k=3, stride=1, bias=True, groups=1) -> Conv:
    return Conv(cin, cout, k, stride, k // 2, bias=bias, groups=groups)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


# --------------------------------------------------------------- RRDBNet
class RDB(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.conv1 = conv(nf, gc)
        self.conv2 = conv(nf + gc, gc)
        self.conv3 = conv(nf + 2 * gc, gc)
        self.conv4 = conv(nf + 3 * gc, gc)
        self.conv5 = conv(nf + 4 * gc, nf)

    def forward(self, x):
        x1 = lrelu(self.conv1(x))
        x2 = lrelu(self.conv2(torch.cat((x, x1), 1)))
        x3 = lrelu(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = lrelu(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = RDB(nf, gc), RDB(nf, gc), RDB(nf, gc)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """The x4 generator; ``features_only`` returns ``conv_hr``'s output."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
                 num_grow_ch=32):
        super().__init__()
        self.conv_first = conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = conv(num_feat, num_feat)
        self.conv_up1 = conv(num_feat, num_feat)
        self.conv_up2 = conv(num_feat, num_feat)
        self.conv_hr = conv(num_feat, num_feat)
        self.conv_last = conv(num_feat, num_out_ch)

    def forward(self, x, features_only=False):
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = lrelu(self.conv_up1(up2(feat)))
        feat = lrelu(self.conv_up2(up2(feat)))
        hr = self.conv_hr(feat)
        if features_only:
            return hr
        return self.conv_last(lrelu(hr))


# ----------------------------------------------------------- EfficientNet
# (expand, kernel, stride, channels, repeats) of B0's seven stages
B0_STAGES = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2),
             (6, 3, 2, 80, 3), (6, 5, 1, 112, 3), (6, 5, 2, 192, 4),
             (6, 3, 1, 320, 1))
TAP_STAGES = (2, 3, 5, 7)


def round_filters(filters, width, divisor=8):
    f = filters * width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvSame(Conv):
    def __init__(self, cin, cout, k, stride=1, groups=1):
        super().__init__(cin, cout, k, stride, 0, groups=groups, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        t, b = same_pad(x.shape[-2], k, s)
        l, r = same_pad(x.shape[-1], k, s)
        return super().forward(F.pad(x, (l, r, t, b)))


def bn(ch, eps=1e-5):
    return nn.BatchNorm2d(ch, eps=eps)


class MBConv(nn.Module):
    def __init__(self, cin, cout, expand, k, stride):
        super().__init__()
        mid = cin * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self._expand_conv = ConvSame(cin, mid, 1)
            self._bn0 = bn(mid, 1e-3)
        self._depthwise_conv = ConvSame(mid, mid, k, stride, groups=mid)
        self._bn1 = bn(mid, 1e-3)
        se = max(1, int(cin * 0.25))
        self._se_reduce = Conv(mid, se, 1)
        self._se_expand = Conv(se, mid, 1)
        self._project_conv = ConvSame(mid, cout, 1)
        self._bn2 = bn(cout, 1e-3)
        self.identity = stride == 1 and cin == cout

    def forward(self, x):
        h = x
        if self.has_expand:
            h = F.silu(self._bn0(self._expand_conv(h)))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        s = self._se_expand(F.silu(self._se_reduce(h.mean((2, 3), keepdim=True))))
        h = self._bn2(self._project_conv(h * torch.sigmoid(s)))
        return h + x if self.identity else h


class EfficientNet(nn.Module):
    """The encoder; returns [x, f2, f4, f8, f16, f32]."""

    def __init__(self, width, depth, in_ch=8):
        super().__init__()
        stem = round_filters(32, width)
        self._conv_stem = ConvSame(in_ch, stem, 3, 2)
        self._bn0 = bn(stem, 1e-3)
        blocks, self.taps, ch = [], [], stem
        for si, (e, k, s, c, r) in enumerate(B0_STAGES, 1):
            out = round_filters(c, width)
            for bi in range(int(math.ceil(depth * r))):
                blocks.append(MBConv(ch, out, e, k, s if bi == 0 else 1))
                ch = out
            if si in TAP_STAGES:
                self.taps.append(len(blocks) - 1)
        self._blocks = nn.ModuleList(blocks)

    @staticmethod
    def widths(width, in_ch=8):
        ch = [round_filters(c, width) for _, _, _, c, _ in B0_STAGES]
        return (in_ch, round_filters(32, width), ch[1], ch[2], ch[4], ch[6])

    def forward(self, x):
        feats = [x]
        h = F.silu(self._bn0(self._conv_stem(x)))
        feats.append(h)
        for i, b in enumerate(self._blocks):
            h = b(h)
            if i in self.taps:
                feats.append(h)
        return feats


# ---------------------------------------------------------------- U-Net
class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(conv(cin, cout, 3, bias=False), bn(cout), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, cin, skip, cout):
        super().__init__()
        self.conv1 = ConvBNReLU(cin + skip, cout)
        self.conv2 = ConvBNReLU(cout, cout)

    def forward(self, x, skip=None):
        x = up2(x)
        if skip is not None:
            x = torch.cat((x, skip), 1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, enc_widths, dec=(256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(enc_widths[1:])[::-1]
        ins = [enc[0]] + list(dec[:-1])
        skips = enc[1:] + [0] * (len(dec) - len(enc) + 1)
        self.blocks = nn.ModuleList(DecoderBlock(i, s, o)
                                    for i, s, o in zip(ins, skips, dec))

    def forward(self, *feats):
        f = list(feats[1:])[::-1]
        x, skips = f[0], f[1:]
        for i, b in enumerate(self.blocks):
            x = b(x, skips[i] if i < len(skips) else None)
        return x


# ---------------------------------------------------------- fusion heads
class BasicBlock(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, bias=False)
        self.bn2 = bn(planes)
        self.downsample = None
        if cin != planes:
            self.downsample = nn.Sequential(conv(cin, planes, 1, bias=False),
                                            bn(planes))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + idt)


class Shuffle2(nn.Module):
    def forward(self, x):
        return F.pixel_shuffle(x, 2)


class FuseHead(nn.Module):
    """Pixel-shuffle x4 the decoder features, concatenate the adapted SR
    features, three basic blocks, a 3x3 head."""

    def __init__(self, lr_ch, hr_ch, mid, out):
        super().__init__()
        self.upsampler = nn.Sequential(conv(lr_ch, 4 * lr_ch), Shuffle2(),
                                       conv(lr_ch, 4 * lr_ch), Shuffle2())
        self.fuse = nn.Sequential(BasicBlock(lr_ch + hr_ch, mid),
                                  BasicBlock(mid, mid), BasicBlock(mid, mid))
        self.conv_last = conv(mid, out)

    def forward(self, x_lr, x_hr):
        x = torch.cat((self.upsampler(x_lr), x_hr), 1)
        return self.conv_last(self.fuse(x))


class HeightModel(nn.Module):
    """``SRRegressClsFeature`` with aggregation: (height, build logits,
    aggregated height), NCHW."""

    def __init__(self, width=1.4, depth=1.8, super_mid=16, chans_build=7,
                 sr_chans=64, in_ch=8, dec=(256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = EfficientNet(width, depth, in_ch)
        enc = EfficientNet.widths(width, in_ch)
        self.decoder1 = UnetDecoder(enc, dec)
        self.decoder2 = UnetDecoder(enc, dec)
        mid = dec[-1]
        self.hrfeat = nn.Sequential(BasicBlock(sr_chans, super_mid),
                                    BasicBlock(super_mid, super_mid),
                                    BasicBlock(super_mid, super_mid))
        self.reg = FuseHead(mid, super_mid, mid, 1)
        self.seg = FuseHead(mid, super_mid, mid, chans_build)
        self.aggre_height = conv(mid, 1)

    def forward(self, x, sr_fea):
        feats = self.encoder(x)
        hr = self.hrfeat(sr_fea)
        hf = self.decoder1(*feats)
        return (self.reg(hf, hr), self.seg(self.decoder2(*feats), hr),
                self.aggre_height(hf))


def build(cfg: dict):
    """(height model, RRDBNet) of a configuration file's ``model``."""
    m = cfg["model"]
    enc = m["encoder"]
    hm = HeightModel(enc["width_coefficient"], enc["depth_coefficient"],
                     m["super_mid"], m["chans_build"], m["sr"]["num_feat"],
                     m["in_chans"], tuple(m["decoder_channels"]))
    sr = RRDBNet(m["sr"]["num_in_ch"], m["sr"]["num_out_ch"],
                 m["sr"]["num_feat"], m["sr"]["num_block"],
                 m["sr"]["num_grow_ch"])
    return hm.eval(), sr.eval()


@torch.no_grad()
def serve(model, sr, image_nhwc, rgb=(0, 1, 2), dtype=torch.float32):
    """Float heights ``clamp(h, 0)`` (B, 256, 256), build softmax and
    build logits (B, 256, 256, C) of an NHWC float batch; with ``dtype``
    bfloat16 both models run under ``torch.autocast`` (weights float32) and
    the post-processing in float32."""
    x = image_nhwc.permute(0, 3, 1, 2).float()
    amp = (torch.autocast(x.device.type, dtype=dtype)
           if dtype != torch.float32 else contextlib.nullcontext())
    with amp:
        fea = sr(x[:, list(rgb)], features_only=True)
        h, b, _ = model(x, fea)
    h, b = h.float(), b.float()
    return (h[:, 0].clamp(min=0), torch.softmax(b, 1).permute(0, 2, 3, 1),
            b.permute(0, 2, 3, 1))


def quantised(h, p):
    """Heights and softmax as the predictor quantises them: uint16
    decimetres, uint8 x 255 (``torch.round``: half to even)."""
    return (torch.round(h * 10).to(torch.uint16),
            torch.round(p * 255).to(torch.uint8))
