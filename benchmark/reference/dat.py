"""Plain reference of DAT's eval forward, float32.

Written from the published description (Chen et al., "Dual Aggregation
Transformer for Image Super-Resolution", ICCV 2023, arXiv:2308.03364, and
its ``basicsr/archs/dat_arch.py``), with that file's state-dict names, so
that one state dict loads into it and into the port: ``conv_first``,
``before_RG.1``, ``layers.{g}.blocks.{b}.{norm1, attn, norm2, ffn}``,
``layers.{g}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``upsample.{0, 2}``, ``conv_last``. Tokens are
(B, H W, C), as published. It imports nothing of the port.

* spatial blocks (even ``b``): ``qkv``; channels ``[:C/2]`` attend in
  8 x 32 windows, ``[C/2:]`` in 32 x 8, 3 heads of 30 each:
  ``softmax(q k^T 30^-0.5 + rpb (+ mask)) v``; ``rpb`` from the offsets of
  a window's tokens through ``pos_proj`` and three (LayerNorm, ReLU,
  Linear) stages; qkv zero-padded to a multiple of 32; shifted blocks
  (``(g even, b > 0, (b - 2) % 4 == 0)`` or ``(g odd, b % 4 == 0)``) roll
  branch 0 by (-4, -16), branch 1 by (-16, -4), add Swin's -100 region
  mask and roll back. Beside it ``dwconv`` (depthwise 3 x 3, BatchNorm,
  GELU) on v as an image; ``out = proj(attn * sigmoid(C-map(conv)) +
  conv * sigmoid(S-map(attn)))``;
* channel blocks (odd ``b``): q, k, v as (B, 6, 30, N), q and k
  L2-normalised over N, ``softmax(q k^T * temperature) v``; the gates
  crossed: ``proj(attn * sigmoid(S-map(conv)) + conv * sigmoid(C-map(attn)))``;
* ``SGFN``: ``fc1``, GELU, ``x1 * dwconv(LayerNorm(x2))``, ``fc2``;
* the head: ``conv_before_upsample`` (3 x 3, LeakyReLU 0.01), two
  (3 x 3 to 4 x 64, pixel shuffle 2), ``conv_last``.

Departures from the published file: eval only (no drop-path, no dropout);
the derived buffers (``rpe_biases``, ``relative_position_index``,
``attn_mask_0`` / ``_1``) are recomputed, on the CPU whatever the default
device (meta-device arithmetic would load ``torch._dynamo``), and are not
in the state dict; the masks are made for the padded runtime size (the
published file stores them for ``img_size`` and remakes them for other
sizes: the same values). Every convolution is a :class:`Conv`: with
``tf32`` set (:func:`set_tf32`) its operands are rounded to TF32 before a
float32 convolution, what cuDNN's TF32 convolutions do, for a device that
has none. :func:`nhwc` runs with cuBLAS's and cuDNN's TF32 off unless told
otherwise.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.swinir import tf32_round

RGB_MEAN = (0.4488, 0.4371, 0.4040)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with padding ``k // 2`` and an optional TF32 rounding
    of its operands."""

    tf32 = False

    def __init__(self, cin, cout, k=3, groups=1):
        super().__init__(cin, cout, k, 1, k // 2, groups=groups)

    def forward(self, x):
        if not self.tf32:
            return super().forward(x)
        return self._conv_forward(tf32_round(x), tf32_round(self.weight),
                                  self.bias)


def set_tf32(module: nn.Module, on: bool = True) -> nn.Module:
    for m in module.modules():
        if isinstance(m, Conv):
            m.tf32 = on
    return module


def img2windows(img, hs, ws):
    """(B, C, H, W) -> (B nW, hs ws, C)."""
    b, c, h, w = img.shape
    x = img.view(b, c, h // hs, hs, w // ws, ws)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(-1, hs * ws, c)


def windows2img(x, hs, ws, h, w):
    """(B nW, hs ws, C) -> (B, H, W, C)."""
    b = x.shape[0] // (h * w // (hs * ws))
    x = x.view(b, h // hs, w // ws, hs, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def region_mask(h, w, hs, ws, sh, sw):
    """(nW, hs ws, hs ws): -100 between tokens of an (hs, ws) window of the
    image rolled by (-sh, -sw) that come from different ones of its nine
    regions, else 0."""
    img = torch.zeros(1, 1, h, w, device="cpu")
    cnt = 0
    for rows in (slice(0, -hs), slice(-hs, -sh), slice(-sh, None)):
        for cols in (slice(0, -ws), slice(-ws, -sw), slice(-sw, None)):
            img[:, :, rows, cols] = cnt
            cnt += 1
    win = img2windows(img, hs, ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class DynamicPosBias(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        pd = dim // 4
        self.pos_proj = nn.Linear(2, pd)
        self.pos1 = nn.Sequential(nn.LayerNorm(pd), nn.ReLU(), nn.Linear(pd, pd))
        self.pos2 = nn.Sequential(nn.LayerNorm(pd), nn.ReLU(), nn.Linear(pd, pd))
        self.pos3 = nn.Sequential(nn.LayerNorm(pd), nn.ReLU(),
                                  nn.Linear(pd, heads))

    def forward(self, biases):
        return self.pos3(self.pos2(self.pos1(self.pos_proj(biases))))


class Spatial_Attention(nn.Module):
    def __init__(self, dim, idx, split_size, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.hs, self.ws = (split_size if idx == 0 else split_size[::-1])
        self.pos = DynamicPosBias(dim // 4, heads)
        hs, ws = self.hs, self.ws
        bh = torch.arange(1 - hs, hs, device="cpu")
        bw = torch.arange(1 - ws, ws, device="cpu")
        biases = torch.stack(torch.meshgrid(bh, bw, indexing="ij"))
        self.register_buffer("rpe_biases", biases.flatten(1).t().float(),
                             persistent=False)
        ch, cw = torch.meshgrid(torch.arange(hs, device="cpu"),
                                torch.arange(ws, device="cpu"), indexing="ij")
        flat = torch.stack((ch, cw)).flatten(1)
        rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
        index = ((rel[..., 0] + hs - 1) * (2 * ws - 1) + rel[..., 1] + ws - 1)
        self.register_buffer("relative_position_index", index,
                             persistent=False)

    def im2win(self, x, h, w):
        b, n, c = x.shape
        x = img2windows(x.transpose(-2, -1).reshape(b, c, h, w), self.hs,
                        self.ws)
        return x.reshape(-1, self.hs * self.ws, self.heads,
                         c // self.heads).permute(0, 2, 1, 3)

    def forward(self, qkv, h, w, mask=None):
        """qkv: (3, B, H W, c); returns (B, H, W, c)."""
        b, _, c = qkv[0].shape
        q, k, v = (self.im2win(t, h, w) for t in qkv)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        n = self.hs * self.ws
        # the buffers stay on the CPU in a template on the meta device
        pos = self.pos(self.rpe_biases.to(q.device))
        index = self.relative_position_index.to(q.device)
        rpb = pos[index.view(-1)].view(n, n, -1)
        attn = attn + rpb.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(b, nw, self.heads, n, n) + mask[None, :, None])
            attn = attn.view(-1, self.heads, n, n)
        x = attn.softmax(-1) @ v
        x = x.transpose(1, 2).reshape(-1, n, c)
        return windows2img(x, self.hs, self.ws, h, w)


def dwconv(dim):
    return nn.Sequential(Conv(dim, dim, 3, groups=dim), nn.BatchNorm2d(dim),
                         nn.GELU())


def channel_interaction(dim):
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv(dim, dim // 8, 1),
                         nn.BatchNorm2d(dim // 8), nn.GELU(),
                         Conv(dim // 8, dim, 1))


def spatial_interaction(dim):
    return nn.Sequential(Conv(dim, dim // 16, 1), nn.BatchNorm2d(dim // 16),
                         nn.GELU(), Conv(dim // 16, 1, 1))


class Adaptive_Spatial_Attention(nn.Module):
    def __init__(self, dim, heads, split_size, shifted):
        super().__init__()
        self.split_size = tuple(split_size)
        self.shift_size = (split_size[0] // 2, split_size[1] // 2)
        self.shifted = shifted
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.attns = nn.ModuleList(
            Spatial_Attention(dim // 2, i, self.split_size, heads // 2)
            for i in range(2))
        self.dwconv = dwconv(dim)
        self.channel_interaction = channel_interaction(dim)
        self.spatial_interaction = spatial_interaction(dim)

    def attend(self, x, h, w):
        """The two branches' output (B, H W, C) from the tokens x."""
        return self.attend_qkv(self.qkv(x), h, w)

    def attend_qkv(self, qkv, h, w):
        b, n, c = qkv.shape
        c //= 3
        dev, dt = qkv.device, qkv.dtype
        qkv = qkv.reshape(b, -1, 3, c).permute(2, 0, 1, 3)
        big = max(self.split_size)
        pr, pb = -w % big, -h % big
        qkv = qkv.reshape(3 * b, h, w, c).permute(0, 3, 1, 2)
        qkv = F.pad(qkv, (0, pr, 0, pb)).reshape(3, b, c, -1).transpose(-2, -1)
        hp, wp = h + pb, w + pr
        s0, s1 = self.shift_size
        sp0, sp1 = self.split_size
        if self.shifted:
            qkv = qkv.view(3, b, hp, wp, c)
            q0 = torch.roll(qkv[..., :c // 2], (-s0, -s1), (2, 3))
            q1 = torch.roll(qkv[..., c // 2:], (-s1, -s0), (2, 3))
            m0 = region_mask(hp, wp, sp0, sp1, s0, s1).to(dev, dt)
            m1 = region_mask(hp, wp, sp1, sp0, s1, s0).to(dev, dt)
            x1 = self.attns[0](q0.reshape(3, b, -1, c // 2), hp, wp, m0)
            x2 = self.attns[1](q1.reshape(3, b, -1, c // 2), hp, wp, m1)
            x1 = torch.roll(x1, (s0, s1), (1, 2))
            x2 = torch.roll(x2, (s1, s0), (1, 2))
        else:
            x1 = self.attns[0](qkv[..., :c // 2], hp, wp)
            x2 = self.attns[1](qkv[..., c // 2:], hp, wp)
        x1 = x1[:, :h, :w].reshape(b, n, c // 2)
        x2 = x2[:, :h, :w].reshape(b, n, c // 2)
        return torch.cat((x1, x2), 2)

    def forward(self, x, h, w):
        b, n, c = x.shape
        qkv = self.qkv(x)
        attn = self.attend_qkv(qkv, h, w)
        v = qkv[..., 2 * c:].transpose(-2, -1).reshape(b, c, h, w)
        conv = self.dwconv(v)
        cmap = self.channel_interaction(conv).permute(0, 2, 3, 1).view(b, 1, c)
        smap = self.spatial_interaction(attn.transpose(-2, -1)
                                        .reshape(b, c, h, w))
        attn = attn * torch.sigmoid(cmap)
        conv = (torch.sigmoid(smap) * conv).permute(0, 2, 3, 1).reshape(b, n, c)
        return self.proj(attn + conv)


class Adaptive_Channel_Attention(nn.Module):
    # the dimension q and k are L2-normalised over: -1, the tokens; -2,
    # the channels, is a fault the benchmark plants
    normalise_over = -1

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.dwconv = dwconv(dim)
        self.channel_interaction = channel_interaction(dim)
        self.spatial_interaction = spatial_interaction(dim)

    def _split(self, qkv):
        b, n, c3 = qkv.shape
        qkv = qkv.reshape(b, n, 3, self.heads, c3 // 3 // self.heads)
        return qkv.permute(2, 0, 3, 1, 4).transpose(-2, -1)  # (3, B, h, d, N)

    def attend(self, x, h, w):
        """The attention output (B, H W, C) from the tokens x."""
        return self.attend_qkv(self.qkv(x), h, w)

    def attend_qkv(self, qkv, h, w):
        b, n, c = qkv.shape
        c //= 3
        q, k, v = self._split(qkv)
        q = F.normalize(q, dim=self.normalise_over)
        k = F.normalize(k, dim=self.normalise_over)
        attn = (q @ k.transpose(-2, -1)) * self.temperature
        return (attn.softmax(-1) @ v).permute(0, 3, 1, 2).reshape(b, n, c)

    def forward(self, x, h, w):
        b, n, c = x.shape
        qkv = self.qkv(x)
        attn = self.attend_qkv(qkv, h, w)
        v = self._split(qkv)[2].reshape(b, c, h, w)
        conv = self.dwconv(v)
        cmap = self.channel_interaction(attn.transpose(-2, -1)
                                        .reshape(b, c, h, w))
        smap = self.spatial_interaction(conv).permute(0, 2, 3, 1).view(b, n, 1)
        attn = attn * torch.sigmoid(smap)
        conv = (conv * torch.sigmoid(cmap)).permute(0, 2, 3, 1).reshape(b, n, c)
        return self.proj(attn + conv)


class SpatialGate(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.conv = Conv(dim, dim, 3, groups=dim)

    def forward(self, x, h, w):
        x1, x2 = x.chunk(2, dim=-1)
        b, n, c = x2.shape
        x2 = self.conv(self.norm(x2).transpose(1, 2).reshape(b, c, h, w))
        return x1 * x2.flatten(2).transpose(-1, -2)


class SGFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, x, h, w):
        return self.fc2(self.sg(F.gelu(self.fc1(x)), h, w))


def shifted(g, b):
    return ((g % 2 == 0 and b > 0 and (b - 2) % 4 == 0)
            or (g % 2 == 1 and b % 4 == 0))


class DATB(nn.Module):
    def __init__(self, dim, heads, split_size, expansion, g, b):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = (Adaptive_Spatial_Attention(dim, heads, split_size,
                                                shifted(g, b)) if b % 2 == 0
                     else Adaptive_Channel_Attention(dim, heads))
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = SGFN(dim, int(dim * expansion))

    def forward(self, x, h, w):
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class ResidualGroup(nn.Module):
    def __init__(self, dim, depth, heads, split_size, expansion, g):
        super().__init__()
        self.blocks = nn.ModuleList(DATB(dim, heads, split_size, expansion,
                                         g, b) for b in range(depth))
        self.conv = Conv(dim, dim, 3)

    def forward(self, x, h, w):
        y = x
        for blk in self.blocks:
            y = blk(y, h, w)
        b, n, c = y.shape
        y = self.conv(y.transpose(1, 2).reshape(b, c, h, w))
        return x + y.flatten(2).transpose(1, 2)


class Tokens(nn.Module):
    def forward(self, x):
        return x.flatten(2).transpose(1, 2)


class DAT(nn.Module):
    """DAT with the pixel-shuffle head; NCHW in [0, 1] in, NCHW out."""

    def __init__(self, embed_dim=180, split_size=(8, 32), depth=(6,) * 6,
                 num_heads=(6,) * 6, expansion_factor=4.0, upscale=4,
                 img_range=1.0, in_chans=3, num_feat=64):
        super().__init__()
        if upscale & (upscale - 1):
            raise ValueError("the reference has power-of-two scales only")
        self.img_range = img_range
        self.register_buffer("mean", torch.tensor(RGB_MEAN, device="cpu")
                             .view(1, 3, 1, 1), persistent=False)
        self.conv_first = Conv(in_chans, embed_dim)
        self.before_RG = nn.Sequential(Tokens(), nn.LayerNorm(embed_dim))
        self.layers = nn.ModuleList(
            ResidualGroup(embed_dim, d, h, tuple(split_size),
                          expansion_factor, g)
            for g, (d, h) in enumerate(zip(depth, num_heads)))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(Conv(embed_dim, num_feat),
                                                  nn.LeakyReLU())
        ups = []
        for _ in range(upscale.bit_length() - 1):
            ups += [Conv(num_feat, 4 * num_feat), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = Conv(num_feat, in_chans)

    def forward_features(self, x):
        b, c, h, w = x.shape
        f = self.before_RG(x)
        for layer in self.layers:
            f = layer(f, h, w)
        return self.norm(f).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x):
        mean = self.mean.to(x.device, x.dtype)
        x = (x - mean) * self.img_range
        x = self.conv_first(x)
        x = self.conv_after_body(self.forward_features(x)) + x
        x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        return x / self.img_range + mean


def build(cfg: dict) -> DAT:
    """The reference of a configuration's ``model`` (``benchmark/configs/``)
    on the default device."""
    m = cfg["model"]
    return DAT(embed_dim=m["embed_dim"], split_size=tuple(m["split_size"]),
               depth=tuple(m["depth"]), num_heads=tuple(m["num_heads"]),
               expansion_factor=m["expansion_factor"], upscale=m["upscale"],
               img_range=m["img_range"], in_chans=m["in_chans"],
               num_feat=m["num_feat"])


@contextlib.contextmanager
def tf32_flags(cudnn: bool = False, matmul: bool = False):
    """cuDNN's and cuBLAS's TF32 switches for the block, then restored."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def nhwc(model: DAT, x: torch.Tensor, cudnn_tf32: bool = False,
         matmul_tf32: bool = False) -> torch.Tensor:
    """The forward of NHWC tiles, NHWC out, with no autograd, TF32 off
    unless asked for."""
    with torch.no_grad(), tf32_flags(cudnn_tf32, matmul_tf32):
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
