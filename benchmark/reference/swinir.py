"""Plain reference of SwinIR's eval forward, float32.

Written from the published description (Liang et al., "SwinIR: Image
Restoration Using Swin Transformer", ICCVW 2021, arXiv:2108.10257, and its
``network_swinir.py``), with the state-dict names of that file, so that one
state dict loads into it and into the port: ``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{norm1, attn.
{qkv, proj, relative_position_bias_table}, norm2, mlp.{fc1, fc2}}``,
``layers.{i}.conv``, ``norm``, ``conv_after_body`` and the head's
``conv_before_upsample.0``, ``conv_up1``, ``conv_up2``, ``conv_hr``,
``conv_last``. Each Swin block: pre-LayerNorm, windowed multi-head
attention with the learned relative-position bias (every other block on
windows shifted by half a window, with the additive -100 mask between the
nine regions of the shifted image), a residual, then pre-LayerNorm, a GELU
MLP and a residual; each RSTB adds its input to its conv tail's output.
Window attention is written here as it is published: ``q * d^-0.5 @ k^T``,
plus bias and mask, softmax, ``@ v``. It imports nothing of the port.

Departures from the published file:

* eval only: no drop-path, no dropout; ``ape`` (absolute position
  embedding, off in every preset) and ``qk_scale`` are left out;
* only the real-world SR head, ``nearest+conv`` at x4 (the published file
  supports no other scale for it); tails ``1conv`` and ``3conv``;
* the derived buffers ``relative_position_index`` and ``attn_mask`` are
  recomputed, for the runtime size, and are not in the state dict (the
  published file keeps ``attn_mask`` for ``img_size`` and recomputes it for
  other sizes: the same values);
* tokens stay (B, H, W, C) between blocks, where the file flattens them to
  (B, H W, C): the same values in another shape;
* every convolution is a :class:`Conv`; with ``tf32`` set
  (:func:`set_tf32`) its input and weight are rounded to TF32 (10 mantissa
  bits, round to nearest, ties away) before a float32 convolution: what
  cuDNN's TF32 convolutions do, for a device that has none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with padding ``k // 2`` and an optional TF32 rounding
    of its operands."""

    tf32 = False

    def __init__(self, cin, cout, k=3):
        super().__init__(cin, cout, k, 1, k // 2)

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


def position_index(ws: int) -> torch.Tensor:
    """(ws^2 * ws^2,) index of each pair of a window's tokens into the
    (2 ws - 1)^2 rows of the bias table, by their offset (dy, dx); on the
    CPU whatever the default device (on the meta device its arithmetic
    would load ``torch._dynamo``, seconds of a process's start)."""
    r = torch.arange(ws, device="cpu")
    rows, cols = torch.meshgrid(r, r, indexing="ij")
    r, c = rows.flatten(), cols.flatten()
    dy = r[:, None] - r[None, :] + ws - 1
    dx = c[:, None] - c[None, :] + ws - 1
    return (dy * (2 * ws - 1) + dx).flatten()


def to_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), windows of each image in row
    order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def from_windows(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`to_windows`."""
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).transpose(2, 3)
    return x.reshape(-1, h, w, c)


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws^2, ws^2): -100 between tokens of a shifted window that come
    from different ones of the image's nine regions, else 0."""
    region = torch.zeros(h, w)
    bands = (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, h))
    bands_w = (slice(0, w - ws), slice(w - ws, w - shift), slice(w - shift, w))
    for i, rows in enumerate(bands):
        for j, cols in enumerate(bands_w):
            region[rows, cols] = 3 * i + j
    ids = to_windows(region[None, :, :, None], ws)[..., 0]  # (nW, ws^2)
    same = ids[:, :, None] == ids[:, None, :]
    return torch.where(same, 0.0, -100.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, ws: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", position_index(ws), persistent=False)

    def forward(self, x, mask=None):
        """x: (B_, N, C) windows; mask: (nW, N, N) or None."""
        b_, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).view(b_, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]  # (B_, heads, N, d)
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.index]
        attn = attn + bias.view(n, n, self.heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) + mask[None, :, None]
            attn = attn.view(b_, self.heads, n, n)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One Swin block on (B, H, W, C); ``shift`` 0 or half a window."""

    def __init__(self, dim, heads, ws, shift, mlp_ratio):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        ws, s = self.ws, self.shift
        y = self.norm1(x)
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = shift_mask(h, w, ws, s).to(x.device, x.dtype)
        y = from_windows(self.attn(to_windows(y, ws), mask), ws, h, w)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    def __init__(self, dim, depth, heads, ws, mlp_ratio, img_size, resi):
        super().__init__()
        # a window no larger than the training patch; no shift when one
        # window covers it (network_swinir.py, SwinTransformerBlock)
        shift = 0 if img_size <= ws else ws // 2
        ws = min(ws, img_size)
        self.residual_group = ResidualGroup(
            SwinBlock(dim, heads, ws, shift if i % 2 else 0, mlp_ratio)
            for i in range(depth))
        if resi == "1conv":
            self.conv = Conv(dim, dim)
        elif resi == "3conv":
            self.conv = nn.Sequential(
                Conv(dim, dim // 4), nn.LeakyReLU(0.2),
                Conv(dim // 4, dim // 4, 1), nn.LeakyReLU(0.2),
                Conv(dim // 4, dim))
        else:
            raise ValueError(f"unknown resi_connection {resi!r}")

    def forward(self, x):
        """x: (B, H, W, C)."""
        y = x
        for block in self.residual_group.blocks:
            y = block(y)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class SwinIR(nn.Module):
    """SwinIR with the real-world x4 head (``nearest+conv``); NCHW in [0, 1]
    in, NCHW out."""

    def __init__(self, embed_dim=240, depths=(6,) * 9, num_heads=(8,) * 9,
                 window_size=8, mlp_ratio=2.0, img_size=64, img_range=1.0,
                 resi_connection="3conv", num_feat=64, in_chans=3,
                 out_chans=3, upscale=4, upsampler="nearest+conv"):
        super().__init__()
        if upsampler != "nearest+conv" or upscale != 4:
            raise ValueError("the reference has the nearest+conv x4 head only")
        self.ws, self.img_range = window_size, img_range
        self.register_buffer("mean", torch.tensor(RGB_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.conv_first = Conv(in_chans, embed_dim)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, depth, heads, window_size, mlp_ratio, img_size,
                 resi_connection)
            for depth, heads in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(Conv(embed_dim, num_feat),
                                                  nn.LeakyReLU())
        self.conv_up1 = Conv(num_feat, num_feat)
        self.conv_up2 = Conv(num_feat, num_feat)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, out_chans)

    def forward_features(self, x):
        f = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        for layer in self.layers:
            f = layer(f)
        return self.norm(f).permute(0, 3, 1, 2)

    def forward(self, x):
        h, w = x.shape[-2:]
        ws = self.ws
        x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws),
                  mode="reflect")
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        x = self.conv_first(x)
        x = self.conv_after_body(self.forward_features(x)) + x
        x = self.conv_before_upsample(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        lrelu = lambda t: F.leaky_relu(t, 0.2)
        x = lrelu(self.conv_up1(up(x)))
        x = lrelu(self.conv_up2(up(x)))
        x = self.conv_last(lrelu(self.conv_hr(x)))
        return (x / self.img_range + mean)[..., :4 * h, :4 * w]


def build(cfg: dict) -> SwinIR:
    """The reference of a configuration's ``model`` (``benchmark/configs/``)
    on the default device."""
    m = cfg["model"]
    return SwinIR(embed_dim=m["embed_dim"], depths=tuple(m["depths"]),
                  num_heads=tuple(m["num_heads"]),
                  window_size=m["window_size"], mlp_ratio=m["mlp_ratio"],
                  img_size=m["img_size"], img_range=m["img_range"],
                  resi_connection=m["resi_connection"],
                  num_feat=m["num_feat"], in_chans=m["in_chans"],
                  out_chans=m["out_chans"], upscale=m["upscale"],
                  upsampler=m["upsampler"])


def nhwc(model: SwinIR, x: torch.Tensor) -> torch.Tensor:
    """The forward of NHWC tiles, NHWC out, with no autograd."""
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
