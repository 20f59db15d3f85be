"""SwinIR: window-attention image restoration (SR / denoise / JPEG CAR).

Counterpart of ``srbh_tpu/models/swinir.py`` (SR/network_swinir.py). The
model takes and returns NCHW images; inside the Swin blocks the features are
(B, H, W, C), so LayerNorm and the window partition work on the last axis.

* Window attention goes through the Hopper kernel
  (``ops/window_attention.py``) when ``use_kernel`` is True, else through
  its plain PyTorch version; on CPU tensors both are the plain version.
* Shifted windows use ``torch.roll`` by ``(-shift, -shift)`` / ``(shift,
  shift)`` and the 9-region additive -100 mask. Whether a block shifts, and
  its window size, are decided once from ``img_size`` (the training patch
  size), as the reference does (network_swinir.py:178-183), not from the
  runtime feature size.
* Inputs are reflect-padded to a window multiple and cropped back; RGB mean
  and ``img_range`` normalise them.
* Heads: 'pixelshuffle', 'pixelshuffledirect', 'nearest+conv' and '' (the
  denoise / JPEG CAR global residual); RSTB tails '1conv' and '3conv'.

State-dict names are the reference's (``layers.{l}.residual_group.blocks.
{b}.*``, ``layers.{l}.conv``, ``patch_embed.norm``, ``norm``, ...). The
reference's derived buffers ``relative_position_index`` and ``attn_mask`` are
recomputed here and are not part of the state dict.

Inference only: drop-path, which only training uses, is not ported.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import PixelShuffleUpsampler, tconv
from srbh_tpu_torch.ops.resize import upsample_nearest
from srbh_tpu_torch.ops.shuffle import pixel_shuffle
from srbh_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_reference,
)

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows image-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) indices into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws^2, ws^2) additive mask (0 / -100) for shifted windows."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, vs] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_shift_mask(h: int, w: int, ws: int, shift: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`shift_attn_mask` on ``device``, made once per shape; callers
    only read it."""
    return torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(device)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative-position
    bias. ``use_kernel`` selects the Hopper kernel over the plain version."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qk_scale: Optional[float] = None, use_kernel: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.use_kernel = use_kernel
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x, mask=None):
        """x: (B_, N, C) windows; mask: (nW, N, N) or None."""
        b_, n, c = x.shape
        heads = self.num_heads
        head_dim = c // heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, head_dim)
        q, k, v = qkv.permute(2, 3, 0, 1, 4).unbind(0)  # (heads, B_, N, d) views
        if self.qk_scale is not None:
            q = q * (self.qk_scale * head_dim ** 0.5)  # fold custom scale in
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, heads).permute(2, 0, 1)
        fn = window_attention if self.use_kernel else window_attention_reference
        out = fn(q, k, v, bias, mask)  # (heads, B_, N, d)
        return self.proj(out.permute(1, 2, 0, 3).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    """Swin block on (B, H, W, C) features. ``img_size`` fixes the window
    clamp and the shift decision."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 img_size: int = 64, use_kernel: bool = True):
        super().__init__()
        self.window_size = min(window_size, img_size)
        self.shift_size = 0 if img_size <= window_size else shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, self.window_size, num_heads,
                                    use_kernel=use_kernel)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _device_shift_mask(h, w, ws, shift, x.device)
        attn = self.attn(window_partition(x, ws), mask)
        x = window_reverse(attn, ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """The Swin blocks of one RSTB (``residual_group``); odd blocks shift."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, img_size: int, use_kernel: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(
                dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, img_size=img_size, use_kernel=use_kernel)
            for i in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer block group with a '1conv' or '3conv' tail."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, resi_connection: str = "1conv",
                 img_size: int = 64, use_kernel: bool = True):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio, img_size, use_kernel)
        if resi_connection == "1conv":
            self.conv = tconv(dim, dim, 3)
        elif resi_connection == "3conv":
            mid = dim // 4
            self.conv = nn.Sequential(
                tconv(dim, mid, 3), nn.LeakyReLU(0.2),
                tconv(mid, mid, 1), nn.LeakyReLU(0.2),
                tconv(mid, dim, 3))
        else:
            raise ValueError(f"unknown resi_connection {resi_connection!r}")

    def forward(self, x):
        """x: (B, H, W, C)."""
        y = self.residual_group(x).permute(0, 3, 1, 2)
        return self.conv(y).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinIR(nn.Module):
    def __init__(self, in_chans: int = 3, out_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv",
                 num_feat: int = 64,
                 img_size: int = 64, use_kernel: bool = True):
        super().__init__()
        self.window_size = window_size
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        mean = RGB_MEAN if in_chans == 3 else (0.0,)
        self.register_buffer("mean", torch.tensor(mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = tconv(in_chans, embed_dim, 3)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, depth, heads, window_size, mlp_ratio,
                 resi_connection, img_size, use_kernel)
            for depth, heads in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = tconv(embed_dim, embed_dim, 3)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(
                tconv(embed_dim, num_feat, 3), nn.LeakyReLU(0.01))
            self.upsample = PixelShuffleUpsampler(upscale, num_feat)
            self.conv_last = tconv(num_feat, out_chans, 3)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                tconv(embed_dim, out_chans * upscale ** 2, 3))
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(
                tconv(embed_dim, num_feat, 3), nn.LeakyReLU(0.01))
            self.conv_up1 = tconv(num_feat, num_feat, 3)
            if upscale == 4:
                self.conv_up2 = tconv(num_feat, num_feat, 3)
            self.conv_hr = tconv(num_feat, num_feat, 3)
            self.conv_last = tconv(num_feat, out_chans, 3)
        elif upsampler == "":
            self.conv_last = tconv(embed_dim, out_chans, 3)
        else:
            raise ValueError(f"unknown upsampler {upsampler!r}")

    def forward_features(self, x):
        """(B, C, H, W) -> (B, C, H, W) through the RSTBs."""
        f = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        for layer in self.layers:
            f = layer(f)
        return self.norm(f).permute(0, 3, 1, 2)

    def forward(self, x):
        """x: (B, C, H, W) in [0, 1]; returns the (upscaled) image."""
        h_in, w_in = x.shape[-2:]
        ws = self.window_size
        pad_h = (ws - h_in % ws) % ws
        pad_w = (ws - w_in % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range

        feat = self.conv_first(x)
        feat = self.conv_after_body(self.forward_features(feat)) + feat
        lrelu = lambda t: F.leaky_relu(t, 0.2)
        if self.upsampler == "pixelshuffle":
            out = self.conv_last(self.upsample(self.conv_before_upsample(feat)))
        elif self.upsampler == "pixelshuffledirect":
            out = pixel_shuffle(self.upsample(feat), self.upscale)
        elif self.upsampler == "nearest+conv":
            feat = self.conv_before_upsample(feat)
            feat = lrelu(self.conv_up1(upsample_nearest(feat, 2)))
            if self.upscale == 4:
                feat = lrelu(self.conv_up2(upsample_nearest(feat, 2)))
            out = self.conv_last(lrelu(self.conv_hr(feat)))
        else:
            out = x + self.conv_last(feat)
        out = out / self.img_range + mean
        return out[..., : h_in * self.upscale, : w_in * self.upscale]
