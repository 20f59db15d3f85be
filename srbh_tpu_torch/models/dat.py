"""DAT: the Dual Aggregation Transformer for image super-resolution.

Chen et al., "Dual Aggregation Transformer for Image Super-Resolution",
ICCV 2023 (arXiv:2308.03364), ``basicsr/archs/dat_arch.py``. Module and
parameter names are that file's, so that a published state dict loads by
name; its derived buffers (``rpe_biases``, ``relative_position_index``,
``attn_mask_0`` / ``attn_mask_1``) are recomputed here and are not part of
the state dict (``tools/swinir_harness.load_weights`` drops them).

The model takes and returns NCHW images; between blocks the tokens are
(B, H, W, C), so LayerNorm and the linears work on the last axis. Residual
groups alternate two blocks (``DATB``), each ``x + attn(norm1(x))`` then
``x + ffn(norm2(x))``:

* even blocks, :class:`AdaptiveSpatialAttention`: one ``qkv`` linear; half
  the channels attend in 8 x 32 windows, half in 32 x 8 (256 tokens), each
  with a position bias from a small MLP (:class:`DynamicPosBias`); some
  blocks shift both by half a window and mask the nine regions (Swin's
  -100). A depthwise-conv branch on v runs beside it, and two sigmoid gates
  cross the branches: the conv branch's pooled channels gate the attention,
  the attention's per-pixel map gates the conv branch;
* odd blocks, :class:`AdaptiveChannelAttention`: attention across channels
  over all tokens (L2-normalised q and k, a learned temperature a head),
  the same conv branch and gates, crossed the other way;
* every block's FFN is :class:`SGFN`: ``fc1``, GELU, the second half of the
  channels through LayerNorm and a depthwise 3 x 3 gating the first half,
  ``fc2``.

The relative-position index and the shift mask are SwinIR's
(``models/swinir.py``), for rectangles; a branch cuts its q, k and v into
windows in one copy; the attention products are ``ops/dat_attention.py``'s
(a library route on a card: the hand kernel stops at 64 tokens a window).
What depends on the weights alone is made by ``prepare()`` and kept in
non-persistent buffers: each branch's position bias, and each attention
module's BatchNorms folded into the convs before them, the 1 x 1 convs of
the gates as linear weights on the (B, H, W, C) tokens. ``prepare()`` runs
at construction and after every ``load_state_dict``; a caller that writes
weights in place (an initialiser, an average of weights) calls
:meth:`DAT.prepare` after it. A forward launches ~1700 kernels (batch 8,
64 x 64), and a card's host has to keep ahead of them. Inference only: the
published drop-path (training) is left out, and a forward in training mode
raises.

Spans (``utils/profiler.py``): ``dat.body`` (the residual groups, the last
LayerNorm and ``conv_after_body``) and ``dat.upsample`` (the pixel-shuffle
head), each with ``device=True``; host-only ``dat.group`` around each
residual group, ``dat.spatial_attn`` / ``dat.channel_attn`` around each
attention module, ``dat.sgfn`` around each FFN and ``dat.spatial_core``
around each window branch's attention product (q, k, v to its output).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import PixelShuffleUpsampler, tconv
from srbh_tpu_torch.models.swinir import (
    RGB_MEAN,
    _device_shift_mask,
    relative_position_index,
)
from srbh_tpu_torch.ops.dat_attention import (
    channel_attention,
    rect_window_attention,
)
from srbh_tpu_torch.utils import profiler


def is_shifted(group: int, block: int) -> bool:
    """Whether spatial block ``block`` of residual group ``group`` shifts
    its windows (dat_arch.py's rule: blocks 2, 6, 10, ... of even groups,
    blocks 0, 4, 8, ... of odd ones)."""
    if group % 2 == 0:
        return block > 0 and (block - 2) % 4 == 0
    return block % 4 == 0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _prepare_on_load(module, incompatible_keys) -> None:
    """``load_state_dict``'s post-hook: the module's derived tensors anew."""
    module.prepare()


class _Derived(nn.Module):
    """A module that keeps tensors derived from its weights alone as
    non-persistent buffers, made by its ``prepare()``. A subclass calls
    :meth:`_derive` at the end of its ``__init__``."""

    def _derive(self) -> None:
        self.register_load_state_dict_post_hook(_prepare_on_load)
        self.prepare()

    def prepare(self) -> None:
        raise NotImplementedError


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> tuple:
    """(weight, bias) of ``conv`` followed by ``bn`` on its running
    statistics."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    w = conv.weight * s.view(-1, *(1,) * (conv.weight.dim() - 1))
    return w, (conv.bias - bn.running_mean) * s + bn.bias


def _conv_branch_out(v, w, b):
    """The conv branch on v (B, H, W, C): depthwise 3 x 3 with its
    BatchNorm folded in, GELU; (B, H, W, C)."""
    return _nhwc(F.gelu(F.conv2d(_nchw(v), w, b, padding=1,
                                 groups=v.shape[-1])))


def _channel_map(x, w1, b1, w2, b2):
    """(B, 1, 1, C) from x (B, H, W, C): the average over the pixels,
    1 x 1 conv (BatchNorm folded), GELU, 1 x 1 conv."""
    return F.linear(F.gelu(F.linear(x.mean((1, 2)), w1, b1)), w2,
                    b2)[:, None, None]


def _spatial_map(x, w1, b1, w2, b2):
    """(B, H, W, 1) from x (B, H, W, C): 1 x 1 conv (BatchNorm folded),
    GELU, 1 x 1 conv to one channel."""
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


class ToTokens(nn.Module):
    """NCHW -> (B, H, W, C) tokens (the published ``Rearrange``)."""

    def forward(self, x):
        return _nhwc(x)


class DynamicPosBias(nn.Module):
    """The position bias MLP of a window branch (``residual=False``): the
    (dy, dx) offsets through ``pos_proj`` and three (LayerNorm, ReLU,
    Linear) stages to one bias a head."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        pos_dim = dim // 4
        self.pos_proj = nn.Linear(2, pos_dim)
        self.pos1 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(),
                                  nn.Linear(pos_dim, pos_dim))
        self.pos2 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(),
                                  nn.Linear(pos_dim, pos_dim))
        self.pos3 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(),
                                  nn.Linear(pos_dim, num_heads))

    def forward(self, biases):
        return self.pos3(self.pos2(self.pos1(self.pos_proj(biases))))


class SpatialAttention(_Derived):
    """One window branch (``Spatial_Attention``): ``idx`` 0 attends in
    ``split_size[0] x split_size[1]`` windows (height x width), ``idx`` 1
    in the transposed ones."""

    def __init__(self, dim: int, idx: int, split_size: Sequence[int],
                 num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        sp = tuple(split_size)
        self.window = sp if idx == 0 else sp[::-1]
        wh, ww = self.window
        self.pos = DynamicPosBias(dim // 4, num_heads)
        dy, dx = torch.meshgrid(torch.arange(1 - wh, wh),
                                torch.arange(1 - ww, ww), indexing="ij")
        self.register_buffer(
            "rpe_biases", torch.stack((dy, dx), -1).reshape(-1, 2).float(),
            persistent=False)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(self.window).reshape(-1)),
            persistent=False)
        self._derive()

    @torch.no_grad()
    def prepare(self) -> None:
        """The (1, heads, N, N) position bias of every window, ``bias``."""
        n = self.window[0] * self.window[1]
        pos = self.pos(self.rpe_biases)[self.relative_position_index]
        self.register_buffer("bias", pos.view(n, n, -1).permute(2, 0, 1)[None]
                             .contiguous(), persistent=False)

    def forward(self, qkv, mask=None):
        """qkv: (B, H, W, 3, c) of this branch, H and W multiples of the
        window; mask (nW, N, N) or ``None``. Returns (B, H, W, c)."""
        b, h, w, _, c = qkv.shape
        heads, (wh, ww) = self.num_heads, self.window
        d = c // heads
        # (3, B, nW, heads, N, d) in one copy
        t = qkv.reshape(b, h // wh, wh, w // ww, ww, 3, heads, d)
        t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, -1, heads,
                                                       wh * ww, d)
        add = self.bias if mask is None else self.bias + mask[:, None]
        with profiler.span("dat.spatial_core"):
            out = rect_window_attention(t, add)
        out = out.reshape(b, h // wh, w // ww, heads, wh, ww, d)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)


def _conv_branch(dim: int) -> nn.Sequential:
    return nn.Sequential(tconv(dim, dim, 3, groups=dim), nn.BatchNorm2d(dim),
                         nn.GELU())


def _channel_interaction(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), tconv(dim, dim // 8, 1),
                         nn.BatchNorm2d(dim // 8), nn.GELU(),
                         tconv(dim // 8, dim, 1))


def _spatial_interaction(dim: int) -> nn.Sequential:
    return nn.Sequential(tconv(dim, dim // 16, 1), nn.BatchNorm2d(dim // 16),
                         nn.GELU(), tconv(dim // 16, 1, 1))


_GATES = ("conv_w", "conv_b", "cmap_w1", "cmap_b1", "cmap_w2", "cmap_b2",
          "smap_w1", "smap_b1", "smap_w2", "smap_b2")


class _Gated(_Derived):
    """The conv branch and the two interaction maps that both attention
    modules share, with each BatchNorm folded into the conv before it and
    the 1 x 1 convs as linear weights, kept as the buffers :data:`_GATES`:
    the depthwise conv's weight and bias, then the weight and bias of each
    of the channel map's two linears and the spatial map's two."""

    def _gates(self, dim: int) -> None:
        self.dwconv = _conv_branch(dim)
        self.channel_interaction = _channel_interaction(dim)
        self.spatial_interaction = _spatial_interaction(dim)
        self._derive()

    @torch.no_grad()
    def prepare(self) -> None:
        ci, si = self.channel_interaction, self.spatial_interaction
        c1, s1 = _fold(ci[1], ci[2]), _fold(si[0], si[1])
        made = (*_fold(self.dwconv[0], self.dwconv[1]), c1[0].flatten(1),
                c1[1], ci[4].weight.flatten(1), ci[4].bias, s1[0].flatten(1),
                s1[1], si[3].weight.flatten(1), si[3].bias)
        for name, t in zip(_GATES, made):
            self.register_buffer(name, t.clone(), persistent=False)

    def conv_branch(self, v):
        """The conv branch on v (B, H, W, C)."""
        return _conv_branch_out(v, self.conv_w, self.conv_b)

    def channel_map(self, x):
        return _channel_map(x, self.cmap_w1, self.cmap_b1, self.cmap_w2,
                            self.cmap_b2)

    def spatial_map(self, x):
        return _spatial_map(x, self.smap_w1, self.smap_b1, self.smap_w2,
                            self.smap_b2)


class AdaptiveSpatialAttention(_Gated):
    """``Adaptive_Spatial_Attention``: two window branches on the two
    halves of the channels, the conv branch and the gates. ``shift``: the
    block shifts its windows by half a window."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int],
                 qkv_bias: bool = True, shift: bool = False):
        super().__init__()
        self.split_size = tuple(split_size)
        self.shift = shift
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attns = nn.ModuleList(
            SpatialAttention(dim // 2, i, split_size, num_heads // 2)
            for i in range(2))
        self._gates(dim)

    def attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """The two branches' attention output (B, H, W, C) from the qkv
        projection (B, H, W, 3C): zero-padded to a multiple of the longer
        window side, shifted and masked where the block shifts."""
        b, h, w, c3 = qkv.shape
        half = c3 // 6
        big = max(self.split_size)
        pad_b, pad_r = -h % big, -w % big
        if pad_b or pad_r:
            qkv = F.pad(qkv, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        qkv = qkv.view(b, hp, wp, 3, c3 // 3)
        outs = []
        for i, branch in enumerate(self.attns):
            part = qkv[..., i * half:(i + 1) * half]
            mask = None
            if self.shift:
                wh, ww = branch.window
                s = (wh // 2, ww // 2)
                part = torch.roll(part, (-s[0], -s[1]), (1, 2))
                mask = _device_shift_mask(hp, wp, branch.window, s, qkv.device)
            out = branch(part, mask)
            if self.shift:
                out = torch.roll(out, s, (1, 2))
            outs.append(out[:, :h, :w])
        return torch.cat(outs, -1)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H, W, C)."""
        with profiler.span("dat.spatial_attn"):
            c = x.shape[-1]
            qkv = self.qkv(x)
            attn = self.attend(qkv)
            conv = self.conv_branch(qkv[..., 2 * c:])
            # the conv branch's channels gate the attention, the
            # attention's pixels gate the conv branch
            out = torch.addcmul(
                attn * torch.sigmoid(self.channel_map(conv)), conv,
                torch.sigmoid(self.spatial_map(attn)))
            return self.proj(out)


class AdaptiveChannelAttention(_Gated):
    """``Adaptive_Channel_Attention``: transposed attention over channels,
    the conv branch and the gates, crossed as the published file crosses
    them."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self._gates(dim)

    def attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """The attention output (B, H, W, C) from the qkv projection."""
        b, h, w, c3 = qkv.shape
        c = c3 // 3
        heads = self.num_heads
        # (B, N, 3, heads, d) -> (3, B, heads, d, N)
        t = qkv.reshape(b, h * w, 3, heads, c // heads).permute(2, 0, 3, 4, 1)
        out = channel_attention(t, self.temperature)
        return out.permute(0, 3, 1, 2).reshape(b, h, w, c)

    def forward(self, x):
        with profiler.span("dat.channel_attn"):
            c = x.shape[-1]
            qkv = self.qkv(x)
            attn = self.attend(qkv)
            conv = self.conv_branch(qkv[..., 2 * c:])
            # crossed the other way: the conv branch's pixels gate the
            # attention, the attention's channels gate the conv branch
            out = torch.addcmul(
                attn * torch.sigmoid(self.spatial_map(conv)), conv,
                torch.sigmoid(self.channel_map(attn)))
            return self.proj(out)


class SpatialGate(nn.Module):
    """SGFN's gate: the second half of the channels through LayerNorm and a
    depthwise 3 x 3 times the first half."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.conv = tconv(dim, dim, 3, groups=dim)

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=-1)
        return x1 * _nhwc(self.conv(_nchw(self.norm(x2))))


class SGFN(nn.Module):
    """The spatial-gate feed-forward network."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, x):
        with profiler.span("dat.sgfn"):
            return self.fc2(self.sg(F.gelu(self.fc1(x))))


class DATB(nn.Module):
    """One block: spatial attention at even ``block``, channel attention at
    odd ones, then the SGFN."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int],
                 expansion_factor: float, qkv_bias: bool, group: int,
                 block: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        if block % 2 == 0:
            self.attn = AdaptiveSpatialAttention(
                dim, num_heads, split_size, qkv_bias,
                shift=is_shifted(group, block))
        else:
            self.attn = AdaptiveChannelAttention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = SGFN(dim, int(dim * expansion_factor))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class ResidualGroup(nn.Module):
    """``depth`` blocks, a 3 x 3 conv, plus the group's input."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 split_size: Sequence[int], expansion_factor: float,
                 qkv_bias: bool, group: int, resi_connection: str = "1conv"):
        super().__init__()
        if resi_connection != "1conv":
            raise ValueError(f"resi_connection {resi_connection!r}: the port "
                             "builds '1conv'")
        self.blocks = nn.ModuleList(
            DATB(dim, num_heads, split_size, expansion_factor, qkv_bias,
                 group, i) for i in range(depth))
        self.conv = tconv(dim, dim, 3)

    def forward(self, x):
        """x: (B, H, W, C)."""
        with profiler.span("dat.group"):
            y = x
            for block in self.blocks:
                y = block(y)
            return _nhwc(self.conv(_nchw(y))) + x


class DAT(nn.Module):
    """DAT with the ``pixelshuffle`` head (the published SR presets)."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 split_size: Sequence[int] = (8, 32),
                 depth: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6,
                 expansion_factor: float = 4.0, qkv_bias: bool = True,
                 upscale: int = 4, img_range: float = 1.0,
                 resi_connection: str = "1conv",
                 upsampler: str = "pixelshuffle", num_feat: int = 64):
        super().__init__()
        if upsampler != "pixelshuffle":
            raise ValueError(f"upsampler {upsampler!r}: the port builds "
                             "'pixelshuffle'")
        self.upscale = upscale
        self.img_range = img_range
        mean = RGB_MEAN if in_chans == 3 else (0.0,)
        self.register_buffer("mean", torch.tensor(mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = tconv(in_chans, embed_dim, 3)
        self.before_RG = nn.Sequential(ToTokens(), nn.LayerNorm(embed_dim))
        self.layers = nn.ModuleList(
            ResidualGroup(embed_dim, d, heads, split_size, expansion_factor,
                          qkv_bias, g, resi_connection)
            for g, (d, heads) in enumerate(zip(depth, num_heads)))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = tconv(embed_dim, embed_dim, 3)
        self.conv_before_upsample = nn.Sequential(
            tconv(embed_dim, num_feat, 3), nn.LeakyReLU(0.01))
        self.upsample = PixelShuffleUpsampler(upscale, num_feat)
        self.conv_last = tconv(num_feat, in_chans, 3)

    def prepare(self) -> None:
        """Every module's derived tensors anew from its weights: call it
        after writing weights in place (``load_state_dict`` does it)."""
        for m in self.modules():
            if isinstance(m, _Derived):
                m.prepare()

    def forward_features(self, x):
        """(B, C, H, W) -> (B, C, H, W) through the residual groups."""
        f = self.before_RG(x)
        for layer in self.layers:
            f = layer(f)
        return _nchw(self.norm(f))

    def forward(self, x):
        """x: (B, C, H, W) in [0, 1]; returns the (B, C, sH, sW) image."""
        if self.training:
            raise RuntimeError("the port's DAT is inference only (no "
                               "drop-path): call .eval()")
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        with profiler.span("dat.body", device=True):
            feat = self.conv_after_body(self.forward_features(feat)) + feat
        with profiler.span("dat.upsample", device=True):
            out = self.conv_last(self.upsample(
                self.conv_before_upsample(feat)))
        return out / self.img_range + mean
