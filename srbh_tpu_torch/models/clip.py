"""The CLIP, CLIPA and SigLIP image towers of CLIPScore (NCHW input).

Counterpart of ``srbh_tpu/models/clip.py`` (the encoders of
``calculate_clipscore``, SR/psnr_ssim.py:493-560):

* :class:`ResidualAttentionBlock`: a pre-LN transformer block under
  open_clip's / OpenAI CLIP's names (``ln_1``, ``attn.in_proj_weight`` /
  ``in_proj_bias`` (the fused q/k/v projection of ``nn.MultiheadAttention``),
  ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``);
* :class:`CLIPVisionTransformer`: the ViT tower with a class token, names
  ``conv1``, ``class_embedding``, ``positional_embedding``, ``ln_pre``,
  ``transformer.resblocks.{i}``, ``ln_post``, ``proj``; the ViT-B/16
  preset (QuickGELU) and open_clip's CLIPA bigG-336 (exact GELU, no
  ``ln_pre``, mean over the patch tokens, ``ln_post`` after the pool);
* :class:`MAPVisionTransformer`: the SigLIP SO400M trunk under timm's names
  (``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.norm1 / attn.qkv /
  attn.proj / norm2 / mlp.fc1 / mlp.fc2``, ``norm``), LayerNorm eps 1e-6,
  exact GELU, and timm's ``AttentionPoolLatent`` head (``attn_pool.latent /
  q / kv / proj / norm / mlp``).

The JAX package's attention is plain ``einsum`` + ``softmax``; here it is
``F.scaled_dot_product_attention`` with its default 1/sqrt(d) scale.

:func:`convert_clip_visual` and :func:`convert_siglip_visual` take a
published state dict (a whole CLIP model's, or its image tower's under
``visual.`` / ``visual.trunk.``) and return the towers' own state dicts: the
keys the JAX package's converters read, without the prefix.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x):
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _act(use_quick_gelu: bool):
    return quick_gelu if use_quick_gelu else F.gelu


def attention(q, k, v, heads: int):
    """Multi-head attention of (B, Nq, W) queries over (B, Nk, W) keys and
    values."""
    b, nq, w = q.shape
    split = lambda t: t.reshape(b, t.shape[1], heads, w // heads).transpose(1, 2)  # noqa: E731
    out = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(b, nq, w)


class _FusedAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: one (3W, W) in-projection."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        return self.out_proj(attention(q, k, v, self.heads))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, use_quick_gelu: bool = True,
                 mlp_dim: Optional[int] = None, ln_eps: float = 1e-5):
        super().__init__()
        mlp_dim = mlp_dim or 4 * width
        self.act = _act(use_quick_gelu)
        self.ln_1 = nn.LayerNorm(width, eps=ln_eps)
        self.attn = _FusedAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=ln_eps)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, mlp_dim)
        self.mlp.c_proj = nn.Linear(mlp_dim, width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp.c_proj(self.act(self.mlp.c_fc(self.ln_2(x))))


class CLIPVisionTransformer(nn.Module):
    """The ViT image tower; defaults are ViT-B/16 at 224 px, 512-d out.
    Input NCHW; returns (B, output_dim)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, use_quick_gelu: bool = True,
                 mlp_dim: Optional[int] = None, ln_pre: bool = True,
                 pool: str = "tok", final_ln_after_pool: bool = False):
        super().__init__()
        self.image_size, self.pool = image_size, pool
        self.final_ln_after_pool = final_ln_after_pool
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width) if ln_pre else None
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, use_quick_gelu, mlp_dim)
            for _ in range(layers))
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def _pool(self, x):
        return x[:, 1:].mean(dim=1) if self.pool == "avg" else x[:, 0]

    def forward(self, x):
        x = self.conv1(x).flatten(2).transpose(1, 2)  # (B, grid^2, width)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        # open_clip's final_ln_after_pool pools first; OpenAI CLIP norms the
        # class token (the same as norming every token, then pooling)
        x = (self.ln_post(self._pool(x)) if self.final_ln_after_pool
             else self._pool(self.ln_post(x)))
        return x @ self.proj.to(x.dtype)


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _TimmAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, -1)
        return self.proj(attention(q, k, v, self.heads))


class _TimmBlock(nn.Module):
    """timm's ViT block: the same math as :class:`ResidualAttentionBlock`
    with exact GELU and eps 1e-6."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = _TimmAttention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = _Mlp(width, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AttentionPoolLatent(nn.Module):
    """timm's MAP head: a learned probe query attends over the tokens, then
    a residual MLP; returns the probe's (B, width)."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.latent = nn.Parameter(torch.zeros(1, 1, width))
        self.q = nn.Linear(width, width)
        self.kv = nn.Linear(width, 2 * width)
        self.proj = nn.Linear(width, width)
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.mlp = _Mlp(width, mlp_dim)

    def forward(self, x):
        q = self.q(self.latent.to(x.dtype).expand(x.shape[0], -1, -1))
        k, v = self.kv(x).chunk(2, -1)
        y = self.proj(attention(q, k, v, self.heads))
        return (y + self.mlp(self.norm(y)))[:, 0]


class MAPVisionTransformer(nn.Module):
    """The SigLIP image trunk (defaults: SO400M/14 at 384 px). Input NCHW;
    returns the pooled (B, width) feature, SigLIP's ``encode_image``."""

    def __init__(self, image_size: int = 384, patch_size: int = 14,
                 width: int = 1152, layers: int = 27, heads: int = 16,
                 mlp_dim: int = 4304):
        super().__init__()
        self.image_size = image_size
        grid = image_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, patch_size, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, width))
        self.blocks = nn.ModuleList(_TimmBlock(width, heads, mlp_dim)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.attn_pool = AttentionPoolLatent(width, heads, mlp_dim)

    def forward(self, x):
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.attn_pool(self.norm(x))


def _strip(sd: Mapping, prefixes) -> dict:
    """``sd`` with the first matching prefix cut off each key, as tensors."""
    out = {}
    for k, v in sd.items():
        for pre in prefixes:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = torch.as_tensor(v)
    return out


def convert_clip_visual(sd: Mapping, layers: int = 12) -> dict:
    """An OpenAI CLIP / open_clip state dict, with or without the
    ``visual.`` prefix, -> :class:`CLIPVisionTransformer`'s state dict of
    ``layers`` blocks (``ln_pre`` only where the file has it: CLIPA's
    have none). The text tower and other keys are dropped; a missing key
    raises ``KeyError``."""
    sd = _strip(sd, ("visual.",))
    keys = ["conv1.weight", "class_embedding", "positional_embedding",
            "ln_post.weight", "ln_post.bias", "proj"]
    if "ln_pre.weight" in sd:
        keys += ["ln_pre.weight", "ln_pre.bias"]
    for i in range(layers):
        t = f"transformer.resblocks.{i}."
        keys += [t + n for n in (
            "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
            "attn.in_proj_weight", "attn.in_proj_bias",
            "attn.out_proj.weight", "attn.out_proj.bias",
            "mlp.c_fc.weight", "mlp.c_fc.bias",
            "mlp.c_proj.weight", "mlp.c_proj.bias")]
    return {k: sd[k] for k in keys}


def convert_siglip_visual(sd: Mapping, layers: int = 27) -> dict:
    """A timm / open_clip SigLIP state dict, with or without the
    ``visual.trunk.`` (or ``trunk.``) prefix, -> :class:`MAPVisionTransformer`'s
    state dict of ``layers`` blocks: ``pos_embed`` as (1, N, C) whether
    stored so (timm) or as (N, C), the ``attn_pool.latent`` as (1, 1, C).
    Other keys are dropped; a missing key raises ``KeyError``."""
    sd = _strip(sd, ("visual.trunk.", "trunk."))
    out = {"pos_embed": sd["pos_embed"].reshape(1, -1, sd["pos_embed"].shape[-1]),
           "attn_pool.latent": sd["attn_pool.latent"].reshape(1, 1, -1)}
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias",
            "norm.weight", "norm.bias"]
    keys += [f"attn_pool.{n}.{p}" for n in ("q", "kv", "proj", "norm",
                                            "mlp.fc1", "mlp.fc2")
             for p in ("weight", "bias")]
    for i in range(layers):
        keys += [f"blocks.{i}.{n}.{p}" for n in ("norm1", "norm2", "attn.qkv",
                                                 "attn.proj", "mlp.fc1",
                                                 "mlp.fc2")
                 for p in ("weight", "bias")]
    out.update({k: sd[k] for k in keys})
    return out
