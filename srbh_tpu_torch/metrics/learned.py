"""Learned image metrics: CLIPScore and LPIPS.

Counterpart of ``srbh_tpu/metrics/learned.py`` (SR/psnr_ssim.py:493-602),
with the port's towers (``models/clip.py``, ``models/lpips.py``). The
architectures are here; the pretrained weights are not in the repository
and cannot be fetched, so each function takes the reference's torch
``state_dict`` (its own key names: OpenAI CLIP's / open_clip's ``visual.*``
without the prefix, timm's SigLIP trunk, lpips') and raises without one.

The reference's quirks stay:

* HWC [0, 255] images are divided by 255 and resized to the tower's input
  by ``F.interpolate(mode="nearest")`` (SR/psnr_ssim.py:510-517), the rule
  the JAX package imitates in ``_nearest_torch``;
* no CLIP mean / std normalisation (the reference never applies the
  preprocess it unpacks);
* LPIPS gets the [0, 1] images, not lpips' documented [-1, 1];
* only the batched ``_pt`` CLIPScore maps ``"resnet50"`` to the SigLIP tower
  (SR/psnr_ssim.py:539-542); the single-image one refuses it.

The single-image functions run on ``device`` (``None`` is the card); the
``_pt`` ones take NCHW tensors in [0, 1] and run where those lie.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.models.clip import CLIPVisionTransformer, MAPVisionTransformer
from srbh_tpu_torch.models.lpips import LPIPS

# the encoders of SR/psnr_ssim.py:496-507: OpenAI's ViT-B/16, open_clip's
# CLIPA bigG-336 and the reference's default, SigLIP SO400M
CLIP_PRESETS = {
    "clip-ViT-B/16": (CLIPVisionTransformer,
                      dict(image_size=224, patch_size=16, width=768,
                           layers=12, heads=12, output_dim=512,
                           use_quick_gelu=True)),
    "clipa-ViT-bigG-14": (CLIPVisionTransformer,
                          dict(image_size=336, patch_size=14, width=1664,
                               layers=48, heads=16, mlp_dim=8192,
                               output_dim=1280, use_quick_gelu=False,
                               ln_pre=False, pool="avg",
                               final_ln_after_pool=True)),
    "siglip-ViT-SO400M-14": (MAPVisionTransformer,
                             dict(image_size=384, patch_size=14, width=1152,
                                  layers=27, heads=16, mlp_dim=4304)),
}
_PT_ALIASES = {"resnet50": "siglip-ViT-SO400M-14"}
_CLIP_WEIGHTS = ("OpenAI CLIP's or open_clip's visual.* (CLIP, CLIPA) or "
                 "timm's SigLIP trunk")


def _preset(clip_model: str):
    if clip_model not in CLIP_PRESETS:
        raise ValueError(
            f"{clip_model!r} is not supported for CLIPScore "
            f"(available: {sorted(CLIP_PRESETS)}), the error of "
            "SR/psnr_ssim.py:508")
    return CLIP_PRESETS[clip_model]


def clip_vision_model(clip_model: str = "siglip-ViT-SO400M-14"):
    """The preset's tower, unloaded. Build it under ``torch.device(...)``
    to allocate it on a device."""
    cls, kwargs = _preset(clip_model)
    return cls(**kwargs)


def _clip_tower(model, clip_model: str, state_dict, device):
    """``model`` loaded with ``state_dict``, else the preset's tower made of
    it, once the name and the weights have passed their checks."""
    if model is None:
        _preset(clip_model)
    _require(state_dict, "CLIPScore", _CLIP_WEIGHTS)
    device = resolve_device(device)
    if model is None:
        return _assigned(lambda: clip_vision_model(clip_model), state_dict, device)
    return _loaded(model, state_dict, device)


def _lpips(model, state_dict, device):
    """``model`` loaded with ``state_dict``, else an LPIPS made of it."""
    _require(state_dict, "LPIPS", "lpips'")
    device = resolve_device(device)
    if model is None:
        return _assigned(LPIPS, state_dict, device)
    return _loaded(model, state_dict, device)


def _require(state_dict, what: str, names: str):
    if state_dict is None:
        raise ValueError(
            f"{what} needs pretrained weights: pass the reference's torch "
            f"state_dict ({names} names) as `state_dict`; the repository "
            "holds none and cannot fetch them (PSNR/SSIM/cPSNR/PSNR-B need "
            "no weights).")


def _holds(model, state_dict: Mapping) -> bool:
    """Whether ``model``'s tensors already are ``state_dict``'s."""
    own = model.state_dict()
    return own.keys() == state_dict.keys() and all(
        own[k].data_ptr() == v.data_ptr() and own[k].shape == v.shape
        and own[k].dtype == v.dtype and own[k].device == v.device
        for k, v in state_dict.items())


def _loaded(model, state_dict: Mapping, device):
    """``model`` with ``state_dict``'s values on ``device``: no copy when it
    already holds those tensors."""
    if not _holds(model, state_dict):
        model.load_state_dict(state_dict)
    return model.to(device).eval()


def _assigned(build, state_dict: Mapping, device):
    """A tower built on the meta device (no initialisation, no memory) that
    takes ``state_dict``'s tensors as its own, in float32 on ``device``."""
    with torch.device("meta"):
        model = build()
    model.load_state_dict(state_dict, assign=True)
    return model.to(device, torch.float32).eval()


def _nearest_torch(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch's nearest rule, ``src = floor(dst * float32(in / out))``, to a
    square ``size`` (NCHW); a no-op at that size already."""
    if x.shape[2] == size and x.shape[3] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="nearest")


def _rgb(x: torch.Tensor) -> torch.Tensor:
    """1-channel batches are repeated to 3 (SR/psnr_ssim.py:552)."""
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


def _prep(img, device, size: Optional[int] = None) -> torch.Tensor:
    """HWC [0, 255] -> (1, 3, S, S) float [0, 1] on ``device``."""
    x = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device) / 255.0
    if x.ndim == 2:
        x = x[..., None]
    x = _rgb(x.permute(2, 0, 1)[None])
    return x if size is None else _nearest_torch(x, size)


def _cosine(f1, f2) -> float:
    f1 = f1 / torch.linalg.norm(f1, dim=-1, keepdim=True)
    f2 = f2 / torch.linalg.norm(f2, dim=-1, keepdim=True)
    return float(torch.sum(f1 * f2, dim=-1).mean())


@torch.no_grad()
def calculate_clipscore(img, img2, state_dict=None,
                        clip_model: str = "siglip-ViT-SO400M-14", model=None,
                        device=None) -> float:
    """The cosine similarity of two HWC [0, 255] images' embeddings
    (SR/psnr_ssim.py:493-522). ``model`` is loaded with ``state_dict``
    unless it already holds those tensors; without it the preset's tower is
    made of them. Either is moved to ``device``."""
    model = _clip_tower(model, clip_model, state_dict, device)
    dev = resolve_device(device)
    size = model.image_size
    return _cosine(model(_prep(img, dev, size)), model(_prep(img2, dev, size)))


@torch.no_grad()
def calculate_clipscore_pt(imgs, imgs2, state_dict=None,
                           clip_model: str = "siglip-ViT-SO400M-14",
                           model=None) -> float:
    """Batched CLIPScore (SR/psnr_ssim.py:525-560) of NCHW tensors already
    in [0, 1]: the mean of the per-image cosine similarities."""
    model = _clip_tower(model, _PT_ALIASES.get(clip_model, clip_model),
                        state_dict, imgs.device)
    size = model.image_size
    prep = lambda x: _nearest_torch(_rgb(x.float()), size)  # noqa: E731
    return _cosine(model(prep(imgs)), model(prep(imgs2)))


@torch.no_grad()
def calculate_lpips_pt(imgs, imgs2, state_dict=None,
                       model: Optional[LPIPS] = None) -> float:
    """Batched LPIPS (SR/psnr_ssim.py:584-602) of NCHW tensors, fed as
    they are, 1-channel batches repeated; the mean distance."""
    model = _lpips(model, state_dict, imgs.device)
    return float(model(_rgb(imgs.float()), _rgb(imgs2.float())).mean())


@torch.no_grad()
def calculate_lpips(img, img2, state_dict=None, net: str = "alex",
                    model: Optional[LPIPS] = None, device=None) -> float:
    """LPIPS of two HWC [0, 255] images at their own size
    (SR/psnr_ssim.py:563-580), the [0, 1] tensors fed as they are."""
    if net != "alex" and model is None:
        raise ValueError(
            f"net={net!r} not supported (only the 'alex' trunk is "
            "implemented; pass a custom `model` for other backbones)")
    model = _lpips(model, state_dict, device)
    dev = resolve_device(device)
    return float(model(_prep(img, dev), _prep(img2, dev))[0])
