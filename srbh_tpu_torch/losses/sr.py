"""SR losses: perceptual, GAN, L1, TV, Charbonnier and the regularisers.

Counterpart of ``srbh_tpu/losses/sr.py`` (SR/srloss.py), on NCHW tensors:

* :func:`perceptual_loss` (:106-139): weighted L1 (or L2) over feature
  lists, the ground truth's features detached;
* :func:`gan_loss` (:144-245): ``vanilla`` (BCE with logits), ``lsgan``,
  ``wgan``, ``wgan_softplus``, ``hinge``; ``loss_weight`` scales generator
  calls only;
* :func:`l1_loss`, :func:`tv_loss` (:251-274), :func:`charbonnier_loss`
  (:280-290, eps 1e-9);
* :func:`r1_penalty` (:294-308), :func:`g_path_regularize` (:311-323),
  :func:`gradient_penalty_loss` (:326-360), through
  ``torch.autograd.grad(create_graph=True)``. Their random draws (the
  path-length noise, the interpolation weights) are passed in, or drawn from
  an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

DEFAULT_PERCEPTUAL_WEIGHTS = (0.1, 0.1, 1.0, 1.0, 1.0)


def perceptual_loss(feats_x: Sequence[torch.Tensor],
                    feats_gt: Sequence[torch.Tensor],
                    weights: Sequence[float] = DEFAULT_PERCEPTUAL_WEIGHTS,
                    lossfn: str = "l1", loss_weight: float = 1.0) -> torch.Tensor:
    """Weighted feature-space distance; the ground truth's features carry no
    gradient."""
    total = 0.0
    for w, a, b in zip(weights, feats_x, feats_gt):
        d = a - b.detach()
        total = total + w * (d.abs().mean() if lossfn == "l1" else (d * d).mean())
    return total * loss_weight


def _bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy of logits: the GAN's vanilla loss and the
    segmentation composites' BCE term."""
    return F.binary_cross_entropy_with_logits(logits, target)


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_type: str = "vanilla",
             is_disc: bool = False, real_label: float = 1.0,
             fake_label: float = 0.0, loss_weight: float = 1.0) -> torch.Tensor:
    if gan_type == "vanilla":
        target = real_label if target_is_real else fake_label
        loss = _bce_with_logits(pred, torch.full_like(pred, target))
    elif gan_type == "lsgan":
        target = real_label if target_is_real else fake_label
        loss = ((pred - target) ** 2).mean()
    elif gan_type == "wgan":
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == "wgan_softplus":
        loss = F.softplus(-pred if target_is_real else pred).mean()
    elif gan_type == "hinge":
        if is_disc:
            loss = F.relu(1 + (-pred if target_is_real else pred)).mean()
        else:
            loss = -pred.mean()
    else:
        raise NotImplementedError(f"GAN type {gan_type}")
    return loss if is_disc else loss * loss_weight


def l1_loss(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (x - gt).abs().mean()


def tv_loss(x: torch.Tensor, loss_weight: float = 1.0) -> torch.Tensor:
    """Total variation of an NCHW batch: squared differences over each
    axis's element count (batch included), x2."""
    dh = x[:, :, 1:] - x[:, :, :-1]
    dw = x[:, :, :, 1:] - x[:, :, :, :-1]
    return loss_weight * 2 * ((dh * dh).sum() / dh.numel()
                              + (dw * dw).sum() / dw.numel())


def charbonnier_loss(x: torch.Tensor, gt: torch.Tensor,
                     eps: float = 1e-9) -> torch.Tensor:
    return torch.sqrt((x - gt) ** 2 + eps).mean()


def _input_grad(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """d sum(fn(x)) / dx, kept in the graph. A tensor outside any graph
    becomes a leaf that requires its gradient."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(x).sum(), x, create_graph=True)[0]


def r1_penalty(disc_fn: Callable, real: torch.Tensor) -> torch.Tensor:
    """R1: the batch mean of |grad D(x)|^2 on real images."""
    return (_input_grad(disc_fn, real) ** 2).sum() / real.shape[0]


def g_path_regularize(fake_fn: Callable, latents: torch.Tensor,
                      mean_path_length, decay: float = 0.01,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """StyleGAN2's path-length regulariser: returns (penalty, mean path
    length, new running mean). ``noise`` has the shape of
    ``fake_fn(latents)`` (N, C, H, W), one independent draw per example;
    ``None`` draws it from ``generator``. ``fake_fn`` must treat examples
    independently (the JAX package takes each example's gradient apart)."""
    z = latents.detach().requires_grad_(True)
    img = fake_fn(z)
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, device=img.device)
    scale = (img.shape[2] * img.shape[3]) ** 0.5
    grads = torch.autograd.grad((img * noise / scale).sum(), z,
                                create_graph=True)[0]
    if grads.ndim >= 3:  # (B, L, D): the mean over the layer axis
        g2 = grads.reshape(grads.shape[0], grads.shape[1], -1)
        path_lengths = torch.sqrt((g2 ** 2).sum(2).mean(1))
    else:
        path_lengths = torch.sqrt((grads ** 2).sum(1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = ((path_lengths - path_mean) ** 2).mean()
    return penalty, path_lengths.mean(), path_mean


def gradient_penalty_loss(disc_fn: Callable, real: torch.Tensor,
                          fake: torch.Tensor, weight: Optional[torch.Tensor] = None,
                          alpha: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """WGAN-GP on ``real + alpha (fake - real)``, ``alpha`` (N, 1, 1, 1)
    uniform (drawn from ``generator`` if not given); the norm of each
    pixel's gradient over the channels."""
    if alpha is None:
        alpha = torch.rand(real.shape[0], 1, 1, 1, generator=generator,
                           device=real.device)
    grad = _input_grad(disc_fn, real + alpha * (fake - real))
    if weight is not None:
        grad = grad * weight
    loss = ((torch.sqrt((grad ** 2).sum(1)) - 1.0) ** 2).mean()
    if weight is not None:
        loss = loss / weight.mean()
    return loss
