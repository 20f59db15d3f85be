"""Real-ESRGAN GAN training: the fused G + D + EMA step.

Counterpart of ``srbh_tpu/train/sr_trainer.py`` (the ``RealESRGAN`` wrapper,
SR/rrdbnet_arch.py:437-633, and its finetune recipe
SR/finetune_realesrgan_x4plus_pairdata.yml):

* an RRDBNet-23 generator and its EMA copy (decay 0.999), the
  ``UNetDiscriminatorSN`` discriminator, VGG19 perceptual features;
* the generator's loss L1(out, USM(gt)) + perceptual (weights
  [.1, .1, 1, 1, 1]) + 0.1 x vanilla GAN; the discriminator's BCE on
  real = 1 / fake = 0;
* two Adams, optax's ``adam(schedule, b1=0.9, b2=0.99, eps=1e-8)``: no
  decay, and update ``k`` (from 0) at ``schedule(k)``, so with
  ``warmup_iter > 0`` the first update is zero. Each group's ``lr`` is set
  from :func:`multistep_lr` before each update (no torch LR scheduler);
* ``adapt_weights_to_1ch`` (rrdbnet_arch.py:450-456);
* ``remat=True``: each RRDB of the generator recomputed in the backward
  pass (``RRDBNet(remat=True)``), the same values and gradients for less
  memory.

One step runs the JAX step's sequence (``sr_trainer.py:158-222``): USM of
the ground truth; the G forward; the G loss with D frozen and applied with
``train=False`` (its spectral norm iterates but stores nothing); the G
update; the D loss on (GAN ground truth, the detached output), two forwards
with ``train=True``, the second starting from the ``u`` the first stored;
the D update; then the EMA, ``e * decay + p * (1 - decay)``, of the updated
G. ``dtype=torch.bfloat16`` runs the three networks under ``torch.autocast``
(parameters, USM, losses, the spectral norm's iteration and Adam stay
float32). Batches are NHWC (``lq`` (N, h, w, C), ``gt`` (N, 4h, 4w, C)), as
the pair dataset gives them.

``make_step(group=...)`` is the data-parallel step (the reference's recipe
is multi-GPU DDP): each rank holds its rows of the global batch, and G's
gradients are averaged over the group after G's backward, D's after D's,
each in one flattened all-reduce (``parallel.data.average_gradients``).
DDP's reducer fits neither half: G's pass runs D frozen, and D's runs D
twice before one backward. Every loss is a mean over equal local batches,
so the averages are the global batch's gradients; the spectral norms'
``u`` read only the weights, and the EMA only G, so both stay equal on
every rank. The metrics are the global batch's.

A step is the span ``gan.step`` (``utils/profiler.py``), over
``gan.g_pass`` (USM through G's backward and gradient average),
``gan.g_adam``, ``gan.d_pass``, ``gan.d_adam`` and ``gan.ema``, each timed
on the card's stream too.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Mapping, Optional, Tuple

import torch

from srbh_tpu_torch import compute_type, resolve_device
from srbh_tpu_torch.losses.sr import gan_loss, l1_loss, perceptual_loss
from srbh_tpu_torch.models.discriminators import UNetDiscriminatorSN
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.models.vgg import VGG19Features
from srbh_tpu_torch.ops.usm import usm_sharp
from srbh_tpu_torch.parallel.data import average_gradients, mean_over
from srbh_tpu_torch.utils import profiler


def multistep_lr(base_lr: float, milestones=(400000,), gamma: float = 0.5,
                 warmup_iter: int = -1):
    """MultiStepLR with linear warm-up (rrdbnet_arch.py:612-633): the lr of
    update ``step`` (counted from 0)."""

    def schedule(step: int) -> float:
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr *= gamma
        if warmup_iter > 0 and step < warmup_iter:
            lr = base_lr * step / warmup_iter
        return lr

    return schedule


def adapt_weights_to_1ch(state_dict: Mapping) -> dict:
    """An RRDBNet state dict for one channel in and out: ``conv_first``'s
    kernel averaged over its inputs, ``conv_last``'s kernel and bias over
    its outputs (rrdbnet_arch.py:450-456)."""
    sd = dict(state_dict)
    sd["conv_first.weight"] = sd["conv_first.weight"].mean(1, keepdim=True)
    if "conv_last.weight" in sd:
        sd["conv_last.weight"] = sd["conv_last.weight"].mean(0, keepdim=True)
        sd["conv_last.bias"] = sd["conv_last.bias"].mean(0, keepdim=True)
    return sd


def _adam(module, lr):
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.99),
                            eps=1e-8)


def load_adam_moments(optimizer: torch.optim.Optimizer, module,
                      moments: Mapping) -> None:
    """Set an optimizer's Adam state from ``{"exp_avg": {name: t},
    "exp_avg_sq": {...}, "step": n}`` (``convert.gan_state_from_jax``)."""
    for name, p in module.named_parameters():
        like = dict(device=p.device, dtype=p.dtype)
        optimizer.state[p] = {
            "step": torch.tensor(float(moments["step"]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(moments["exp_avg"][name]).to(**like),
            "exp_avg_sq": torch.as_tensor(moments["exp_avg_sq"][name]).to(**like)}


class GANTrainState:
    """The GAN's mutable train state: ``net_g``, its EMA ``g_ema``,
    ``net_d`` (with its spectral norms' ``u`` / ``v`` / ``sigma``), the two
    Adams ``opt_g`` / ``opt_d`` and ``step``, the number of updates so
    far."""

    def __init__(self, net_g, g_ema, net_d, lr: float):
        self.net_g, self.g_ema, self.net_d = net_g, g_ema, net_d
        self.opt_g, self.opt_d = _adam(net_g, lr), _adam(net_d, lr)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device


def _nchw(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, non_blocking=True).permute(0, 3, 1, 2
                                                                 ).float().contiguous()


class RealESRGANTrainer:
    """Builds the networks and the train state (:meth:`init`), the fused
    step (:meth:`make_step`) and the EMA generator's forward
    (:meth:`ema_apply_fn`)."""

    def __init__(self, out_ch: int = 3, num_block: int = 23, scale: int = 4,
                 num_feat: int = 64, num_grow_ch: int = 32,
                 ema_decay: float = 0.999, lr: float = 1e-4,
                 gan_weight: float = 0.1, perceptual: bool = True,
                 disc_feat: int = 64, dtype: torch.dtype = torch.float32,
                 milestones=(400000,), gamma: float = 0.5,
                 warmup_iter: int = -1, remat: bool = False,
                 l1_gt_usm: bool = True, percep_gt_usm: bool = True,
                 gan_gt_usm: bool = False):
        # remat: each RRDB of the generator recomputed in the backward pass
        self.remat = remat
        self.out_ch, self.scale, self.num_block = out_ch, scale, num_block
        self.num_feat, self.num_grow_ch, self.disc_feat = (num_feat, num_grow_ch,
                                                           disc_feat)
        self.perceptual = perceptual
        self.dtype = dtype
        self.ema_decay, self.gan_weight, self.lr = ema_decay, gan_weight, lr
        # per-loss USM ground truths (the recipe's yml:9-11)
        self.l1_gt_usm, self.percep_gt_usm, self.gan_gt_usm = (
            l1_gt_usm, percep_gt_usm, gan_gt_usm)
        self.schedule = multistep_lr(lr, milestones, gamma=gamma,
                                     warmup_iter=warmup_iter)
        self.vgg = None  # built by init()

    def init(self, seed: int = 0, lq_shape: Tuple[int, ...] = (1, 64, 64, 3),
             g_state: Optional[Mapping] = None, d_state: Optional[Mapping] = None,
             vgg_state: Optional[Mapping] = None, device=None) -> GANTrainState:
        """A fresh state on ``device`` (``None`` is the card) for NHWC
        ``lq_shape`` batches: weights drawn from ``seed`` (on the CPU) or
        loaded from the state dicts given (a finetune's generator, a warm
        discriminator, VGG19 weights)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        net_g = RRDBNet(num_in_ch=lq_shape[-1], num_out_ch=self.out_ch,
                        scale=self.scale, num_feat=self.num_feat,
                        num_block=self.num_block, num_grow_ch=self.num_grow_ch,
                        remat=self.remat)
        net_d = UNetDiscriminatorSN(num_in_ch=self.out_ch, num_feat=self.disc_feat)
        init_weights(net_g, gen)
        init_weights(net_d, gen)
        for conv in net_d.sn_convs():
            conv.reset_from(gen)
        for net, sd in ((net_g, g_state), (net_d, d_state)):
            if sd is not None:
                net.load_state_dict(sd)
        if self.perceptual:
            self.vgg = init_weights(VGG19Features(), gen)
            if vgg_state is not None:
                self.vgg.load_state_dict(vgg_state)
            self.vgg.eval().requires_grad_(False).to(dev)
        net_g.to(dev)
        g_ema = copy.deepcopy(net_g).eval().requires_grad_(False)
        return GANTrainState(net_g, g_ema, net_d.to(dev), self.lr)

    @staticmethod
    def _autotuned(dev):
        """On a card, ``torch.backends.cudnn.benchmark`` for the length of
        the block, restored after it: cuDNN times its algorithms for each
        convolution shape instead of taking its heuristic's choice. The
        heuristic gives the discriminator's ``conv5`` forward at the recipe's
        shapes ([12, 256, 128, 128] by [128, 256, 3, 3]) an FFT algorithm
        that took 70.7 % of the float32 step. PyTorch keeps the plan it
        chose the first time it meets a shape, so the step's shapes must
        first run inside the block."""
        scope = contextlib.ExitStack()
        if dev.type == "cuda":
            scope.callback(setattr, torch.backends.cudnn, "benchmark",
                           torch.backends.cudnn.benchmark)
            torch.backends.cudnn.benchmark = True
        return scope

    def make_step(self, group=None):
        """``step(state, lq, gt) -> metrics``: one update of ``state`` in
        place; the metrics (``l_g_pix``, ``l_g_percep``, ``l_g_gan``,
        ``l_g_total``, ``l_d_real``, ``l_d_fake``, ``out_d_real``,
        ``out_d_fake``) stay on the device. On a card the step runs with
        cuDNN's autotuning on (:meth:`_autotuned`). ``group``: the
        data-parallel step over that process group (module docstring)."""
        if self.perceptual and self.vgg is None:
            raise RuntimeError("make_step before init(): init() builds the "
                               "perceptual VGG19")
        vgg, gan_w, decay = self.vgg, self.gan_weight, self.ema_decay
        usm_any = self.l1_gt_usm or self.percep_gt_usm or self.gan_gt_usm

        def update(state: GANTrainState, lq, gt):
            dev = state.device
            net_g, net_d = state.net_g.train(), state.net_d
            lq, gt = _nchw(lq, dev), _nchw(gt, dev)
            lr = self.schedule(state.step)

            # the generator, D frozen and applied without storing its norms
            with profiler.span("gan.g_pass", device=True):
                with torch.no_grad():
                    gt_usm = usm_sharp(gt) if usm_any else gt
                l1_gt = gt_usm if self.l1_gt_usm else gt
                percep_gt = gt_usm if self.percep_gt_usm else gt
                gan_gt = gt_usm if self.gan_gt_usm else gt
                net_d.requires_grad_(False)
                with compute_type(dev, self.dtype):
                    output = net_g(lq)
                    fake_g = net_d(output, train=False)
                    if vgg is not None:
                        fx = vgg(output)
                        with torch.no_grad():
                            fgt = vgg(percep_gt)
                out32 = output.float()
                l_pix = l1_loss(out32, l1_gt)
                l_percep = (perceptual_loss([f.float() for f in fx],
                                            [f.float() for f in fgt])
                            if vgg is not None
                            else torch.zeros((), device=dev))
                l_gan = gan_loss(fake_g.float(), True, "vanilla",
                                 is_disc=False, loss_weight=gan_w)
                g_total = l_pix + l_percep + l_gan
                state.opt_g.zero_grad(set_to_none=True)
                g_total.backward()
                average_gradients(net_g.parameters(), group)
            with profiler.span("gan.g_adam", device=True):
                for pg in state.opt_g.param_groups:
                    pg["lr"] = lr
                state.opt_g.step()

            # the discriminator, two forwards that each store their norms
            with profiler.span("gan.d_pass", device=True):
                net_d.requires_grad_(True)
                with compute_type(dev, self.dtype):
                    real_pred = net_d(gan_gt, train=True).float()
                    fake_pred = net_d(output.detach(), train=True).float()
                l_real = gan_loss(real_pred, True, "vanilla", is_disc=True)
                l_fake = gan_loss(fake_pred, False, "vanilla", is_disc=True)
                state.opt_d.zero_grad(set_to_none=True)
                (l_real + l_fake).backward()
                average_gradients(net_d.parameters(), group)
            with profiler.span("gan.d_adam", device=True):
                for pg in state.opt_d.param_groups:
                    pg["lr"] = lr
                state.opt_d.step()

            with profiler.span("gan.ema", device=True), torch.no_grad():
                ema = list(state.g_ema.parameters())
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, list(net_g.parameters()),
                                    alpha=1 - decay)
            state.step += 1
            return {k: mean_over(v, group) for k, v in (
                ("l_g_pix", l_pix), ("l_g_percep", l_percep), ("l_g_gan", l_gan),
                ("l_g_total", g_total), ("l_d_real", l_real),
                ("l_d_fake", l_fake), ("out_d_real", real_pred.mean()),
                ("out_d_fake", fake_pred.mean()))}

        def step(state: GANTrainState, lq, gt):
            with profiler.span("gan.step"), self._autotuned(state.device):
                return update(state, lq, gt)

        return step

    def ema_apply_fn(self):
        """``apply(state, lq, features_only=False)``: the EMA generator (what
        the height model consumes, train.py:137) on NHWC ``lq``, NHWC out,
        without gradients; on a card with cuDNN's autotuning on, as the
        step."""

        def apply(state: GANTrainState, lq, features_only: bool = False):
            dev = state.device
            with torch.no_grad(), self._autotuned(dev), compute_type(
                    dev, self.dtype):
                out = state.g_ema(_nchw(lq, dev), features_only=features_only)
            return out.float().permute(0, 2, 3, 1)

        return apply
