"""Plain reference of the Real-ESRGAN finetune step, float32.

Written from BasicSR's recipe ``finetune_realesrgan_x4plus_pairdata.yml``
and Real-ESRGAN's model (Wang et al. 2021), as the reference repository
carries them (SR/rrdbnet_arch.py:244-303, 387-633; SR/srloss.py), with the
port's choices where the JAX package made one (``srbh_tpu_torch/train/
sr_trainer.py`` at the commit that added the benchmark; nothing of it is
imported):

* the generator: ``flagship.RRDBNet`` (23 RRDBs, x4), its EMA at 0.999;
* ``UNetDiscriminatorSN`` (nf 64, skip connections, bilinear x2): convs 1-8
  spectrally normalised by one power iteration a forward from the stored
  ``u`` (``v = n(W^T u)``, ``u' = n(W v)``, ``sigma = u'.W v``), stored only
  in the discriminator's own update;
* VGG19 features at conv1_2, conv2_2, conv3_4, conv4_4, conv5_4 (before
  their ReLU) after ImageNet normalisation;
* the generator's loss ``L1(out, USM(gt)) + sum_i w_i L1(vgg_i(out),
  vgg_i(USM(gt)))`` (w = .1, .1, 1, 1, 1) ``+ 0.1 BCE(D(out), 1)``; the
  discriminator's ``BCE(D(gt), 1) + BCE(D(out.detach()), 0)``;
* USM: a 51-tap Gaussian (sigma 8), reflect padded, the residual thresholded
  at 10/255, a soft-mask blend (weight 0.5);
* Adam (betas 0.9 / 0.99, eps 1e-8) for each network, written out here.

``dtype=torch.bfloat16`` runs the three networks under autocast (the power
iteration, USM, losses and Adam stay float32): the control.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.flagship import RRDBNet

PERCEPTUAL_WEIGHTS = (0.1, 0.1, 1.0, 1.0, 1.0)
VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG_LAYERS = (2, 7, 16, 25, 34)


def _l2n(x):
    return x * torch.rsqrt((x * x).sum() + 1e-12)


class SNConv(nn.Module):
    def __init__(self, cin, cout, k, stride, pad):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, k, k))
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin * k * k))

    def forward(self, x, store: bool):
        w = self.weight_orig
        off = (torch.autocast(w.device.type, enabled=False)
               if w.device.type in ("cuda", "cpu") else contextlib.nullcontext())
        with off:
            mat = w.reshape(w.shape[0], -1)
            with torch.no_grad():
                v = _l2n(mat.t() @ self.weight_u)
                u = _l2n(mat @ v)
            sigma = u @ (mat @ v)
            wn = (mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
                  ).view_as(w)
        if store:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return F.conv2d(x, wn, None, self.stride, self.pad)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class UNetDiscriminatorSN(nn.Module):
    def __init__(self, num_in_ch=3, nf=64):
        super().__init__()
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv(nf, nf * 2, 4, 2, 1)
        self.conv2 = SNConv(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SNConv(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SNConv(nf * 8, nf * 4, 3, 1, 1)
        self.conv5 = SNConv(nf * 4, nf * 2, 3, 1, 1)
        self.conv6 = SNConv(nf * 2, nf, 3, 1, 1)
        self.conv7 = SNConv(nf, nf, 3, 1, 1)
        self.conv8 = SNConv(nf, nf, 3, 1, 1)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    def forward(self, x, store=False):
        a = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
        x0 = a(self.conv0(x))
        x1 = a(self.conv1(x0, store))
        x2 = a(self.conv2(x1, store))
        x3 = a(self.conv3(x2, store))
        x4 = a(self.conv4(_up2(x3), store)) + x2
        x5 = a(self.conv5(_up2(x4), store)) + x1
        x6 = a(self.conv6(_up2(x5), store)) + x0
        out = a(self.conv7(x6, store))
        out = a(self.conv8(out, store))
        return self.conv9(out)


class VGG19Features(nn.Module):
    def __init__(self, layers=VGG_LAYERS):
        super().__init__()
        self.layers = tuple(layers)
        mods, cin = [], 3
        for item in VGG19:
            if item == "M":
                mods.append(nn.MaxPool2d(2, 2))
            else:
                mods += [nn.Conv2d(cin, item, 3, 1, 1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*mods[:max(self.layers) + 1])
        self.register_buffer("mean", torch.tensor(
            (0.485, 0.456, 0.406)).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(
            (0.229, 0.224, 0.225)).view(1, 3, 1, 1), persistent=False)

    def forward(self, x):
        x = (x - self.mean) / self.std
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.layers:
                out.append(x)
        return out


def gaussian_1d(ksize=51):
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _blur(x, k1d):
    k, c = len(k1d), x.shape[1]
    w = torch.tensor(k1d, dtype=x.dtype).to(x.device)
    x = F.pad(x, (k // 2,) * 4, mode="reflect")
    x = F.conv2d(x, w.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, w.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def usm(img, weight=0.5, radius=50, threshold=10.0):
    k1d = gaussian_1d(radius + 1 if radius % 2 == 0 else radius)
    res = img - _blur(img, k1d)
    mask = (res.abs() * 255.0 > threshold).to(img.dtype)
    soft = _blur(mask, k1d)
    sharp = (img + weight * res).clamp(0.0, 1.0)
    return soft * sharp + (1.0 - soft) * img


def bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits,
                                              torch.full_like(logits, target))


class Adam:
    """Adam with bias correction, one tensor at a time."""

    def __init__(self, params, lr, b1=0.9, b2=0.99, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None


class GANStep:
    """The networks, their Adams and the EMA; :meth:`step` runs one update
    and returns the five losses as floats (tensors with ``as_tensors``).
    After each update ``grads`` holds the gradients the two Adams took,
    by parameter name (``g.*``, ``d.*``)."""

    def __init__(self, cfg: dict, g_state, d_state, vgg_state, device,
                 dtype=torch.float32):
        n = cfg["model"]
        g, d = n["generator"], n["discriminator"]
        self.net_g = RRDBNet(g["num_in_ch"], g["num_out_ch"], g["num_feat"],
                             g["num_block"], g["num_grow_ch"])
        self.net_d = UNetDiscriminatorSN(g["num_out_ch"], d["num_feat"])
        self.vgg = VGG19Features()
        self.net_g.load_state_dict(g_state)
        self.net_d.load_state_dict(d_state)
        self.vgg.load_state_dict(vgg_state)
        self.net_g.to(device).train()
        self.net_d.to(device).train()
        self.vgg.to(device).eval().requires_grad_(False)
        self.ema = {k: v.detach().clone() for k, v in
                    self.net_g.named_parameters()}
        t = n["train"]
        self.decay, self.gan_w = t["ema_decay"], t["gan_weight"]
        self.opt_g = Adam(self.net_g.parameters(), t["lr"], *t["betas"],
                          t["eps"])
        self.opt_d = Adam(self.net_d.parameters(), t["lr"], *t["betas"],
                          t["eps"])
        self.dtype, self.device = dtype, torch.device(device)
        self.grads = {}

    def _amp(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def step(self, lq, gt, as_tensors=False):
        """``lq`` (N, 3, h, w), ``gt`` (N, 3, 4h, 4w), float32 in [0, 1]."""
        with torch.no_grad():
            gt_usm = usm(gt)
        self.net_d.requires_grad_(False)
        with self._amp():
            out = self.net_g(lq)
            fake_g = self.net_d(out, store=False)
            fx = self.vgg(out)
            with torch.no_grad():
                fgt = self.vgg(gt_usm)
        l_pix = (out.float() - gt_usm).abs().mean()
        l_percep = sum(w * (a.float() - b.float()).abs().mean()
                       for w, a, b in zip(PERCEPTUAL_WEIGHTS, fx, fgt))
        l_gan = bce(fake_g.float(), 1.0) * self.gan_w
        (l_pix + l_percep + l_gan).backward()
        self.grads.update({"g." + k: p.grad.detach().clone()
                           for k, p in self.net_g.named_parameters()})
        self.opt_g.step()

        self.net_d.requires_grad_(True)
        with self._amp():
            real = self.net_d(gt, store=True).float()
            fake = self.net_d(out.detach(), store=True).float()
        l_real, l_fake = bce(real, 1.0), bce(fake, 0.0)
        (l_real + l_fake).backward()
        self.grads.update({"d." + k: p.grad.detach().clone()
                           for k, p in self.net_d.named_parameters()})
        self.opt_d.step()

        with torch.no_grad():
            for k, p in self.net_g.named_parameters():
                self.ema[k].mul_(self.decay).add_(p, alpha=1 - self.decay)
        losses = {"l_g_pix": l_pix, "l_g_percep": l_percep, "l_g_gan": l_gan,
                  "l_d_real": l_real, "l_d_fake": l_fake}
        if as_tensors:
            return losses
        return {k: float(v.detach()) for k, v in losses.items()}

    @torch.no_grad()
    def load_state(self, snap: dict) -> None:
        """Continue from a train state taken from the program: ``g`` and
        ``d`` (each network's state dict, the discriminator's power-iteration
        vectors with it), ``ema`` (the EMA's tensors by name), ``m`` and
        ``v`` (each Adam's moments by ``g.*`` / ``d.*`` parameter name) and
        ``t`` (each Adam's number of updates by ``g.`` / ``d.``); moments
        and counts the program does not hold yet start at 0, as Adam's
        do."""
        self.net_g.load_state_dict(snap["g"])
        self.net_d.load_state_dict({k: snap["d"][k]
                                    for k in self.net_d.state_dict()})
        for k, v in self.ema.items():
            v.copy_(snap["ema"][k])
        for pre, net, opt in (("g.", self.net_g, self.opt_g),
                              ("d.", self.net_d, self.opt_d)):
            for (n, _), m, v in zip(net.named_parameters(), opt.m, opt.v):
                m.copy_(snap["m"].get(pre + n, torch.zeros_like(m)))
                v.copy_(snap["v"].get(pre + n, torch.zeros_like(v)))
            opt.t = int(snap["t"].get(pre, 0))

    def params(self) -> dict:
        """Every trained tensor by name: ``g.*``, ``d.*`` and ``ema.*``."""
        out = {"g." + k: p.detach() for k, p in self.net_g.named_parameters()}
        out.update({"d." + k: p.detach()
                    for k, p in self.net_d.named_parameters()})
        out.update({"ema." + k: v for k, v in self.ema.items()})
        return out


def leaf_gaps(prog_norms: dict, ref_norms: dict, keep) -> list:
    """Each leaf's gap ``|prog - ref|`` of its norm over the larger of the
    reference's norm of that leaf and of the median leaf, over the leaves
    ``keep`` names; infinite for a leaf the program lacks."""
    med = float(np.median([ref_norms[k] for k in keep]))
    out = []
    for k in keep:
        p = prog_norms.get(k)
        ok = p is not None and math.isfinite(p)
        out.append(abs(p - ref_norms[k]) / max(ref_norms[k], med) if ok
                   else math.inf)
    return out


def worst_leaf(prog_norms: dict, ref_norms: dict, keep) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog_norms, ref_norms, keep))

