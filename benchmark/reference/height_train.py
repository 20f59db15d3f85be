"""Plain reference of the height model's train step, float32.

Written from the reference repository's ``train.py:225-271``
(lauraset/Super-resolution-building-height-estimation, the aggre + weight
epoch) with the port's choices where the JAX package made one
(``srbh_tpu_torch/train/{steps,state}.py`` at the commit that added this
file; nothing of the port is imported):

* the frozen Real-ESRGAN features: ``flagship.RRDBNet`` in eval mode,
  ``conv_hr``'s output of the S2 RGB bands, no gradient;
* the height model: ``flagship.HeightModel`` in train mode (BatchNorm on
  the batch's statistics), with efficientnet-pytorch's drop-connect on the
  encoder's identity blocks at ``0.2 i / n`` for block ``i`` of ``n``: one
  uniform ``u`` a sample, ``h / keep * floor(keep + u)``; the draws come
  from a generator on the device seeded with ``step_seed(seed, step)``, in
  block order, as the port's step draws them;
* the three adaptive losses (selfloss.py): ``mse_w * exp(-lv0) + lv0`` on
  the 256^2 heights, the same on the 64^2 aggregated heights (``lv1``),
  and ``(weighted CE + foreground dice) * exp(-lv2) + lv2`` on the build
  logits;
* ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8) with coupled weight
  decay (the L2 term added to the gradient before the moments) over the
  model and the log-vars, written out here.

``dtype=torch.bfloat16`` runs both networks under autocast (losses and
Adam float32): the control.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import flagship
from benchmark.reference.gan import Adam

DROP_CONNECT = 0.2


def step_seed(seed: int, step: int) -> int:
    """The drop-connect generator's seed of update ``step``."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


class AdamL2(Adam):
    """Adam with the weight decay added to the gradient; ``taken`` holds the
    gradients the last update took, decay included, by index."""

    def __init__(self, params, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, b1, b2, eps)
        self.wd = wd
        self.taken = []

    @torch.no_grad()
    def step(self):
        self.taken = []
        for p in self.params:
            p.grad = p.grad + self.wd * p
            self.taken.append(p.grad.clone())
        super().step()


def _mbconv(b, x, rate, gen):
    h = x
    if b.has_expand:
        h = F.silu(b._bn0(b._expand_conv(h)))
    h = F.silu(b._bn1(b._depthwise_conv(h)))
    s = b._se_expand(F.silu(b._se_reduce(h.mean((2, 3), keepdim=True))))
    h = b._bn2(b._project_conv(h * torch.sigmoid(s)))
    if not b.identity:
        return h
    if rate > 0:
        keep = 1.0 - rate
        u = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device)
        h = h / keep * torch.floor(keep + u).to(h.dtype)
    return h + x


def height_forward(hm, x, fea, gen):
    """``HeightModel.forward`` with the encoder's drop-connect."""
    enc = hm.encoder
    feats = [x]
    h = F.silu(enc._bn0(enc._conv_stem(x)))
    feats.append(h)
    n = len(enc._blocks)
    for i, b in enumerate(enc._blocks):
        h = _mbconv(b, h, DROP_CONNECT * i / n, gen)
        if i in enc.taps:
            feats.append(h)
    hr = hm.hrfeat(fea)
    hf = hm.decoder1(*feats)
    return hm.reg(hf, hr), hm.seg(hm.decoder2(*feats), hr), hm.aggre_height(hf)


def _adapt(loss, log_var):
    return loss * torch.exp(-log_var) + log_var


def losses(outs, b, log_vars):
    """The step's loss from the model's outputs and the batch's targets."""
    height = outs[0][:, 0].float()
    build = outs[1].float()
    aggre = outs[2][:, 0].float()
    w = b["weight"].float()
    mse = ((height - b["height"].float()) ** 2 * w).mean()
    mse_a = ((aggre - b["height_aggre"].float()) ** 2
             * b["weight_aggre"].float()).mean()
    labels = b["build"].long().clamp(0, build.shape[1] - 1)
    ce = (F.cross_entropy(build, labels, reduction="none") * w).mean()
    p = torch.softmax(build, 1)[:, 1:].sum(1).reshape(-1)
    t = (b["build"] > 0).reshape(-1).float()
    dice = 1.0 - (2.0 * (p * t).sum() + 1.0) / (p.sum() + t.sum() + 1.0)
    return (_adapt(mse, log_vars[0]) + _adapt(mse_a, log_vars[1])
            + _adapt(ce + dice, log_vars[2]))


class HeightTrainStep:
    """The frozen SR model, the height model, the log-vars and their Adam;
    :meth:`step` runs one update on a batch (the port's batch dict:
    ``image`` (N, 64, 64, 8), ``height`` / ``build`` / ``weight`` (N, 256,
    256), ``height_aggre`` / ``weight_aggre`` (N, 64, 64)) and returns the
    loss as a float. After each update ``grads`` holds the gradients Adam
    took (weight decay included) by parameter name (``log_vars`` for the
    log-vars)."""

    def __init__(self, cfg: dict, hm_state, sr_state, device, seed: int,
                 lr: float, weight_decay: float, dtype=torch.float32):
        self.hm, self.sr = flagship.build(cfg)
        self.hm.load_state_dict(hm_state)
        self.sr.load_state_dict(sr_state)
        self.hm.to(device).train()
        self.sr.to(device).eval().requires_grad_(False)
        self.log_vars = torch.zeros(3, device=device, requires_grad=True)
        self.names = [n for n, _ in self.hm.named_parameters()] + ["log_vars"]
        self.adam = AdamL2([p for _, p in self.hm.named_parameters()]
                           + [self.log_vars], lr, weight_decay)
        self.rgb = list(cfg["model"]["rgb_idx"])
        self.seed, self.t = seed, 0
        self.dtype, self.device = dtype, torch.device(device)
        self.grads = {}

    def _amp(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def step(self, batch: dict, lr: float) -> float:
        b = {k: v.to(self.device) for k, v in batch.items()}
        x = b["image"].permute(0, 3, 1, 2).float()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, self.t))
        with self._amp():
            with torch.no_grad():
                fea = self.sr(x[:, self.rgb], features_only=True)
            outs = height_forward(self.hm, x, fea, gen)
        loss = losses(outs, b, self.log_vars)
        loss.backward()
        self.adam.lr = lr
        self.adam.step()
        self.grads = dict(zip(self.names, self.adam.taken))
        self.t += 1
        return float(loss.detach())

    @torch.no_grad()
    def load_state(self, snap: dict) -> None:
        """Continue from a train state taken from the program: ``model``
        (the height model's state dict, BatchNorm statistics with it),
        ``log_vars``, ``m`` and ``v`` (Adam's moments by parameter name,
        ``log_vars`` among them), ``adam_t`` (Adam's number of updates)
        and ``step`` (the updates applied, which seeds the drop-connect)."""
        self.hm.load_state_dict(snap["model"])
        self.log_vars.copy_(snap["log_vars"])
        for n, m, v in zip(self.names, self.adam.m, self.adam.v):
            m.copy_(snap["m"].get(n, torch.zeros_like(m)))
            v.copy_(snap["v"].get(n, torch.zeros_like(v)))
        self.adam.t = int(snap["adam_t"])
        self.t = int(snap["step"])

    def params(self) -> dict:
        """Every trained tensor by name, ``log_vars`` among them."""
        out = {k: p.detach() for k, p in self.hm.named_parameters()}
        out["log_vars"] = self.log_vars.detach()
        return out
