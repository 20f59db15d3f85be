"""Seeded weights, made on the device in one draw and handed alike to the
port's modules and to the reference's.

Every floating entry of a state dict takes its slice of one standard
normal draw (``torch.randn`` on a generator of the device, seeded from the
run's seed), in the state dict's order, and is then scaled by its kind:

* a conv or linear weight: ``gain / sqrt(fan_in)``; ``gain`` from the first
  of the configuration's ``gains`` prefixes that the name starts with,
  else ``default_gain``;
* a spectral-normalised weight (``*.weight_orig``): ``1 / sqrt(fan_in)``;
  its power-iteration vectors (``*.weight_u``, ``*.weight_v``): unit length;
* a BatchNorm's scale ``1 + 0.1 z``, shift ``0.1 z``, running mean ``0.1 z``
  and running variance ``1 + 0.1 |z|``;
* a bias: ``bias_std z``;
* an entry named in ``constants``: that value everywhere.

Integer entries (``num_batches_tracked``) keep their value; those of a
template on the meta device, which has none, start at 0, as a fresh
module's do.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch


def _kind(name: str, sd: Mapping) -> str:
    prefix, _, leaf = name.rpartition(".")
    bn = f"{prefix}.running_mean" in sd if prefix else "running_mean" in sd
    if leaf in ("weight_u", "weight_v"):
        return "unit"
    if leaf == "weight_orig":
        return "sn_weight"
    if bn and leaf in ("weight", "bias", "running_mean", "running_var"):
        return "bn_" + leaf
    if leaf == "weight" and sd[name].dim() >= 2:
        return "weight"
    if leaf == "bias":
        return "bias"
    return "normal"


def seeded_state(template: Mapping, seed: int, device, gains: Mapping = None,
                 default_gain: float = math.sqrt(2.0), bias_std: float = 0.01,
                 constants: Mapping = None) -> dict:
    """A new state dict with ``template``'s names, shapes and dtypes, drawn
    on ``device`` from ``seed`` as the module docstring says."""
    gains = dict(gains or {})
    constants = dict(constants or {})
    names = [k for k, v in template.items() if v.is_floating_point()]
    total = sum(template[k].numel() for k in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z_all = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, like in template.items():
        if not like.is_floating_point():
            out[name] = (torch.zeros(like.shape, dtype=like.dtype,
                                     device=device) if like.is_meta
                         else like.detach().clone().to(device))
            continue
        n = like.numel()
        z = z_all[pos:pos + n].view(like.shape)
        pos += n
        kind = _kind(name, template)
        if name in constants:
            v = torch.full_like(z, float(constants[name]))
        elif kind == "weight":
            gain = next((g for p, g in gains.items() if name.startswith(p)),
                        default_gain)
            v = z * (gain / math.sqrt(like[0].numel()))
        elif kind == "sn_weight":
            v = z / math.sqrt(like[0].numel())
        elif kind == "unit":
            v = z / z.norm()
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_running_mean"):
            v = 0.1 * z
        elif kind == "bn_running_var":
            v = 1.0 + 0.1 * z.abs()
        elif kind == "bias":
            v = bias_std * z
        else:
            v = z
        out[name] = v.to(like.dtype).contiguous()
    return out
