"""Train state: the height model, the adaptive-loss log-vars, the optimizer.

Counterpart of ``srbh_tpu/train/state.py`` (train.py:170-179):

* ``torch.optim.Adam(lr, weight_decay=1e-4)``: coupled L2, added to the
  gradient before the moments (not AdamW), which is what the JAX package's
  ``torch_adam`` chain reproduces;
* two parameter groups: the model, and a ``log_vars`` Parameter of length 3
  (2 without ``isaggre``). Like the reference's ``lossweight`` group, the
  second group inherits ``weight_decay`` and follows the epoch schedule:
  :meth:`TrainState.set_learning_rate` writes the lr to both groups (so the
  JAX state's separate initial ``log_var_lr`` is not kept: the first step
  overwrites it).

BatchNorm statistics live in the model's buffers, so unlike the JAX state
this one holds no ``batch_stats``. The frozen RRDBNet it trains against may
ride along as ``sr_model``; it is in no optimizer group.

Under FSDP2 the state is built after ``parallel.mesh.shard_state_fsdp``
has sharded the model: Adam then keeps each moment in its parameter's
shards, and :meth:`TrainState.load_moments` cuts full moments to them. The
log-vars stay whole on every rank. Adam's default takes its foreach kernels
only for plain tensors and steps FSDP2's ``DTensor`` parameters one at a
time; the state asks for the foreach kernels for them.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor


class TrainState:
    """Mutable train state: ``model``, ``log_vars``, ``optimizer``, the step
    counter ``step`` (the number of applied updates) and ``sr_model``."""

    def __init__(self, model: nn.Module, n_log_vars: int = 3, lr: float = 1e-3,
                 weight_decay: float = 1e-4, log_vars: Optional[torch.Tensor] = None,
                 sr_model: Optional[nn.Module] = None):
        dev = next(model.parameters()).device
        self.model = model
        self.sr_model = sr_model
        lv = (torch.zeros(n_log_vars) if log_vars is None
              else torch.as_tensor(log_vars, dtype=torch.float32))
        self.log_vars = nn.Parameter(lv.clone().to(dev))
        params = list(model.parameters())
        sharded = any(isinstance(p, DTensor) for p in params)
        self.optimizer = torch.optim.Adam(
            [{"params": params, "lr": lr},
             {"params": [self.log_vars], "lr": lr}],
            lr=lr, weight_decay=weight_decay, foreach=True if sharded else None)
        self.step = 0

    def set_learning_rate(self, lr: float) -> None:
        """Write ``lr`` to BOTH groups (train.py:77-80; the reference's
        lossweight skip condition never fires)."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def apply_gradients(self, lr: float) -> None:
        """One optimizer step on the gradients in ``.grad`` at ``lr``; the
        gradients are then released."""
        self.set_learning_rate(lr)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def load_moments(self, moments: Mapping) -> None:
        """Set Adam's state from ``convert.train_state_from_jax``'s
        ``moments``: ``{"model": {"exp_avg": {name: t}, "exp_avg_sq": {...},
        "step": n}, "log_vars": {"exp_avg": t, "exp_avg_sq": t, "step": n}}``."""
        named = dict(self.model.named_parameters())
        group = moments["model"]
        for name, p in named.items():
            self.optimizer.state[p] = self._adam_state(
                p, group["exp_avg"][name], group["exp_avg_sq"][name],
                group["step"])
        lv = moments["log_vars"]
        self.optimizer.state[self.log_vars] = self._adam_state(
            self.log_vars, lv["exp_avg"], lv["exp_avg_sq"], lv["step"])

    @staticmethod
    def _adam_state(p, exp_avg, exp_avg_sq, step) -> dict:
        return {"step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": shard_like(p, exp_avg),
                "exp_avg_sq": shard_like(p, exp_avg_sq)}


def shard_like(p: torch.Tensor, full) -> torch.Tensor:
    """``full`` (a whole tensor or array of ``p``'s shape) on ``p``'s device
    and dtype, and cut to ``p``'s shards when ``p`` is an FSDP2 ``DTensor``
    (each rank takes its own shard of its own copy: no communication)."""
    from torch.distributed.tensor import distribute_tensor

    t = torch.as_tensor(full).to(device=p.device, dtype=p.dtype)
    t = t.reshape(p.shape)
    if isinstance(p, DTensor):
        return distribute_tensor(t, p.device_mesh, p.placements,
                                 src_data_rank=None)
    return t
