"""Checkpoints of the height train state.

Counterpart of ``srbh_tpu/train/checkpoint.py`` (train.py:151-168,
199-212): every epoch writes ``checkpoint`` in the log directory, every 5th
epoch a snapshot ``checkpoint{epoch}``, and an improved validation RMSE
``model_best``. A checkpoint is one ``torch.save`` file holding ``epoch``,
``best_rmse``, ``step``, ``model`` (the height model's state dict, with the
reference's names), ``log_vars`` and ``optimizer`` (the Adam state, so a
resume continues exactly). It is written to ``<path>.tmp`` and renamed into
place, synchronously.

:func:`load_checkpoint` also reads the JAX package's ``.npz`` checkpoints
(``srbh_tpu.train.convert.save_tree_npz``, read by
``convert.load_tree_npz``) through ``convert.train_state_from_jax``, of the
height model or of the nosuper ablation, and the reference's own checkpoint
dict (``epoch``, ``state_dict``, ``log_vars``, ``best_acc``).

The Real-ESRGAN trainer's checkpoints (``srbh_tpu/train/sr_driver.py:32-44``)
are two ``torch.save`` files in its log directory with BasicSR's keys:
``net_g`` (``params``, ``params_ema``, ``epoch``, ``current_iter``) and
``net_d`` (``params``, the spectral norms' ``weight_u`` / ``weight_v``
included, ``epoch``, ``current_iter``).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from srbh_tpu_torch import convert


def save_checkpoint(logdir: str, state, epoch: int, best_rmse: float,
                    snapshot_every: int = 5, is_best: bool = False) -> str:
    """Write ``checkpoint`` (and ``checkpoint{epoch}``, ``model_best``) in
    ``logdir``; returns the path of ``checkpoint``."""
    payload = {
        "epoch": int(epoch),
        "best_rmse": float(best_rmse),
        "step": int(state.step),
        "model": state.model.state_dict(),
        "log_vars": state.log_vars.detach().cpu().clone(),
        "optimizer": state.optimizer.state_dict(),
    }
    path = os.path.join(logdir, "checkpoint")
    _save(payload, path)
    if snapshot_every and epoch % snapshot_every == 0:
        shutil.copyfile(path, os.path.join(logdir, f"checkpoint{epoch}"))
    if is_best:
        shutil.copyfile(path, os.path.join(logdir, "model_best"))
    return path


def _save(payload: dict, path: str) -> None:
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_sr_checkpoint(logdir: str, state, epoch: int) -> str:
    """Write ``net_g`` and ``net_d`` of a GAN train state in ``logdir``;
    returns the path of ``net_g``."""
    meta = {"epoch": int(epoch), "current_iter": int(state.step)}
    _save({"params": state.net_g.state_dict(),
           "params_ema": state.g_ema.state_dict(), **meta},
          os.path.join(logdir, "net_g"))
    _save({"params": state.net_d.state_dict(), **meta},
          os.path.join(logdir, "net_d"))
    return os.path.join(logdir, "net_g")


def _payload_from_npz(path: str, encoder_name: str, isaggre: bool,
                      model_variant: str) -> dict:
    """A JAX npz (``params``, ``batch_stats``, ``log_vars`` as an array or
    as the converter's ``{"w1": ...}`` scalars, ``meta``) as a payload of
    :func:`save_checkpoint`'s form without ``optimizer``: the npz files of
    the JAX package hold no optimizer state."""
    tree = convert.load_tree_npz(path)
    lv = tree.get("log_vars")
    if isinstance(lv, dict):
        lv = np.stack([np.asarray(lv[k], np.float32)
                       for k in sorted(lv, key=lambda s: int(s[1:]))])
    sd, log_vars, _ = convert.train_state_from_jax(
        tree["params"], tree["batch_stats"],
        np.zeros(3 if isaggre else 2, np.float32) if lv is None else lv,
        None, encoder_name, isaggre, model_variant)
    meta = tree.get("meta", {})
    return {"epoch": int(tree.get("epoch", meta.get("epoch", 0))),
            "best_rmse": float(tree.get("best_rmse",
                                        meta.get("best_acc", float("inf")))),
            "step": int(tree.get("step", 0)),
            "model": sd, "log_vars": None if lv is None else log_vars}


def load_checkpoint(path: str, encoder_name: str = "efficientnet-b4",
                    isaggre: bool = True,
                    model_variant: str = "feature") -> Optional[dict]:
    """A checkpoint's payload, or ``None`` if ``path`` does not exist. A
    path ending in ``.npz`` is read as a JAX checkpoint of a model built
    with ``encoder_name``, ``isaggre`` and ``model_variant`` (``feature``
    or ``nosuper``)."""
    if not os.path.isfile(path):
        return None
    if path.endswith(".npz"):
        return _payload_from_npz(path, encoder_name, isaggre, model_variant)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in payload and "model" not in payload:
        return _payload_from_reference(payload)
    return payload


def _payload_from_reference(payload: dict) -> dict:
    """The reference's checkpoint dict (train.py:199-212: ``epoch``,
    ``state_dict``, ``log_vars`` as a list of one-element tensors,
    ``best_acc``; ``python -m srbh_tpu_torch.convert --arch height`` writes
    one) as a payload of :func:`save_checkpoint`'s form without
    ``optimizer``."""
    lv = payload.get("log_vars")
    return {"epoch": int(payload.get("epoch", 0)),
            "best_rmse": float(payload.get("best_acc", float("inf"))),
            "step": 0, "model": payload["state_dict"],
            "log_vars": (torch.cat([torch.as_tensor(v).reshape(-1) for v in lv])
                         if lv else None)}


def restore_into_state(state, payload: dict) -> None:
    """Load a payload into ``state``: model, log-vars (kept when the payload
    has none), step, and the optimizer state if present."""
    state.model.load_state_dict(payload["model"])
    if payload.get("log_vars") is not None:
        with torch.no_grad():
            state.log_vars.copy_(torch.as_tensor(payload["log_vars"]))
    state.step = int(payload.get("step", 0))
    if payload.get("optimizer") is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
