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
(``srbh_tpu.train.convert.save_tree_npz``: a flat npz whose keys join the
tree's path with ``\\x1f``, or ``/`` in older files) through
``convert.train_state_from_jax``.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from srbh_tpu_torch import convert

_NPZ_SEP, _NPZ_MARKER = "\x1f", "__srbh-npz-sep-1f__"


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
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if snapshot_every and epoch % snapshot_every == 0:
        shutil.copyfile(path, os.path.join(logdir, f"checkpoint{epoch}"))
    if is_best:
        shutil.copyfile(path, os.path.join(logdir, "model_best"))
    return path


def load_tree_npz(path: str) -> dict:
    """A JAX ``.npz`` checkpoint as the nested dict it was saved from."""
    tree: dict = {}
    with np.load(path) as z:
        keys = [k for k in z.files if k != _NPZ_MARKER]
        new_format = _NPZ_MARKER in z.files or any(_NPZ_SEP in k for k in keys)
        for k in keys:
            node = tree
            *parents, leaf = k.split(_NPZ_SEP if new_format else "/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


def _payload_from_npz(path: str, encoder_name: str, isaggre: bool) -> dict:
    """A JAX npz (``params``, ``batch_stats``, ``log_vars`` as an array or
    as the converter's ``{"w1": ...}`` scalars, ``meta``) as a payload of
    :func:`save_checkpoint`'s form without ``optimizer``: the npz files of
    the JAX package hold no optimizer state."""
    tree = load_tree_npz(path)
    lv = tree.get("log_vars")
    if isinstance(lv, dict):
        lv = np.stack([np.asarray(lv[k], np.float32)
                       for k in sorted(lv, key=lambda s: int(s[1:]))])
    sd, log_vars, _ = convert.train_state_from_jax(
        tree["params"], tree["batch_stats"],
        np.zeros(3 if isaggre else 2, np.float32) if lv is None else lv,
        None, encoder_name, isaggre)
    meta = tree.get("meta", {})
    return {"epoch": int(tree.get("epoch", meta.get("epoch", 0))),
            "best_rmse": float(tree.get("best_rmse",
                                        meta.get("best_acc", float("inf")))),
            "step": int(tree.get("step", 0)),
            "model": sd, "log_vars": None if lv is None else log_vars}


def load_checkpoint(path: str, encoder_name: str = "efficientnet-b4",
                    isaggre: bool = True) -> Optional[dict]:
    """A checkpoint's payload, or ``None`` if ``path`` does not exist. A
    path ending in ``.npz`` is read as a JAX checkpoint of a model built
    with ``encoder_name`` and ``isaggre``."""
    if not os.path.isfile(path):
        return None
    if path.endswith(".npz"):
        return _payload_from_npz(path, encoder_name, isaggre)
    return torch.load(path, map_location="cpu", weights_only=True)


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
