"""Checkpoints of the height train state.

Counterpart of ``srbh_tpu/train/checkpoint.py`` (train.py:151-168,
199-212): every epoch writes ``checkpoint`` in the log directory, every 5th
epoch a snapshot ``checkpoint{epoch}``, and an improved validation RMSE
``model_best``. A checkpoint is one ``torch.save`` file holding ``epoch``,
``best_rmse``, ``step``, ``model`` (the height model's state dict, with the
reference's names) and ``log_vars``, all as host tensors. It is written to
``<path>.tmp`` and renamed into place. As in the reference (train.py:163-164,
207) and the JAX package, the optimizer state is neither saved nor restored
by default, so a resumed run starts a fresh Adam; ``save_opt_state=True``
adds ``optimizer`` (the Adam state) to every file written, and a resume from
such a file continues exactly.

``save_checkpoint(..., async_save=True)`` (``srbh_tpu/train/checkpoint.py:
71-135``) copies the state to the host before it returns, so the caller may
step on at once: the live parameters and the Adam moments, which the next
step updates in place, are never read again. Writing the file and copying
it to ``checkpoint{epoch}`` / ``model_best`` then run on a background
thread, which touches only those host copies and the file system. A second
save first joins the one in flight; :func:`wait_for_saves` joins it too,
and either re-raises a failed write as ``RuntimeError("async checkpoint
save failed")``.

In a process group every rank calls :func:`save_checkpoint` and the first
writes: an FSDP2 state's sharded parameters and moments are gathered whole
first (each a collective, on the calling thread of every rank), so the file
has the same form as a single process's, and :func:`restore_into_state`
cuts a whole file back into the shards. A checkpoint moves between FSDP2,
DDP and one process either way. After an asynchronous save only the first
rank's :func:`wait_for_saves` knows that the files are written: another
rank that reads them must first see that call return (a barrier after it).

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
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from srbh_tpu_torch import convert
from srbh_tpu_torch.train.state import shard_like


_pending: Optional[Future] = None  # the asynchronous save in flight


def wait_for_saves() -> None:
    """Block until the asynchronous save in flight, if any, has written its
    files; re-raise its failure (a full disk must fail the run, not show up
    at resume time as a missing checkpoint)."""
    global _pending
    if _pending is None:
        return
    done, _pending = _pending, None
    err = done.exception()
    if err is not None:
        raise RuntimeError("async checkpoint save failed") from err


def save_checkpoint(logdir: str, state, epoch: int, best_rmse: float,
                    snapshot_every: int = 5, is_best: bool = False,
                    save_opt_state: bool = False,
                    async_save: bool = False) -> str:
    """Write ``checkpoint`` (and ``checkpoint{epoch}``, ``model_best``) in
    ``logdir``; returns the path of ``checkpoint``. ``save_opt_state`` adds
    the optimizer state. With ``async_save`` the files are written on a
    background thread after this returns: call :func:`wait_for_saves`
    before reading them."""
    global _pending
    wait_for_saves()  # serialise with the save in flight; raise its failure
    model = whole(state.model.state_dict())
    optimizer = whole(state.optimizer.state_dict()) if save_opt_state else None
    path = os.path.join(logdir, "checkpoint")
    if not dist.is_initialized() or dist.get_rank() == 0:
        payload = {
            "epoch": int(epoch),
            "best_rmse": float(best_rmse),
            "step": int(state.step),
            "model": _host_copy(model),
            "log_vars": _host_copy(state.log_vars),
        }
        if save_opt_state:
            payload["optimizer"] = _host_copy(optimizer)

        def commit():
            _save(payload, path)
            if snapshot_every and epoch % snapshot_every == 0:
                shutil.copyfile(path, os.path.join(logdir, f"checkpoint{epoch}"))
            if is_best:
                shutil.copyfile(path, os.path.join(logdir, "model_best"))

        if async_save:
            # one non-daemon worker, let go once it has written the files
            pool = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
            _pending = pool.submit(commit)
            pool.shutdown(wait=False)
        else:
            commit()
    if dist.is_initialized():
        dist.barrier()
    return path


def _tree_map(fn, tree):
    """``fn`` on each leaf of a state dict (nested dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def whole(tree):
    """A state dict with each FSDP2 ``DTensor`` gathered whole (a
    collective: every rank calls it alike)."""
    from torch.distributed.tensor import DTensor

    return _tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                     else t, tree)


def _host_copy(tree):
    """A state dict whose tensors are new host copies, detached: nothing in
    it shares memory with the live state (``.cpu()`` of a CPU tensor would
    return the tensor itself)."""
    return _tree_map(lambda t: t.detach().to("cpu", copy=True)
                     if isinstance(t, torch.Tensor) else t, tree)


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
    has none), step, and the optimizer state if present (a file written
    without ``save_opt_state`` leaves the state's optimizer as it is: a
    fresh one starts anew, as the reference's resume does); whole tensors
    are cut to an FSDP2 state's shards."""
    own = state.model.state_dict()
    state.model.load_state_dict({k: shard_like(own[k], v) if k in own else v
                                 for k, v in payload["model"].items()})
    if payload.get("log_vars") is not None:
        with torch.no_grad():
            state.log_vars.copy_(torch.as_tensor(payload["log_vars"]))
    state.step = int(payload.get("step", 0))
    opt = payload.get("optimizer")
    if opt is not None:
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        opt = {"param_groups": opt["param_groups"], "state": {
            i: {k: v if k == "step" else shard_like(params[int(i)], v)
                for k, v in st.items()}
            for i, st in opt["state"].items()}}
        state.optimizer.load_state_dict(opt)
