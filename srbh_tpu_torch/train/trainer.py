"""The height model's trainer (its training loop).

Counterpart of ``srbh_tpu/train/trainer.py:main`` (train.py:84-223): seeds,
the train and validation loaders, the frozen SR model, the height model,
resume, the epoch loop with the step-decay LR, per-epoch validation, and the
``checkpoint`` / snapshot / ``model_best`` files. One epoch line is printed
per epoch. ``writer`` takes an object with ``add_scalar(tag, value, epoch)``
and ``close()`` (a TensorBoard writer); with ``None`` nothing is written.

``--device_aug`` moves augmentation and target building into the train
step; ``--device_norm`` (which implies ``--device_aug``) normalisation too.

Not ported yet (``ROADMAP.md``): ``main_test`` and its metric writers, the
data-parallel and FSDP branches, ``remat``, the ImageNet encoder start and
the nosuper variant; their flags raise (``_REFUSED``). ``save_opt_state`` and ``async_checkpoint`` are
accepted and change nothing: every checkpoint holds the optimizer state
(exact resume) and is written synchronously.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.convert import rrdbnet_state_dict
from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.metrics.streaming import AverageMeter
from srbh_tpu_torch.models.height_model import UPSCALE, SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_tree_npz,
    restore_into_state,
    save_checkpoint,
)
from srbh_tpu_torch.train.config import TrainConfig
from srbh_tpu_torch.train.schedule import step_decay_lr
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_eval_step, make_train_step

# flags of TrainConfig the port refuses, and the ROADMAP.md item they wait for
_REFUSED = {
    "fsdp": "Queue 1 item 13", "remat": "Queue 1 item 15",
    "encoder_weights": "Queue 1 item 6 (ImageNet encoder start)",
}


def _check_supported(cfg: TrainConfig) -> None:
    for flag, item in _REFUSED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet: ROADMAP.md {item}")
    if cfg.model_variant != "feature":
        raise NotImplementedError(
            f"model_variant {cfg.model_variant!r} is not ported yet: "
            "ROADMAP.md Queue 1 item 11")
    if cfg.upscale != UPSCALE:
        raise NotImplementedError(f"upscale {cfg.upscale}: the port's height "
                                  f"model is x{UPSCALE}")


def build_models(cfg: TrainConfig):
    """(height model, frozen SR model) with weights drawn from
    ``cfg.seed`` (on the CPU, so every device gets the same ones)."""
    sr = RRDBNet(num_block=cfg.sr_num_block, num_feat=cfg.sr_num_feat,
                 num_grow_ch=cfg.sr_num_grow)
    model = SRRegressClsFeature(cfg.encoder_name, super_mid=cfg.super_mid,
                                isaggre=cfg.isaggre,
                                chans_build=cfg.chans_build,
                                sr_chans=cfg.sr_num_feat)
    gen = torch.Generator().manual_seed(cfg.seed)
    init_weights(sr, gen)
    init_weights(model, gen)
    return model, sr


def load_sr_weights(cfg: TrainConfig, sr) -> bool:
    """Load the frozen Real-ESRGAN generator from ``cfg.logdirhr`` if it is
    a file (train.py:133-140): a JAX ``.npz`` (its EMA params preferred), or
    a torch file holding the state dict, alone or under ``net_g_ema`` /
    ``params_ema`` / ``params``. Returns whether weights were loaded."""
    path = cfg.logdirhr
    if not os.path.isfile(path):
        return False
    if path.endswith(".npz"):
        tree = load_tree_npz(path)
        tree = tree.get("params_ema", tree)
        sd = rrdbnet_state_dict(tree if "params" in tree else {"params": tree},
                                cfg.sr_num_block)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = next((sd[k] for k in ("net_g_ema", "params_ema", "params")
                   if k in sd), sd)
    sr.load_state_dict(sd)
    return True


def make_loader(cfg: TrainConfig, listname: str, aug: bool, isaggre: bool,
                ishir: bool, num_sample: int = 0, shuffle: bool = True,
                preweight: Optional[str] = None, device=None,
                device_aug: bool = False, device_norm: bool = False
                ) -> DataLoader:
    """A loader whose batches arrive on ``device`` (``None`` is the card)."""
    ds = S12GlobeDataset(
        os.path.join(cfg.datapath, listname), cfg.datapath,
        datastats=cfg.datastats, normmethod="minmax", datarange=(0, 1),
        aug=aug, num_sample=num_sample, s1dir=cfg.s1dir, s2dir=cfg.s2dir,
        heightdir=cfg.bhdir, preweight=preweight, isaggre=isaggre,
        ishir=ishir, hir=cfg.hir, nchans=cfg.nchanss2, seed=cfg.seed,
        device_aug=device_aug, device_norm=device_norm)
    return DataLoader(ds, batch_size=cfg.batch_size, shuffle=shuffle,
                      num_workers=cfg.num_workers, seed=cfg.seed,
                      device_put=True, device=device)


def main(cfg: TrainConfig, writer=None,
         max_steps_per_epoch: Optional[int] = None, device=None) -> TrainState:
    """Train per ``cfg`` on ``device`` (``None`` is the card; without one
    this raises unless ``device="cpu"``). Returns the final train state,
    with the frozen SR model as its ``sr_model``. ``max_steps_per_epoch``
    cuts every epoch's training and validation loops."""
    dev = resolve_device(device)
    _check_supported(cfg)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    device_aug = cfg.device_aug or cfg.device_norm
    trainloader = make_loader(cfg, cfg.trainlist, aug=not device_aug,
                              isaggre=cfg.isaggre, ishir=cfg.ishir,
                              num_sample=cfg.num_sample,
                              preweight=cfg.preweight, device=dev,
                              device_aug=device_aug,
                              device_norm=cfg.device_norm)
    valloader = make_loader(cfg, cfg.vallist, aug=False, isaggre=False,
                            ishir=False, num_sample=cfg.num_sample // 2,
                            shuffle=False, device=dev)

    model, sr = build_models(cfg)
    if not load_sr_weights(cfg, sr):
        print("=> no SR checkpoint found; using random frozen features")
    model.to(dev)
    state = TrainState(model, n_log_vars=3 if cfg.isaggre else 2, lr=cfg.lr,
                       weight_decay=cfg.weight_decay, sr_model=sr)
    start_epoch, best_rmse = 0, float("inf")
    payload = load_checkpoint(os.path.join(cfg.logdir, "checkpoint"))
    if payload is None:
        print("WARNING: training starts from a RANDOM encoder — the "
              "reference always uses ImageNet weights (mymodels.py:242).")
    else:
        restore_into_state(state, payload)
        start_epoch = payload["epoch"]
        best_rmse = payload.get("best_rmse", float("inf"))
        # the loaders resume at the same epoch, so epochs N+1.. see the
        # shuffle order and augmentation draws of an uninterrupted run
        trainloader.epoch = start_epoch
        valloader.epoch = start_epoch
        print(f"=> resumed epoch {start_epoch}")

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    ds = trainloader.dataset
    norm = ({k: getattr(ds, k) for k in ("s2_off", "s2_scale", "s1_off",
                                          "s1_scale")}
            if cfg.device_norm else None)
    train_step = make_train_step(model, sr, cfg.rgbseq, cfg.isaggre,
                                 seed=cfg.seed, device_aug=device_aug,
                                 hir=cfg.hir, class_weight=ds.heightweight,
                                 norm=norm, ishir=cfg.ishir, dtype=dtype,
                                 device=dev)
    eval_step = make_eval_step(model, sr, cfg.rgbseq, dtype=dtype, device=dev)
    os.makedirs(cfg.logdir, exist_ok=True)

    for epoch in range(start_epoch + 1, cfg.maxepoch + 1):
        lr = step_decay_lr(cfg.lr, epoch)
        # metrics stay on the device until the epoch ends: no per-step sync
        train_m, val_m = [], []
        for i, batch in enumerate(trainloader):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            m = train_step(state, batch, lr)
            train_m.append((m["loss"], m["rmse"], batch["height"].shape[0]))
        for i, batch in enumerate(valloader):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            m = eval_step(batch)
            val_m.append((m["loss"], m["rmse"], batch["image"].shape[0]))
        losses, rmses = AverageMeter(), AverageMeter()
        val_losses, val_rmses = AverageMeter(), AverageMeter()
        for meters, rows in (((losses, rmses), train_m),
                             ((val_losses, val_rmses), val_m)):
            for loss, rmse, n in rows:
                meters[0].update(loss.item(), n)
                meters[1].update(rmse.item(), n)
        log_vars = state.log_vars.detach().cpu().numpy()

        if val_rmses.count == 0:
            # an empty validation would read rmse 0.0 and pin model_best
            print("warning: validation produced no batches; "
                  "val rmse not comparable this epoch")
            is_best = False
        else:
            is_best = val_rmses.avg < best_rmse
            best_rmse = min(val_rmses.avg, best_rmse)
        save_checkpoint(cfg.logdir, state, epoch, best_rmse,
                        snapshot_every=5, is_best=is_best)
        print(f"epoch {epoch}: lr {lr:.6f} train loss {losses.avg:.3f} "
              f"rmse {rmses.avg:.3f} | val rmse {val_rmses.avg:.3f}"
              f"{' *best*' if is_best else ''}")
        if writer is not None:
            writer.add_scalar("lr", lr, epoch)
            writer.add_scalar("train/loss", losses.avg, epoch)
            writer.add_scalar("train/rmse", rmses.avg, epoch)
            writer.add_scalar("val/loss", val_losses.avg, epoch)
            writer.add_scalar("val/rmse", val_rmses.avg, epoch)
            for k in range(log_vars.shape[0]):
                writer.add_scalar(f"lossweight/w{k + 1}", float(log_vars[k]),
                                  epoch)
    if writer is not None:
        writer.close()
    return state
