"""The height model's trainer and its test-set evaluation.

Counterparts of ``srbh_tpu/train/trainer.py``:

* :func:`main` (train.py:84-223): seeds, the train and validation loaders,
  the frozen SR model, the height model (``--model_variant feature``, or
  ``nosuper``: the ablation without SR input), the ImageNet encoder start
  on a fresh run (``--encoder_weights``), resume, the epoch loop with the
  step-decay LR, per-epoch validation, and the ``checkpoint`` / snapshot /
  ``model_best`` files. One epoch line is printed per epoch. ``writer``
  takes an object with ``add_scalar(tag, value, epoch)`` and ``close()`` (a
  TensorBoard writer); with ``None`` nothing is written. ``--device_aug``
  moves augmentation and target building into the train step;
  ``--device_norm`` (which implies ``--device_aug``) normalisation too.
* :func:`main_test` (train.py:347-425, vtest_epoch2 :427-486): the test
  list at batch 1 through a checkpoint, writing ``acc{epoch}{suffix}_{num}
  .txt`` (the mean of per-batch RMSEs), ``*_seg.csv`` and ``*_he.csv``, and
  with ``issave`` each tile's predicted height and classes as GeoTIFFs.

In a process group (``torchrun``; ``parallel.mesh.initialize_distributed``)
:func:`main` trains data-parallel when the world size divides the batch,
as the JAX trainer does on a mesh: each rank loads its shard of the tiles
(``shard_index`` / ``num_shards``, batches of ``batch_size / W``, ragged
tails dropped) and runs the DDP step over the global batch
(``train/steps.py``); ``--fsdp`` shards the height model and the frozen
RRDBNet with FSDP2 (``parallel.mesh.shard_state_fsdp``). Validation runs
sharded on every rank with the global batch's metrics; only rank 0 prints
and writes.

``--remat`` recomputes the height model's 256^2 fusion stack in the
backward pass (``SRRegressClsFeature(remat=True)``). ``save_opt_state`` is
accepted and changes nothing: every checkpoint holds the optimizer state
(exact resume). ``--async_checkpoint`` writes each epoch's checkpoint on a
background thread while training goes on (``train/checkpoint.py``);
:func:`main` joins the last write before it returns, and before it or
:func:`main_test` reads a checkpoint.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from srbh_tpu_torch import convert, resolve_device
from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.metrics.streaming import (
    AverageMeter,
    HeightMetric,
    SegmentationMetric,
)
from srbh_tpu_torch.metrics.writers import (
    acc2file_height,
    acc2file_rmse,
    acc2file_seg,
)
from srbh_tpu_torch.models.height_model import (
    UPSCALE,
    SRRegressClsFeature,
    SRRegressClsNosuper,
)
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.parallel import mesh as pmesh
from srbh_tpu_torch.parallel.collectives import rank, world
from srbh_tpu_torch.parallel.data import global_batchnorm
from srbh_tpu_torch.train.checkpoint import (
    load_checkpoint,
    restore_into_state,
    save_checkpoint,
    wait_for_saves,
)
from srbh_tpu_torch.train.config import TrainConfig
from srbh_tpu_torch.train.schedule import step_decay_lr
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import (
    make_eval_step,
    make_predict_step,
    make_train_step,
)

def _check_supported(cfg: TrainConfig) -> None:
    if cfg.upscale != UPSCALE:
        raise NotImplementedError(f"upscale {cfg.upscale}: the port's height "
                                  f"model is x{UPSCALE}")


def build_models(cfg: TrainConfig, compute_mode: str = "literal"):
    """(height model, frozen SR model) with weights drawn from
    ``cfg.seed`` (on the CPU, so every device gets the same ones); the
    nosuper ablation (``model_variant="nosuper"``) has no SR model. The
    feature model takes ``cfg.remat`` and ``compute_mode`` (``"packed"``:
    inference only)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model_variant == "nosuper":
        model = SRRegressClsNosuper(cfg.encoder_name, isaggre=cfg.isaggre,
                                    chans_build=cfg.chans_build)
        return init_weights(model, gen), None
    if cfg.model_variant != "feature":
        raise ValueError(f"model_variant {cfg.model_variant!r}: the port "
                         "builds 'feature' and 'nosuper'")
    sr = RRDBNet(num_block=cfg.sr_num_block, num_feat=cfg.sr_num_feat,
                 num_grow_ch=cfg.sr_num_grow)
    model = SRRegressClsFeature(cfg.encoder_name, super_mid=cfg.super_mid,
                                isaggre=cfg.isaggre,
                                chans_build=cfg.chans_build,
                                sr_chans=cfg.sr_num_feat,
                                compute_mode=compute_mode, remat=cfg.remat)
    init_weights(sr, gen)
    init_weights(model, gen)
    return model, sr


def load_encoder_weights(cfg: TrainConfig, model) -> None:
    """Graft ``cfg.encoder_weights`` into the model's encoder: the JAX
    package's encoder ``.npz``, or a torch file holding efficientnet-pytorch's
    ImageNet state dict (a 3-channel stem is widened to the model's)."""
    path = cfg.encoder_weights
    sd = (convert.encoder_state_dict_from_npz(path, cfg.encoder_name)
          if path.endswith(".npz")
          else torch.load(path, map_location="cpu", weights_only=True))
    convert.graft_encoder(model.encoder, sd, path)


def load_sr_weights(cfg: TrainConfig, sr) -> bool:
    """Load the frozen Real-ESRGAN generator from ``cfg.logdirhr`` if it is
    a file (train.py:133-140): a JAX ``.npz`` (its EMA params preferred), or
    a torch file holding the state dict, alone or under ``net_g_ema`` /
    ``params_ema`` / ``params``. Returns whether weights were loaded."""
    path = cfg.logdirhr
    if not os.path.isfile(path):
        return False
    if path.endswith(".npz"):
        tree = convert.load_tree_npz(path)
        tree = tree.get("params_ema", tree)
        sd = convert.rrdbnet_state_dict(
            tree if "params" in tree else {"params": tree}, cfg.sr_num_block)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = next((sd[k] for k in ("net_g_ema", "params_ema", "params")
                   if k in sd), sd)
    sr.load_state_dict(sd)
    return True


def make_loader(cfg: TrainConfig, listname: str, aug: bool, isaggre: bool,
                ishir: bool, num_sample: int = 0, shuffle: bool = True,
                preweight: Optional[str] = None, device=None,
                device_aug: bool = False, device_norm: bool = False,
                batch_size: Optional[int] = None, shard_index: int = 0,
                num_shards: int = 1) -> DataLoader:
    """A loader whose batches arrive on ``device`` (``None`` is the card),
    of ``batch_size`` samples (``None``: ``cfg.batch_size``); with
    ``num_shards`` > 1 it reads shard ``shard_index`` and drops a ragged
    last batch."""
    ds = S12GlobeDataset(
        os.path.join(cfg.datapath, listname), cfg.datapath,
        datastats=cfg.datastats, normmethod="minmax", datarange=(0, 1),
        aug=aug, num_sample=num_sample, s1dir=cfg.s1dir, s2dir=cfg.s2dir,
        heightdir=cfg.bhdir, preweight=preweight, isaggre=isaggre,
        ishir=ishir, hir=cfg.hir, nchans=cfg.nchanss2, seed=cfg.seed,
        device_aug=device_aug, device_norm=device_norm)
    return DataLoader(ds, batch_size=batch_size or cfg.batch_size,
                      shuffle=shuffle,
                      num_workers=cfg.num_workers, seed=cfg.seed,
                      device_put=True, device=device,
                      drop_last=num_shards > 1, shard_index=shard_index,
                      num_shards=num_shards)


def _quiet(*args, **kwargs) -> None:
    """``print`` of the ranks after the first."""


def main(cfg: TrainConfig, writer=None,
         max_steps_per_epoch: Optional[int] = None, device=None,
         fsdp: bool = False) -> TrainState:
    """Train per ``cfg`` on ``device`` (``None`` is the card; without one
    this raises unless ``device="cpu"``). Returns the final train state,
    with the frozen SR model as its ``sr_model``. ``max_steps_per_epoch``
    cuts every epoch's training and validation loops.

    A process group of more than one rank trains data-parallel over its
    ranks, and its size must divide ``batch_size``; ``fsdp`` (or
    ``cfg.fsdp``) also shards the models with FSDP2, and needs a process
    group (``torchrun``, or ``parallel.mesh.initialize_distributed``):
    without one it raises."""
    dev = resolve_device(device)
    _check_supported(cfg)
    fsdp = fsdp or cfg.fsdp
    n = world()
    if cfg.batch_size % n:
        raise ValueError(f"data parallelism over {n} ranks requires "
                         f"batch_size divisible by the world size (got "
                         f"batch_size={cfg.batch_size}); pick a multiple")
    data_parallel = fsdp or n > 1
    if data_parallel and not dist.is_initialized():
        raise RuntimeError("fsdp needs a process group: run under torchrun, "
                           "or call srbh_tpu_torch.parallel.mesh."
                           "initialize_distributed first")
    mesh = pmesh.make_mesh() if data_parallel else None
    group = mesh.get_group(pmesh.DATA_AXIS) if mesh is not None else None
    n_data = world(group) if group is not None else 1
    shard = dict(shard_index=rank(group), num_shards=n_data,
                 batch_size=cfg.batch_size // n_data) if n_data > 1 else {}
    say = print if rank() == 0 else _quiet
    writer = writer if rank() == 0 else None
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    device_aug = cfg.device_aug or cfg.device_norm
    trainloader = make_loader(cfg, cfg.trainlist, aug=not device_aug,
                              isaggre=cfg.isaggre, ishir=cfg.ishir,
                              num_sample=cfg.num_sample,
                              preweight=cfg.preweight, device=dev,
                              device_aug=device_aug,
                              device_norm=cfg.device_norm, **shard)
    valloader = make_loader(cfg, cfg.vallist, aug=False, isaggre=False,
                            ishir=False, num_sample=cfg.num_sample // 2,
                            shuffle=False, device=dev, **shard)

    model, sr = build_models(cfg)
    if sr is not None and not load_sr_weights(cfg, sr):
        say("=> no SR checkpoint found; using random frozen features")
    start_epoch, best_rmse = 0, float("inf")
    wait_for_saves()  # an earlier run's asynchronous save must be written
    payload = load_checkpoint(os.path.join(cfg.logdir, "checkpoint"))
    # only a fresh run starts its encoder from ImageNet weights: a resumed
    # run takes the encoder from its checkpoint
    if payload is None and cfg.encoder_weights:
        load_encoder_weights(cfg, model)
        say(f"=> encoder initialised from {cfg.encoder_weights}")
    elif payload is None:
        say("WARNING: training starts from a RANDOM encoder — the "
            "reference always uses ImageNet weights (mymodels.py:242); "
            "pass --encoder_weights.")
    model.to(dev)
    if group is not None:
        global_batchnorm(model, group)
    if fsdp:
        pmesh.shard_state_fsdp(model, mesh)
        if sr is not None:
            pmesh.shard_state_fsdp(sr.to(dev).requires_grad_(False), mesh)
    state = TrainState(model, n_log_vars=3 if cfg.isaggre else 2, lr=cfg.lr,
                       weight_decay=cfg.weight_decay, sr_model=sr)
    if payload is not None:
        restore_into_state(state, payload)
        start_epoch = payload["epoch"]
        best_rmse = payload.get("best_rmse", float("inf"))
        # the loaders resume at the same epoch, so epochs N+1.. see the
        # shuffle order and augmentation draws of an uninterrupted run
        trainloader.epoch = start_epoch
        valloader.epoch = start_epoch
        say(f"=> resumed epoch {start_epoch}")

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    ds = trainloader.dataset
    norm = ({k: getattr(ds, k) for k in ("s2_off", "s2_scale", "s1_off",
                                          "s1_scale")}
            if cfg.device_norm else None)
    train_step = make_train_step(model, sr, cfg.rgbseq, cfg.isaggre,
                                 seed=cfg.seed, device_aug=device_aug,
                                 hir=cfg.hir, class_weight=ds.heightweight,
                                 norm=norm, ishir=cfg.ishir, dtype=dtype,
                                 device=dev, group=group)
    eval_step = make_eval_step(model, sr, cfg.rgbseq, dtype=dtype, device=dev,
                               group=group)
    os.makedirs(cfg.logdir, exist_ok=True)

    for epoch in range(start_epoch + 1, cfg.maxepoch + 1):
        lr = step_decay_lr(cfg.lr, epoch)
        # metrics stay on the device until the epoch ends: no per-step sync
        train_m, val_m = [], []
        for i, batch in enumerate(trainloader):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            m = train_step(state, batch, lr)
            train_m.append((m["loss"], m["rmse"],
                            batch["height"].shape[0] * n_data))
        for i, batch in enumerate(valloader):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            m = eval_step(batch)
            val_m.append((m["loss"], m["rmse"],
                          batch["image"].shape[0] * n_data))
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
            say("warning: validation produced no batches; "
                "val rmse not comparable this epoch")
            is_best = False
        else:
            is_best = val_rmses.avg < best_rmse
            best_rmse = min(val_rmses.avg, best_rmse)
        save_checkpoint(cfg.logdir, state, epoch, best_rmse,
                        snapshot_every=5, is_best=is_best,
                        async_save=cfg.async_checkpoint)
        say(f"epoch {epoch}: lr {lr:.6f} train loss {losses.avg:.3f} "
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
    wait_for_saves()  # the last epoch's checkpoint is written on return
    if cfg.async_checkpoint and dist.is_initialized():
        dist.barrier()  # every rank returns once the first has written it
    if writer is not None:
        writer.close()
    return state


def _save_tiles(respath: str, height, build, paths) -> None:
    """Each tile's ``<name>_predprob.tif`` (uint16 decimetres, negatives to
    0) and ``<name>_build.tif`` (uint8 classes, the colormap), PACKBITS,
    on its source tile's geotransform at 2.5 m."""
    from srbh_tpu_torch.predict.writers import array2raster_rio

    hp = height.cpu().numpy().copy()
    hp[hp < 0] = 0
    hp = np.round(hp * 10).astype(np.uint16)
    bp = build.cpu().numpy().astype(np.uint8)
    for k, imgpath in enumerate(paths):
        ibase = os.path.join(respath, os.path.basename(imgpath)[:-4])
        array2raster_rio(ibase + "_predprob.tif", hp[k], imgpath, iscmap=False,
                         compress="PACKBITS")
        array2raster_rio(ibase + "_build.tif", bp[k], imgpath, iscmap=True,
                         compress="PACKBITS")


def main_test(cfg: TrainConfig, num_sample: int = 100, suffix: str = "",
              issave: bool = False, max_batches: Optional[int] = None,
              batch_size: int = 1, device=None):
    """Evaluate ``<logdir>/<checkpoint>`` (or the JAX package's
    ``<checkpoint>.npz``) on the first ``num_sample`` tiles of the test list
    (0: all), shuffled with the loader's seed, on ``device`` (``None`` is
    the card; without one this raises unless ``device="cpu"``). Writes
    ``acc{epoch}{suffix}_{num_sample}.txt``, ``*_seg.csv`` and ``*_he.csv``
    in the log directory and, with ``issave``, the tiles' GeoTIFFs in
    ``pred_{epoch}_{suffix}``; returns ``{"rmse", "oa", "txtpath"}``, or
    ``None`` (with a line printed) when there is no checkpoint.

    The RMSE is the mean of per-batch RMSEs (vtest_epoch2 :444-446): at
    ``batch_size`` 1, the reference's, the mean of per-tile RMSEs. The
    metrics stay on the device until the files are written.
    ``max_batches`` cuts the loop (0 evaluates nothing: RMSE 0.0)."""
    dev = resolve_device(device)
    _check_supported(cfg)
    path = os.path.join(cfg.logdir, cfg.checkpoint)
    wait_for_saves()  # a checkpoint written asynchronously is read whole
    if not os.path.isfile(path) and os.path.isfile(path + ".npz"):
        path += ".npz"
    payload = load_checkpoint(path, cfg.encoder_name, cfg.isaggre,
                              cfg.model_variant)
    if payload is None:
        print(f"=> no checkpoint at {path}; stopping")
        return None
    loader = make_loader(cfg, cfg.testlist, aug=False, isaggre=False,
                         ishir=True, num_sample=num_sample,
                         preweight=cfg.preweight, device=dev,
                         batch_size=batch_size)
    model, sr = build_models(cfg)
    if sr is not None:
        load_sr_weights(cfg, sr)
    model.load_state_dict(payload["model"])
    epoch = payload["epoch"]
    predict_step = make_predict_step(
        model, sr, cfg.rgbseq, torch.bfloat16 if cfg.bf16 else torch.float32,
        device=dev)
    acc_seg = SegmentationMetric(cfg.chans_build)
    acc_he = HeightMetric(cfg.chans_build)
    respath = os.path.join(cfg.logdir, f"pred_{epoch}_{suffix}")
    if issave:
        os.makedirs(respath, exist_ok=True)

    rmses, sizes = [], []
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        height, logits = predict_step(batch["image"])
        height, target = height.float(), batch["height"].float()
        rmses.append(torch.sqrt(torch.mean((height - target) ** 2)))
        sizes.append(len(height))
        build = logits.argmax(-1)
        acc_seg.add_batch(build, batch["build"])
        acc_he.add_batch(height, target, batch["build"])
        if issave:
            _save_tiles(respath, height, build, batch["path"])

    acc_total = AverageMeter()
    for rmse, n in zip(torch.stack(rmses).tolist() if rmses else [], sizes):
        acc_total.update(rmse, n)
    txtpath = os.path.join(cfg.logdir, f"acc{epoch}{suffix}_{num_sample}.txt")
    acc2file_rmse(acc_total, txtpath)
    acc2file_seg(acc_seg, txtpath[:-4] + "_seg.txt")
    acc2file_height(acc_he, txtpath[:-4] + "_he.txt")
    return {"rmse": acc_total.avg, "oa": acc_seg.overall_accuracy(),
            "txtpath": txtpath}
