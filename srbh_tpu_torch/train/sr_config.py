"""BasicSR finetune YAML -> the port's Real-ESRGAN trainer.

Counterpart of ``srbh_tpu/train/sr_config.py``: :func:`load_finetune_yml`
takes the trainer's fields of a BasicSR finetune recipe
(SR/finetune_realesrgan_x4plus_pairdata.yml) with the same defaults (400k
iterations, batch 12, L1 + VGG19 perceptual + 0.1 GAN, EMA 0.999, MultiStepLR
400k x0.5, no warm-up), and :func:`trainer_from_yml` builds a
``RealESRGANTrainer`` from them. PyYAML is imported when a file is read, so
the rest of the port does not need it.
"""
from __future__ import annotations

from typing import Any, Dict

from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer


def load_finetune_yml(path: str) -> Dict[str, Any]:
    """``trainer`` (RealESRGANTrainer arguments), ``gamma``, ``total_iter``,
    ``data`` (batch size, gt size, flips, rotations) and ``usm`` (the
    per-loss USM ground-truth switches, yml:9-11) of a BasicSR YAML."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    g = cfg.get("network_g", {})
    train = cfg.get("train", {})
    sched = train.get("scheduler", {})
    optim = train.get("optim_g", {})
    gan = train.get("gan_opt", {})
    percep = train.get("perceptual_opt", {})
    ds = cfg.get("datasets", {}).get("train", {})
    trainer_kwargs = {
        "scale": int(cfg.get("scale", 4)),
        "num_feat": int(g.get("num_feat", 64)),
        "num_block": int(g.get("num_block", 23)),
        "num_grow_ch": int(g.get("num_grow_ch", 32)),
        "out_ch": int(g.get("num_out_ch", 3)),
        "ema_decay": float(train.get("ema_decay", 0.999)),
        "lr": float(optim.get("lr", 1e-4)),
        "gan_weight": float(gan.get("loss_weight", 0.1)),
        "perceptual": bool(percep) and float(
            percep.get("perceptual_weight", 1.0)) > 0,
        "disc_feat": int(cfg.get("network_d", {}).get("num_feat", 64)),
        "milestones": tuple(int(m) for m in sched.get("milestones", (400000,))),
        "gamma": float(sched.get("gamma", 0.5)),
        "warmup_iter": int(train.get("warmup_iter", -1)),
    }
    return {
        "trainer": trainer_kwargs,
        "gamma": float(sched.get("gamma", 0.5)),
        "total_iter": int(train.get("total_iter", 400000)),
        "data": {
            "batch_size": int(ds.get("batch_size_per_gpu", 12)),
            "gt_size": int(ds.get("gt_size", 256)),
            "use_hflip": bool(ds.get("use_hflip", True)),
            "use_rot": bool(ds.get("use_rot", False)),
        },
        "usm": {
            "l1": bool(cfg.get("l1_gt_usm", True)),
            "percep": bool(cfg.get("percep_gt_usm", True)),
            "gan": bool(cfg.get("gan_gt_usm", False)),
        },
    }


def trainer_from_yml(path: str, dtype=None, **overrides):
    """A ``RealESRGANTrainer`` from a BasicSR finetune YAML; ``overrides``
    replace its fields, ``dtype`` (a ``torch.dtype``) its compute type."""
    cfg = load_finetune_yml(path)
    kwargs = dict(cfg["trainer"], l1_gt_usm=cfg["usm"]["l1"],
                  percep_gt_usm=cfg["usm"]["percep"], gan_gt_usm=cfg["usm"]["gan"])
    kwargs.update(overrides)
    if dtype is not None:
        kwargs["dtype"] = dtype
    return RealESRGANTrainer(**kwargs)
