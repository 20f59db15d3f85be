"""CLI configuration mirroring the reference's argparse surface.

The port's copy of ``srbh_tpu/train/config.py`` (train.py:24-65 /
predict_realesanet_feature_globe.py:26-65): the same flags and defaults, so
an invocation of the JAX package's ``train.py`` runs unchanged as
``python -m srbh_tpu_torch.train``. Which flags the port's trainer honours,
and which it refuses, is listed in ``srbh_tpu_torch/train/trainer.py``.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple


@dataclass
class TrainConfig:
    datapath: str = "./data"
    trainlist: str = "datalist_globe_train_0.7.csv"
    vallist: str = "datalist_globe_test_0.7_val_0.3.csv"
    testlist: str = "datalist_globe_test_0.7_test_0.3.csv"
    logdir: str = "./weights/realesrgan_feature_aggre_weight_globe"
    logdirhr: str = "./weights/realesrgan/checkpoint2"  # frozen SR checkpoint
    rgbseq: Tuple[int, ...] = (0, 1, 2)
    checkpoint: str = "checkpoint"
    nchans: int = 8
    nchanss2: int = 6
    maxepoch: int = 30
    lr: float = 1e-3
    weight_decay: float = 1e-4
    datastats: str = "datastatsglobe"
    preweight: Optional[str] = "datastatsglobe/bh_stats_globe.txt"
    s1dir: str = "s1globe_check"
    s2dir: str = "s2globe_check"
    bhdir: str = "bhglobe"
    isaggre: bool = True
    ishir: bool = True
    hir: Tuple[int, ...] = (0, 3, 12, 21, 30, 60, 90, 256)
    chans_build: int = 7
    batch_size: int = 16
    num_workers: int = 8
    encoder_name: str = "efficientnet-b4"
    # ImageNet-pretrained encoder start (the reference always trains from
    # encoder_weights="imagenet", mymodels.py:234,242-243); the port's
    # trainer refuses it for now. None = random encoder (a warning is
    # printed: accuracy goldens assume a pretrained one).
    encoder_weights: Optional[str] = None
    # "feature" = the proposed SRRegressClsFeature; "nosuper" = the no-SR
    # ablation (mymodels.py:341-409, train.py commented experiment variants)
    model_variant: str = "feature"
    super_mid: int = 16
    upscale: int = 4
    seed: int = 1337
    # predict-time
    wholeimgpath: str = "./data/urban/input_data"
    cityname: Tuple[str, ...] = ()
    grid: int = 64
    stride: int = 60
    # accelerator knobs (not in the reference): bf16 autocast compute; what
    # the port's trainer does with the others is in its module docstring.
    bf16: bool = False
    remat: bool = False
    device_aug: bool = False
    device_norm: bool = False
    fsdp: bool = False
    num_sample: int = 0
    save_opt_state: bool = False
    async_checkpoint: bool = False
    # frozen-SR architecture (defaults = Real-ESRGAN x4plus, train.py:133-136)
    sr_num_block: int = 23
    sr_num_feat: int = 64
    sr_num_grow: int = 32
    tile: int = 64


def get_args(city: str = "globe", argv: Optional[List[str]] = None) -> TrainConfig:
    """argparse twin of train.py:24-65 with city-templated defaults."""
    cfg = TrainConfig(
        trainlist=f"datalist_{city}_train_0.7.csv",
        vallist=f"datalist_{city}_test_0.7_val_0.3.csv",
        testlist=f"datalist_{city}_test_0.7_test_0.3.csv",
        logdir=f"./weights/realesrgan_feature_aggre_weight_{city}",
        preweight=f"datastatsglobe/bh_stats_{city}.txt",
        s1dir=f"s1{city}_check",
        s2dir=f"s2{city}_check",
        bhdir=f"bh{city}",
    )
    parser = argparse.ArgumentParser()
    for f in fields(TrainConfig):
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            parser.add_argument(f"--{f.name}", nargs="*",
                                type=type(default[0]) if default else str,
                                default=list(default))
        else:
            parser.add_argument(f"--{f.name}",
                                type=type(default) if default is not None else str,
                                default=default)
    ns = parser.parse_args(argv)  # None -> sys.argv, like the reference
    for f in fields(TrainConfig):
        v = getattr(ns, f.name)
        if isinstance(getattr(cfg, f.name), tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(cfg, f.name, v)
    return cfg
