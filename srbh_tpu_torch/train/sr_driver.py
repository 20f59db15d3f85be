"""Real-ESRGAN finetune and evaluation drivers.

Counterpart of ``srbh_tpu/train/sr_driver.py``: the reference finetunes its
SR generator with BasicSR's recipe (SR/finetune_realesrgan_x4plus_pairdata.yml)
on Sentinel-2 -> GoogleEarth pairs and writes PSNR / SSIM to
``weights/realesrgan/acc{N}.txt``.

* :func:`train_sr`: ``LRHRPairDataset`` batches (the port's ``DataLoader``,
  ``drop_last``) through the fused GAN step, a log line every ``log_every``
  steps, the ``net_g`` / ``net_d`` checkpoints every epoch;
* :func:`eval_sr`: PSNR / SSIM / cPSNR of the EMA generator's
  ``round(clip(out, 0, 1) * 255)`` against ``round(gt * 255)``, and the
  ``acc{N}.txt`` schema (a header, psnr, ssim, two zero slots, cpsnr);
* :func:`load_sr_generator`: ``net_g`` (params and EMA) into a state.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.metrics.image import calculate_cpsnr, calculate_psnr, calculate_ssim
from srbh_tpu_torch.train.checkpoint import save_sr_checkpoint
from srbh_tpu_torch.train.sr_trainer import GANTrainState, RealESRGANTrainer


def train_sr(trainer: RealESRGANTrainer, dataset, logdir: str, epochs: int = 2,
             batch_size: int = 12, num_workers: int = 4, seed: int = 0,
             state: Optional[GANTrainState] = None, log_every: int = 50,
             device=None) -> GANTrainState:
    """Paired GAN finetuning on ``device`` (``None`` is the card), from
    ``state`` or a fresh one; returns the state."""
    dev = resolve_device(device)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        num_workers=num_workers, seed=seed, drop_last=True,
                        device_put=True, device=dev)
    if state is None:
        state = trainer.init(seed, (batch_size,) + dataset[0]["lq"].shape,
                             device=dev)
    step = trainer.make_step()
    os.makedirs(logdir, exist_ok=True)
    for epoch in range(1, epochs + 1):
        for i, batch in enumerate(loader):
            m = step(state, batch["lq"], batch["gt"])
            if i % log_every == 0:
                print(f"sr epoch {epoch} iter {i}: g={m['l_g_total'].item():.4f} "
                      f"pix={m['l_g_pix'].item():.4f} "
                      f"d={(m['l_d_real'] + m['l_d_fake']).item():.4f}")
        save_sr_checkpoint(logdir, state, epoch)
    return state


def eval_sr(trainer: RealESRGANTrainer, state: GANTrainState, dataset,
            txtpath: Optional[str] = None, batch_size: int = 8,
            max_batches: Optional[int] = None, num_workers: int = 2,
            device=None) -> dict:
    """PSNR / SSIM / cPSNR of the EMA generator (of ``state``, on
    ``device``: ``None`` is the card) over LR / HR pairs (zeros for no
    pairs); writes ``txtpath`` in the ``acc{N}.txt`` schema."""
    # the EMA forward is built once per trainer, as the JAX package caches
    # its jitted function there
    fn = getattr(trainer, "_eval_sr_fn", None)
    if fn is None:
        fn = trainer._eval_sr_fn = trainer.ema_apply_fn()
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        num_workers=num_workers, device_put=True,
                        device=resolve_device(device))
    psnrs, ssims, cpsnrs = [], [], []
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        out = fn(state, batch["lq"]).cpu().numpy()
        gt = batch["gt"].cpu().numpy()
        for k in range(out.shape[0]):
            o = (np.clip(out[k], 0, 1) * 255.0).round()
            g = (gt[k] * 255.0).round()
            psnrs.append(calculate_psnr(o, g))
            ssims.append(calculate_ssim(o, g))
            cpsnrs.append(calculate_cpsnr(o, g))
    if not psnrs:
        res = {"psnr": 0.0, "ssim": 0.0, "cpsnr": 0.0}
    else:
        res = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
               "cpsnr": float(np.mean(cpsnrs))}
    if txtpath:
        with open(txtpath, "w") as f:
            # weights/realesrgan/acc2.txt: psnr, ssim, the clipscore and lpips
            # slots (learned metrics, not computed here), cpsnr
            f.write("psnr, ssim\n")
            f.write(f"{res['psnr']:.3f}\n{res['ssim']:.3f}\n")
            f.write("0.000\n0.000\n")
            f.write(f"{res['cpsnr']:.3f}\n")
    return res


def load_sr_generator(trainer: RealESRGANTrainer, logdir: str,
                      state: GANTrainState) -> GANTrainState:
    """Load ``logdir/net_g`` (params and EMA) into ``state``, if it exists;
    returns the state."""
    path = os.path.join(logdir, "net_g")
    if not os.path.isfile(path):
        return state
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.net_g.load_state_dict(payload["params"])
    state.g_ema.load_state_dict(payload["params_ema"])
    return state
