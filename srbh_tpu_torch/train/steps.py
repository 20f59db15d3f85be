"""Train / eval / predict steps of the height model.

Counterparts of ``srbh_tpu/train/steps.py``: the frozen Real-ESRGAN feature
pass under ``torch.no_grad()`` in eval mode (the JAX step's
``stop_gradient``, train.py:244), the height model in training mode
(BatchNorm over the batch's statistics, Bessel-corrected running variance,
drop-connect), the three adaptive losses (train.py:251-253), and one Adam
update of the model and the log-vars.

Batches are dicts of NHWC arrays or tensors, as the JAX steps take them:
``image`` (N, 64, 64, 8), ``height`` / ``build`` / ``weight`` (N, 256, 256)
and, with ``isaggre``, ``height_aggre`` / ``weight_aggre`` (N, 64, 64).
Entries are moved to the step's device (``non_blocking`` from pinned host
memory). Outputs stay on the device.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.losses.adaptive import (
    ce_dice_adapt,
    ce_dice_adapt_weight,
    mse_adapt,
    mse_adapt_weight,
)

_QUEUE_ITEM_8 = ("{} (in-step augmentation / normalisation) is not ported "
                 "yet: ROADMAP.md Queue 1 item 8")


def _compute(dev: torch.device, dtype: torch.dtype):
    """float32, or autocast in ``dtype`` (parameters stay float32, as the
    JAX package's ``dtype`` keeps its params float32)."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(dev.type, dtype=dtype)


def _to_device(batch, keys, dev):
    return {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
            for k in keys}


def _nchw(image: torch.Tensor) -> torch.Tensor:
    return image.permute(0, 3, 1, 2).float()


def _features(sr_model, image, rgb):
    """The frozen SR features, or none for a model without SR input."""
    if sr_model is None:
        return ()
    with torch.no_grad():
        return (sr_model(image[:, rgb], features_only=True),)


def step_seed(seed: int, step: int) -> int:
    """The drop-connect generator's seed for one step: a hash of
    ``(seed, step)``, as the JAX step folds ``state.step`` into its key."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


def make_train_step(model, sr_model, rgb_idx=(0, 1, 2), isaggre: bool = True,
                    seed: int = 0, device_aug: bool = False, norm=None,
                    dtype: torch.dtype = torch.float32, device=None):
    """Build the aggre+weight train step (train.py:225-271):
    ``step(state, batch, lr) -> {"loss", "rmse", "log_vars"}``, updating
    ``state`` (a :class:`~srbh_tpu_torch.train.state.TrainState` over
    ``model``) in place.

    ``isaggre=False`` is the plain two-head epoch (train.py:274-312):
    ``mse_adapt`` + ``ce_dice_adapt``, no pixel weights, two log-vars.
    ``sr_model=None`` feeds the model no SR features (the nosuper
    ablation). ``seed`` roots the drop-connect draws: step ``k`` uses a
    generator on the device seeded with ``step_seed(seed, k)``. ``dtype``
    other than float32 runs both models under ``torch.autocast``; the losses
    are float32. ``device`` (``None`` is the card) receives both models.

    ``device_aug`` and ``norm`` raise ``NotImplementedError`` (the JAX
    step's ``hir``, ``class_weight`` and ``ishir`` only serve them).
    """
    if device_aug:
        raise NotImplementedError(_QUEUE_ITEM_8.format("device_aug"))
    if norm is not None:
        raise NotImplementedError(_QUEUE_ITEM_8.format("norm"))
    dev = resolve_device(device)
    model.to(dev)
    if sr_model is not None:
        sr_model.eval().to(dev).requires_grad_(False)
    rgb = list(rgb_idx)
    keys = ["image", "height", "build", "weight"]
    if isaggre:
        keys += ["height_aggre", "weight_aggre"]

    def step(state, batch, lr):
        b = _to_device(batch, keys, dev)
        image = _nchw(b["image"])
        height_t = b["height"].float()
        model.train()
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step))
        with _compute(dev, dtype):
            fea = _features(sr_model, image, rgb)
            outs = model(image, *fea, generator=gen)
        lv = state.log_vars
        height = outs[0][:, 0].float()
        build = outs[1].float()
        if isaggre:
            aggre = outs[2][:, 0].float()
            loss = (mse_adapt_weight(height, height_t, b["weight"], lv[0])
                    + mse_adapt_weight(aggre, b["height_aggre"],
                                       b["weight_aggre"], lv[1])
                    + ce_dice_adapt_weight(build, b["build"], b["weight"],
                                           lv[2]))
        else:
            loss = (mse_adapt(height, height_t, lv[0])
                    + ce_dice_adapt(build, b["build"], lv[1]))
        rmse = torch.sqrt(torch.mean((height.detach() - height_t) ** 2))
        loss.backward()
        state.apply_gradients(lr)
        return {"loss": loss.detach(), "rmse": rmse,
                "log_vars": state.log_vars.detach().clone()}

    return step


def _eval_heads(model, sr_model, rgb, dev, dtype, image):
    model.eval()
    x = _nchw(torch.as_tensor(image).to(dev, non_blocking=True))
    with torch.no_grad(), _compute(dev, dtype):
        return model(x, *_features(sr_model, x, rgb))


def make_eval_step(model, sr_model, rgb_idx=(0, 1, 2),
                   dtype: torch.dtype = torch.float32, device=None):
    """Validation step (train.py:315-344): ``step(batch) -> {"loss": mse,
    "rmse": sqrt(mse)}`` on the height head, models in eval mode."""
    dev = resolve_device(device)
    model.to(dev)
    if sr_model is not None:
        sr_model.eval().to(dev)
    rgb = list(rgb_idx)

    def step(batch):
        outs = _eval_heads(model, sr_model, rgb, dev, dtype, batch["image"])
        target = torch.as_tensor(batch["height"]).to(dev).float()
        mse = torch.mean((outs[0][:, 0].float() - target) ** 2)
        return {"loss": mse, "rmse": torch.sqrt(mse)}

    return step


def make_predict_step(model, sr_model, rgb_idx=(0, 1, 2), device=None):
    """Inference step ``step(image) -> (height (N, H, W), build logits
    (N, H, W, C))`` in float32, NHWC like the JAX step's outputs."""
    dev = resolve_device(device)
    model.to(dev)
    if sr_model is not None:
        sr_model.eval().to(dev)
    rgb = list(rgb_idx)

    def step(image):
        outs = _eval_heads(model, sr_model, rgb, dev, torch.float32, image)
        return outs[0][:, 0], outs[1].permute(0, 2, 3, 1)

    return step
