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
memory). Outputs stay on the device. With ``device_aug`` a batch is only
``image`` and ``height`` (augmentation and targets run in the step), and
with ``norm`` also only raw ``s2`` / ``s1`` in place of ``image``.
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
from srbh_tpu_torch.ops.device_aug import (
    AUG_TAG,
    augment_batch,
    build_targets,
    draw_augment,
)
from srbh_tpu_torch.ops.hierarchy import DEFAULT_HIR, build_hierarchy_lut


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


def step_seed(seed: int, step: int, *tag: int) -> int:
    """A generator's seed for one step: a hash of ``(seed, step)`` for the
    drop-connect draws, as the JAX step folds ``state.step`` into its key,
    and of ``(seed, tag, step)`` for a stream of its own (the augmentation
    draws: ``AUG_TAG``)."""
    return int(np.random.SeedSequence((seed, *tag, step)).generate_state(1)[0])


def _augment(b, dev, seed, step, norm, lut, cw, isaggre, ishir):
    """The batch the model trains on, from a device-aug batch: normalise the
    raw DNs (``norm``; in float64, rounded to float32, as the host pipeline
    does, so the batch is bit-equal to a host-normalised one), augment, clip
    to [0, 1] (``norm``: the host clips after augmenting), then build the
    targets."""
    if norm is not None:
        image = torch.cat([((b[k].double() - norm[f"{k}_off"])
                            / norm[f"{k}_scale"]).float()
                           for k in ("s2", "s1")], -1)
    else:
        image = b["image"].float()
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step, AUG_TAG))
    img, height = augment_batch(image, b["height"], draw_augment(len(image), gen))
    if norm is not None:
        img = img.clamp(0, 1)
    if ishir:
        return {"image": img, **build_targets(height, lut, cw, isaggre)}
    # the host's ishir=False targets: a binary build mask, unit weights
    hf = height.float()
    return {"image": img, "height": hf, "build": (hf > 0).to(torch.int32),
            "weight": torch.ones_like(hf)}


def make_train_step(model, sr_model, rgb_idx=(0, 1, 2), isaggre: bool = True,
                    seed: int = 0, device_aug: bool = False, hir=None,
                    class_weight=None, norm=None, ishir: bool = True,
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

    ``device_aug`` augments the batch and builds its targets in the step
    (``ops/device_aug.py``) from ``hir`` and ``class_weight`` (the dataset's
    ``heightweight``; ones if ``None``), or, with ``ishir=False``, a binary
    build mask and unit weights. Its draws come from a generator on the
    device seeded with ``step_seed(seed, k, AUG_TAG)``, a stream apart from
    the drop-connect one, which stays as without ``device_aug``. ``norm``
    (which needs ``device_aug``), a dict of the dataset's ``s2_off``,
    ``s2_scale``, ``s1_off`` and ``s1_scale``, normalises raw ``s2`` / ``s1``
    in the step before augmenting and clips to [0, 1] after.

    ``step.forward_loss(state, batch) -> (loss, rmse)`` is the step's
    forward alone (``tools/train_diag.py`` times it under ``no_grad``).
    """
    if norm is not None and not device_aug:
        raise ValueError("norm (in-step normalisation) requires device_aug")
    if device_aug and isaggre and not ishir:
        raise ValueError("isaggre=True requires ishir=True")
    dev = resolve_device(device)
    model.to(dev)
    if sr_model is not None:
        sr_model.eval().to(dev).requires_grad_(False)
    rgb = list(rgb_idx)
    keys = ["image", "height", "build", "weight"]
    if isaggre:
        keys += ["height_aggre", "weight_aggre"]
    if device_aug:
        keys = ["s2", "s1", "height"] if norm is not None else ["image", "height"]
        hir = hir or DEFAULT_HIR
        if class_weight is None:
            class_weight = np.ones(len(hir) - 1)
        # the tables live on the device: a copy from pageable host memory
        # each step would make the host wait for the card
        lut = torch.as_tensor(build_hierarchy_lut(hir).astype(np.int64), device=dev)
        cw = torch.as_tensor(np.asarray(class_weight, np.float32), device=dev)
        if norm is not None:
            # float64, as the host pipeline normalises: the batch is then
            # bit-equal to the host-normalised one
            norm = {k: torch.as_tensor(np.asarray(v, np.float64), device=dev)
                    for k, v in norm.items()}

    def forward_loss(state, batch):
        b = _to_device(batch, keys, dev)
        if device_aug:
            b = _augment(b, dev, seed, state.step, norm, lut, cw, isaggre, ishir)
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
        return loss, rmse

    def step(state, batch, lr):
        loss, rmse = forward_loss(state, batch)
        loss.backward()
        state.apply_gradients(lr)
        return {"loss": loss.detach(), "rmse": rmse,
                "log_vars": state.log_vars.detach().clone()}

    step.forward_loss = forward_loss
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


def make_predict_step(model, sr_model, rgb_idx=(0, 1, 2),
                      dtype: torch.dtype = torch.float32, device=None):
    """Inference step ``step(image) -> (height (N, H, W), build logits
    (N, H, W, C))``, NHWC like the JAX step's outputs; ``dtype`` other than
    float32 runs the models under ``torch.autocast``."""
    dev = resolve_device(device)
    model.to(dev)
    if sr_model is not None:
        sr_model.eval().to(dev)
    rgb = list(rgb_idx)

    def step(image):
        outs = _eval_heads(model, sr_model, rgb, dev, dtype, image)
        return outs[0][:, 0], outs[1].permute(0, 2, 3, 1)

    return step
