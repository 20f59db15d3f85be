"""JAX-package variables -> the port's torch ``state_dict``.

The inverse of ``srbh_tpu/train/convert.py``: it takes the JAX package's
variables as nested dicts of arrays (``{"params": ..., "batch_stats": ...}``)
and returns a ``state_dict`` with the reference's torch names, which loads
into the port's modules with ``load_state_dict``. Layout rules:

* conv kernels HWIO -> OIHW; depthwise kernels (k, k, 1, C) -> (C, 1, k, k),
  which is the same transpose;
* dense kernels (in, out) -> weights (out, in);
* BatchNorm ``scale/bias`` params and ``mean/var`` stats -> ``weight/bias/
  running_mean/running_var``, with ``num_batches_tracked`` 0;
* LayerNorm ``scale/bias`` -> ``weight/bias``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from srbh_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    SCALING,
    round_repeats,
)

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: StateDict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: StateDict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, name: str, p: Mapping, s: Mapping) -> None:
    _norm(sd, name, p)
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def rrdbnet_state_dict(variables: Mapping, num_block: int = 23) -> StateDict:
    """RRDBNet: conv_first / body.{i}.rdb{r}.conv{c} / conv_body / conv_up1 /
    conv_up2 / conv_hr / conv_last."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, "conv_first", p["conv_first"])
    for i in range(num_block):
        for r in (1, 2, 3):
            for c in (1, 2, 3, 4, 5):
                _conv(sd, f"body.{i}.rdb{r}.conv{c}",
                      p[f"body_{i}"][f"rdb{r}"][f"conv{c}"])
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        if name in p:
            _conv(sd, name, p[name])
    return sd


def _basic_block(sd: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    for i in (1, 2):
        _conv(sd, f"{prefix}.conv{i}", p[f"conv{i}"])
        _bn(sd, f"{prefix}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    if "down_conv" in p:
        _conv(sd, f"{prefix}.downsample.0", p["down_conv"])
        _bn(sd, f"{prefix}.downsample.1", p["down_bn"], s["down_bn"])


def height_model_state_dict(variables: Mapping,
                            encoder_name: str = "efficientnet-b4",
                            isaggre: bool = True) -> StateDict:
    """SRRegressClsFeature: ``encoder.*`` (efficientnet-pytorch names),
    ``decoder{1,2}.blocks.{i}.conv{1,2}.{0,1}``, ``hrfeat.{i}.*``,
    ``{reg,seg}.upsampler.{2k}/fuse.{i}/conv_last`` and ``aggre_height``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    ep, es = p["encoder"], s["encoder"]
    _conv(sd, "encoder._conv_stem", ep["stem_conv"])
    _bn(sd, "encoder._bn0", ep["stem_bn"], es["stem_bn"])
    _, depth, _ = SCALING[encoder_name]
    tn = 0
    for si, (expand, *_rest, base_r) in enumerate(_B0_STAGES, 1):
        for bi in range(round_repeats(base_r, depth)):
            t = f"encoder._blocks.{tn}"
            bp, bs = ep[f"blocks_{si}_{bi}"], es[f"blocks_{si}_{bi}"]
            if expand != 1:
                _conv(sd, f"{t}._expand_conv", bp["expand_conv"])
                _bn(sd, f"{t}._bn0", bp["expand_bn"], bs["expand_bn"])
            _conv(sd, f"{t}._depthwise_conv", bp["dw_conv"])
            _bn(sd, f"{t}._bn1", bp["dw_bn"], bs["dw_bn"])
            _conv(sd, f"{t}._se_reduce", bp["se_reduce"])
            _conv(sd, f"{t}._se_expand", bp["se_expand"])
            _conv(sd, f"{t}._project_conv", bp["project_conv"])
            _bn(sd, f"{t}._bn2", bp["project_bn"], bs["project_bn"])
            tn += 1
    for dname in ("decoder1", "decoder2"):
        nblocks = len([k for k in p[dname] if k.startswith("block")])
        for bi in range(nblocks):
            for ci in (1, 2):
                bp = p[dname][f"block{bi}"][f"conv{ci}"]
                bs = s[dname][f"block{bi}"][f"conv{ci}"]
                prefix = f"{dname}.blocks.{bi}.conv{ci}"
                _conv(sd, f"{prefix}.0", bp["conv"])
                _bn(sd, f"{prefix}.1", bp["bn"], bs["bn"])
    for i in range(3):
        _basic_block(sd, f"hrfeat.{i}", p["hrfeat"][f"block{i}"],
                     s["hrfeat"][f"block{i}"])
    for head in ("reg", "seg"):
        hp, hs = p[head], s[head]
        for k in range(len(hp["upsampler"])):
            _conv(sd, f"{head}.upsampler.{2 * k}", hp["upsampler"][f"conv_{k}"])
        for i in range(3):
            _basic_block(sd, f"{head}.fuse.{i}", hp[f"fuse{i}"], hs[f"fuse{i}"])
        _conv(sd, f"{head}.conv_last", hp["conv_last"])
    if isaggre:
        _conv(sd, "aggre_height", p["aggre_height"])
    return sd


def _adam_state(opt_group: Mapping) -> Mapping:
    """The ``scale_by_adam`` entry (``count``, ``mu``, ``nu``) of one optax
    group's state, in flax state-dict form: ``inner_state`` of the
    ``MaskedState``, then of ``inject_hyperparams``, then the chain's entry
    that holds ``mu``."""
    chain = opt_group["inner_state"]["inner_state"]
    return next(v for v in chain.values() if "mu" in v)


def train_state_from_jax(params: Mapping, batch_stats: Mapping, log_vars,
                         opt_state: Optional[Mapping] = None,
                         encoder_name: str = "efficientnet-b4",
                         isaggre: bool = True):
    """The JAX package's height train state -> the port's.

    Returns ``(state_dict, log_vars, moments)``: the height model's state
    dict (:func:`height_model_state_dict`), the log-vars as a float32
    tensor, and, when ``opt_state`` is given (the optax state of
    ``srbh_tpu.train.state.TrainState`` in flax state-dict form, as the JAX
    checkpoints store it), Adam's ``mu`` / ``nu`` / ``count`` as the torch
    optimizer's ``exp_avg`` / ``exp_avg_sq`` / ``step`` for
    ``TrainState.load_moments`` (else ``None``). The moments of each
    parameter take its layout, so they pass through the same name mapping.
    """
    variables = {"params": params, "batch_stats": batch_stats}
    sd = height_model_state_dict(variables, encoder_name, isaggre)
    lv = _t(log_vars)
    if opt_state is None:
        return sd, lv, None
    groups = opt_state["inner_states"]
    model, lvs = _adam_state(groups["model"]), _adam_state(groups["log_vars"])
    names = [k for k, v in sd.items() if k.rsplit(".", 1)[-1] in
             ("weight", "bias")]

    def tree(moment):
        out = height_model_state_dict(
            {"params": moment["model"], "batch_stats": batch_stats},
            encoder_name, isaggre)
        return {k: out[k] for k in names}

    moments = {
        "model": {"exp_avg": tree(model["mu"]), "exp_avg_sq": tree(model["nu"]),
                  "step": int(np.asarray(model["count"]))},
        "log_vars": {"exp_avg": _t(lvs["mu"]["log_vars"]),
                     "exp_avg_sq": _t(lvs["nu"]["log_vars"]),
                     "step": int(np.asarray(lvs["count"]))},
    }
    return sd, lv, moments


def swinir_state_dict(variables: Mapping, depths: Sequence[int] = (6, 6, 6, 6),
                      upsampler: str = "pixelshuffle") -> StateDict:
    """SwinIR: ``layers.{l}.residual_group.blocks.{b}.*``, ``layers.{l}.conv``
    (``.0/.2/.4`` for the '3conv' tail), ``patch_embed.norm``, ``norm``,
    ``conv_first``, ``conv_after_body``, the head's convs and
    ``conv_last``."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, "conv_first", p["conv_first"])
    if "patch_norm" in p:
        _norm(sd, "patch_embed.norm", p["patch_norm"])
    for li, depth in enumerate(depths):
        layer = p[f"layer{li}"]
        for bi in range(depth):
            bp = layer[f"block{bi}"]
            base = f"layers.{li}.residual_group.blocks.{bi}"
            _norm(sd, f"{base}.norm1", bp["norm1"])
            _dense(sd, f"{base}.attn.qkv", bp["attn"]["qkv"])
            _dense(sd, f"{base}.attn.proj", bp["attn"]["proj"])
            sd[f"{base}.attn.relative_position_bias_table"] = _t(
                bp["attn"]["relative_position_bias_table"])
            _norm(sd, f"{base}.norm2", bp["norm2"])
            _dense(sd, f"{base}.mlp.fc1", bp["mlp"]["fc1"])
            _dense(sd, f"{base}.mlp.fc2", bp["mlp"]["fc2"])
        if "conv" in layer:
            _conv(sd, f"layers.{li}.conv", layer["conv"])
        else:  # '3conv' tail: Sequential(conv, lrelu, conv, lrelu, conv)
            for k in (1, 2, 3):
                _conv(sd, f"layers.{li}.conv.{2 * (k - 1)}", layer[f"conv{k}"])
    _norm(sd, "norm", p["norm"])
    for name in ("conv_after_body", "conv_up1", "conv_up2", "conv_hr",
                 "conv_last"):
        if name in p:
            _conv(sd, name, p[name])
    if "conv_before_upsample" in p:
        _conv(sd, "conv_before_upsample.0", p["conv_before_upsample"])
    if upsampler == "pixelshuffledirect":
        _conv(sd, "upsample.0", p["upsample_conv"])
    elif "upsample" in p:
        for k in range(len(p["upsample"])):
            _conv(sd, f"upsample.{2 * k}", p["upsample"][f"conv_{k}"])
    return sd
