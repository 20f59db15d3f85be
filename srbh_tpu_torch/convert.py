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
* LayerNorm ``scale/bias`` -> ``weight/bias``;
* spectral-normalised convs: the kernel -> ``weight_orig``, the power
  iteration's ``u`` (``batch_stats``) -> ``weight_u``; flax keeps no ``v``,
  so ``weight_v`` is ``n(W^T u)``, the next iteration's (no forward reads
  it);
* optax Adam states (``count``, ``mu``, ``nu``) -> torch Adam states
  (``step``, ``exp_avg``, ``exp_avg_sq``), through the same name mapping.

It also reads the JAX package's ``.npz`` files (:func:`load_tree_npz`) and
starts an encoder from ImageNet weights (:func:`graft_encoder`): an
efficientnet-pytorch state dict, or the JAX package's encoder ``.npz``
through :func:`encoder_state_dict_from_npz`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from srbh_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    SCALING,
    round_repeats,
)
from srbh_tpu_torch.models.vgg import VGG19_CFG

StateDict = Dict[str, torch.Tensor]

_NPZ_SEP, _NPZ_MARKER = "\x1f", "__srbh-npz-sep-1f__"
# efficientnet-pytorch's classifier head, which the U-Net's encoder lacks
_IMAGENET_HEAD = ("_conv_head.", "_bn1.", "_fc.")


def load_tree_npz(path: str) -> dict:
    """A JAX ``.npz`` (``srbh_tpu.train.convert.save_tree_npz``: a flat npz
    whose keys join the tree's path with ``\x1f``, or ``/`` in older
    files) as the nested dict it was saved from."""
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


def _adam_moments(opt_state: Mapping, to_sd) -> dict:
    """``{"exp_avg": {name: t}, "exp_avg_sq": {...}, "step": n}`` from an
    optax ``adam`` state in flax state-dict form (``{"0": {"count", "mu",
    "nu"}, "1": ...}``); ``to_sd`` maps a params tree to a state dict."""
    adam = opt_state["0"]
    return {"exp_avg": to_sd(adam["mu"]), "exp_avg_sq": to_sd(adam["nu"]),
            "step": int(np.asarray(adam["count"]))}


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt((x * x).sum() + 1e-12)


def unet_discriminator_sn_state_dict(variables: Mapping) -> StateDict:
    """UNetDiscriminatorSN: ``conv0`` / ``conv9`` and the spectral-normalised
    ``conv{1..8}.weight_orig`` / ``weight_u`` / ``weight_v``; without
    ``batch_stats`` (a params tree, as for Adam's moments) only the
    parameters."""
    p = variables["params"]
    stats = variables.get("batch_stats")
    sd: StateDict = {}
    _conv(sd, "conv0", p["conv0"])
    for i in range(1, 9):
        w = np.asarray(p[f"conv{i}"]["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"conv{i}.weight_orig"] = _t(w)
        if stats is not None:
            u = np.asarray(stats[f"conv{i}_sn"][f"conv{i}/kernel/u"],
                           np.float32).reshape(-1)
            sd[f"conv{i}.weight_u"] = _t(u)
            sd[f"conv{i}.weight_v"] = _t(_l2n(w.reshape(w.shape[0], -1).T @ u))
    _conv(sd, "conv9", p["conv9"])
    return sd


def vgg19_state_dict(variables: Mapping) -> StateDict:
    """VGG19Features: the JAX ``conv{k}`` -> torchvision ``features.{i}``
    (conv, ReLU pairs, a pool after each stage)."""
    p = variables["params"]
    sd: StateDict = {}
    seq = conv = 0
    for item in VGG19_CFG:
        if item == "M":
            seq += 1
            continue
        if f"conv{conv}" in p:
            _conv(sd, f"features.{seq}", p[f"conv{conv}"])
        seq += 2
        conv += 1
    return sd


def vgg_style_discriminator_state_dict(variables: Mapping,
                                       input_size: int = 128) -> StateDict:
    """VGGStyleDiscriminator: ``conv{i}_{j}``, ``bn{i}_{j}``, ``linear1/2``.
    ``linear1``'s inputs are the JAX model's NHWC flattening, reordered to
    the port's NCHW one."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    stages = 5 if input_size == 128 else 6
    for i in range(stages):
        for j in (0, 1):
            if f"conv{i}_{j}" in p:
                _conv(sd, f"conv{i}_{j}", p[f"conv{i}_{j}"])
            if f"bn{i}_{j}" in p:
                _bn(sd, f"bn{i}_{j}", p[f"bn{i}_{j}"], s[f"bn{i}_{j}"])
    k = np.asarray(p["linear1"]["kernel"])
    c = np.asarray(p[f"bn{stages - 1}_1"]["scale"]).shape[0]
    side = int(round((k.shape[0] / c) ** 0.5))
    sd["linear1.weight"] = _t(k.reshape(side, side, c, -1).transpose(3, 2, 0, 1)
                              .reshape(k.shape[1], -1))
    sd["linear1.bias"] = _t(p["linear1"]["bias"])
    _dense(sd, "linear2", p["linear2"])
    return sd


def gan_state_from_jax(g_params: Mapping, g_ema: Mapping, d_vars: Mapping,
                       g_opt: Optional[Mapping] = None,
                       d_opt: Optional[Mapping] = None, num_block: int = 23):
    """The JAX package's GAN train state -> the port's: ``(g, g_ema, d,
    g_moments, d_moments)``, the generator's, its EMA's and the
    discriminator's state dicts, and, for each optax Adam state given (flax
    state-dict form), the torch Adam moments by parameter name
    (``sr_trainer.load_adam_moments``), else ``None``."""
    g_sd = lambda tree: rrdbnet_state_dict({"params": tree}, num_block)
    d_sd = lambda tree: unet_discriminator_sn_state_dict({"params": tree})
    return (g_sd(g_params), g_sd(g_ema), unet_discriminator_sn_state_dict(d_vars),
            None if g_opt is None else _adam_moments(g_opt, g_sd),
            None if d_opt is None else _adam_moments(d_opt, d_sd))


def _basic_block(sd: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    for i in (1, 2):
        _conv(sd, f"{prefix}.conv{i}", p[f"conv{i}"])
        _bn(sd, f"{prefix}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    if "down_conv" in p:
        _conv(sd, f"{prefix}.downsample.0", p["down_conv"])
        _bn(sd, f"{prefix}.downsample.1", p["down_bn"], s["down_bn"])


def _blocks(sd: StateDict, prefix: str, p: Mapping, s: Mapping,
            jax_name: str) -> None:
    """Three basic blocks in a Sequential: JAX ``{jax_name}{i}`` ->
    ``{prefix}.{i}``."""
    for i in range(3):
        _basic_block(sd, f"{prefix}.{i}", p[f"{jax_name}{i}"],
                     s[f"{jax_name}{i}"])


def _upsampler(sd: StateDict, prefix: str, p: Mapping) -> None:
    """PixelShuffleUpsampler: JAX ``conv_{k}`` -> ``{prefix}.{2k}``."""
    for k in range(len(p)):
        _conv(sd, f"{prefix}.{2 * k}", p[f"conv_{k}"])


def _hrfuse_residual(sd: StateDict, prefix: str, p: Mapping,
                     s: Mapping) -> None:
    _upsampler(sd, f"{prefix}.upsampler", p["upsampler"])
    _blocks(sd, f"{prefix}.fuse", p, s, "fuse")
    _conv(sd, f"{prefix}.conv_last", p["conv_last"])


def _refine_residual(sd: StateDict, prefix: str, p: Mapping,
                     s: Mapping) -> None:
    _blocks(sd, f"{prefix}.fuse", p, s, "fuse")
    _conv(sd, f"{prefix}.conv_last", p["conv_last"])


def _hrfuse_conv_bn(sd: StateDict, prefix: str, p: Mapping,
                    s: Mapping) -> None:
    """HRFuse / HRFuseX2: the JAX ``fuse{0,1}`` ConvBNActs -> the flat
    ``{prefix}.fuse`` Sequential's ``0/1`` and ``3/4``."""
    for j, name in ((0, "fuse0"), (3, "fuse1")):
        _conv(sd, f"{prefix}.fuse.{j}", p[name]["conv"])
        _bn(sd, f"{prefix}.fuse.{j + 1}", p[name]["bn"], s[name]["bn"])
    _upsampler(sd, f"{prefix}.upsampler", p["upsampler"])
    _conv(sd, f"{prefix}.conv_last", p["conv_last"])


def _encoder_blocks(encoder_name: str):
    """The JAX name of each MBConv block of ``encoder_name`` in order, and
    whether it has an expansion conv."""
    _, depth, _ = SCALING[encoder_name]
    return [(f"blocks_{si}_{bi}", expand != 1)
            for si, (expand, *_rest, base_r) in enumerate(_B0_STAGES, 1)
            for bi in range(round_repeats(base_r, depth))]


def _encoder_state_dict(sd: StateDict, prefix: str, ep: Mapping, es: Mapping,
                        encoder_name: str) -> None:
    """The EfficientNet encoder with efficientnet-pytorch's names:
    ``{prefix}_conv_stem``, ``{prefix}_bn0``, ``{prefix}_blocks.{n}.*``."""
    _conv(sd, f"{prefix}_conv_stem", ep["stem_conv"])
    _bn(sd, f"{prefix}_bn0", ep["stem_bn"], es["stem_bn"])
    for tn, (name, expands) in enumerate(_encoder_blocks(encoder_name)):
        t = f"{prefix}_blocks.{tn}"
        bp, bs = ep[name], es[name]
        if expands:
            _conv(sd, f"{t}._expand_conv", bp["expand_conv"])
            _bn(sd, f"{t}._bn0", bp["expand_bn"], bs["expand_bn"])
        _conv(sd, f"{t}._depthwise_conv", bp["dw_conv"])
        _bn(sd, f"{t}._bn1", bp["dw_bn"], bs["dw_bn"])
        _conv(sd, f"{t}._se_reduce", bp["se_reduce"])
        _conv(sd, f"{t}._se_expand", bp["se_expand"])
        _conv(sd, f"{t}._project_conv", bp["project_conv"])
        _bn(sd, f"{t}._bn2", bp["project_bn"], bs["project_bn"])


def _trunk_state_dict(p: Mapping, s: Mapping, encoder_name: str,
                      decoders=("decoder1", "decoder2")) -> StateDict:
    """The encoder and the U-Net decoders the height models share:
    ``encoder.*``, ``{decoder}.blocks.{i}.conv{1,2}.{0,1}``."""
    sd: StateDict = {}
    _encoder_state_dict(sd, "encoder.", p["encoder"], s["encoder"], encoder_name)
    for dname in decoders:
        nblocks = len([k for k in p[dname] if k.startswith("block")])
        for bi in range(nblocks):
            for ci in (1, 2):
                bp = p[dname][f"block{bi}"][f"conv{ci}"]
                bs = s[dname][f"block{bi}"][f"conv{ci}"]
                prefix = f"{dname}.blocks.{bi}.conv{ci}"
                _conv(sd, f"{prefix}.0", bp["conv"])
                _bn(sd, f"{prefix}.1", bp["bn"], bs["bn"])
    return sd


def height_model_state_dict(variables: Mapping,
                            encoder_name: str = "efficientnet-b4",
                            isaggre: bool = True) -> StateDict:
    """SRRegressClsFeature and its Geo / Refine variants: ``encoder.*``
    (efficientnet-pytorch names), ``decoder{1,2}.blocks.{i}.conv{1,2}.{0,1}``,
    ``hrfeat.{i}.*``, ``{reg,seg}.upsampler.{2k}/fuse.{i}/conv_last`` and
    ``aggre_height``; ``geoprior.{i}.*`` and ``refine.fuse.{i}.*`` /
    ``refine.conv_last`` where the JAX tree has them."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _trunk_state_dict(p, s, encoder_name)
    _blocks(sd, "hrfeat", p["hrfeat"], s["hrfeat"], "block")
    for head in ("reg", "seg"):
        _hrfuse_residual(sd, head, p[head], s[head])
    if isaggre:
        _conv(sd, "aggre_height", p["aggre_height"])
    if "geoprior" in p:
        _blocks(sd, "geoprior", p["geoprior"], s["geoprior"], "block")
    if "refine" in p:
        _refine_residual(sd, "refine", p["refine"], s["refine"])
    return sd


def nosuper_state_dict(variables: Mapping, encoder_name: str = "efficientnet-b4",
                       isaggre: bool = True) -> StateDict:
    """SRRegressClsNosuper: the trunk of :func:`height_model_state_dict`,
    ``{reg,seg}.upsampler.{2k}`` / ``{reg,seg}.conv_last`` and
    ``aggre_height``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = _trunk_state_dict(p, s, encoder_name)
    for head in ("reg", "seg"):
        _upsampler(sd, f"{head}.upsampler", p[head]["upsampler"])
        _conv(sd, f"{head}.conv_last", p[head]["conv_last"])
    if isaggre:
        _conv(sd, "aggre_height", p["aggre_height"])
    return sd


MODEL_STATE_DICTS = {"feature": height_model_state_dict,
                     "nosuper": nosuper_state_dict}


def encoder_state_dict_from_npz(path: str, encoder_name: str) -> StateDict:
    """The JAX package's ImageNet-encoder ``.npz`` (``params`` /
    ``batch_stats`` of an ``EfficientNetEncoder``, written by ``python -m
    srbh_tpu.train.convert effnet.pth enc.npz --arch imagenet-encoder``) as
    an efficientnet-pytorch state dict for :func:`graft_encoder`. Raises
    ``ValueError`` naming ``path`` if the file holds another encoder."""
    tree = load_tree_npz(path)
    want = {"stem_conv", "stem_bn"} | {n for n, _ in _encoder_blocks(encoder_name)}
    if not {"params", "batch_stats"} <= set(tree) or set(tree["params"]) != want:
        raise ValueError(f"{path} is not an encoder npz of {encoder_name} "
                         "(params / batch_stats of stem_conv, stem_bn and "
                         f"{len(want) - 2} blocks)")
    sd: StateDict = {}
    _encoder_state_dict(sd, "", tree["params"], tree["batch_stats"], encoder_name)
    return sd


def widen_stem(weight: torch.Tensor, in_channels: int) -> torch.Tensor:
    """smp's ``patch_first_conv`` for more input channels than the
    checkpoint's: cycle the kernel's input channels (axis 1 of OIHW) and
    scale by old / new, so activations keep their pretrained size."""
    old = weight.shape[1]
    return weight[:, [i % old for i in range(in_channels)]] * (old / in_channels)


def graft_encoder(encoder: nn.Module, sd: Mapping, source: str) -> None:
    """Load ImageNet weights with efficientnet-pytorch's names (``sd``, from
    ``source``) into ``encoder``, the reference's ``encoder_weights=
    "imagenet"`` start (mymodels.py:234,242-243): the classifier head
    (``_conv_head``, ``_bn1``, ``_fc``) is dropped, a stem with other input
    channels is widened (:func:`widen_stem`), and a missing
    ``num_batches_tracked`` keeps the encoder's. Raises ``ValueError``
    naming ``source`` if a key is missing or left over, or a shape differs."""
    want = encoder.state_dict()
    got = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
           if not k.startswith(_IMAGENET_HEAD)}
    stem = got.get("_conv_stem.weight")
    if stem is not None and stem.shape[1] != want["_conv_stem.weight"].shape[1]:
        got["_conv_stem.weight"] = widen_stem(stem, want["_conv_stem.weight"].shape[1])
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            got.setdefault(k, v)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    shapes = [k for k in set(want) & set(got) if got[k].shape != want[k].shape]
    if missing or extra or shapes:
        raise ValueError(f"encoder weights {source} do not fit the model's "
                         f"encoder: missing {missing[:3]}, unexpected "
                         f"{extra[:3]}, other shapes {sorted(shapes)[:3]}")
    encoder.load_state_dict({k: v.to(want[k].dtype) for k, v in got.items()})


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
                         isaggre: bool = True, model_variant: str = "feature"):
    """The JAX package's height train state -> the port's.

    Returns ``(state_dict, log_vars, moments)``: the height model's state
    dict (:func:`height_model_state_dict`, or :func:`nosuper_state_dict`
    for ``model_variant="nosuper"``), the log-vars as a float32
    tensor, and, when ``opt_state`` is given (the optax state of
    ``srbh_tpu.train.state.TrainState`` in flax state-dict form, as the JAX
    checkpoints store it), Adam's ``mu`` / ``nu`` / ``count`` as the torch
    optimizer's ``exp_avg`` / ``exp_avg_sq`` / ``step`` for
    ``TrainState.load_moments`` (else ``None``). The moments of each
    parameter take its layout, so they pass through the same name mapping.
    """
    to_sd = MODEL_STATE_DICTS[model_variant]
    variables = {"params": params, "batch_stats": batch_stats}
    sd = to_sd(variables, encoder_name, isaggre)
    lv = _t(log_vars)
    if opt_state is None:
        return sd, lv, None
    groups = opt_state["inner_states"]
    model, lvs = _adam_state(groups["model"]), _adam_state(groups["log_vars"])
    names = [k for k, v in sd.items() if k.rsplit(".", 1)[-1] in
             ("weight", "bias")]

    def tree(moment):
        out = to_sd(
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


def espcn_state_dict(variables: Mapping) -> StateDict:
    """ESPCN: ``conv1``, ``conv2``, ``conv3``."""
    sd: StateDict = {}
    for i in (1, 2, 3):
        _conv(sd, f"conv{i}", variables["params"][f"conv{i}"])
    return sd


def _edsr(sd: StateDict, prefix: str, p: Mapping) -> None:
    _conv(sd, f"{prefix}head.0", p["head"])
    n = len([k for k in p if k.startswith("body_") and k != "body_conv"])
    for i in range(n):
        _conv(sd, f"{prefix}body.{i}.body.0", p[f"body_{i}"]["conv1"])
        _conv(sd, f"{prefix}body.{i}.body.2", p[f"body_{i}"]["conv2"])
    _conv(sd, f"{prefix}body.{n}", p["body_conv"])
    _upsampler(sd, f"{prefix}tail.0", p["upsampler"])
    _conv(sd, f"{prefix}tail.1", p["tail"])


def edsr_state_dict(variables: Mapping) -> StateDict:
    """EDSR: ``head.0``, ``body.{i}.body.{0,2}``, ``body.{n}``,
    ``tail.0.{2k}``, ``tail.1``."""
    sd: StateDict = {}
    _edsr(sd, "", variables["params"])
    return sd


def rrdbnet_simple_state_dict(variables: Mapping,
                              num_block: int = 23) -> StateDict:
    """RRDBNetSimple: ``conv_first``, ``RRDB_trunk.{i}.RDB{r}.conv{c}``,
    ``trunk_conv``, ``upconv1/2``, ``HRconv``, ``conv_last``."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, "conv_first", p["conv_first"])
    for i in range(num_block):
        for r in (1, 2, 3):
            for c in (1, 2, 3, 4, 5):
                _conv(sd, f"RRDB_trunk.{i}.RDB{r}.conv{c}",
                      p[f"body_{i}"][f"rdb{r}"][f"conv{c}"])
    for name in ("trunk_conv", "upconv1", "upconv2", "HRconv", "conv_last"):
        _conv(sd, name, p[name])
    return sd


def sr_regress_state_dict(variables: Mapping,
                          encoder_name: str = "efficientnet-b4") -> StateDict:
    """The trainable-SR ablations, told apart by their heads: SRRegress
    (``head``), SRRegressClsEDSR (``super_out``, ``seg{1,2}`` convs) and
    SRRegressClsDecision (``seg{1,2}`` HRFuseX2 blocks); ``super_res.*``
    are :func:`edsr_state_dict`'s names."""
    p, s = variables["params"], variables["batch_stats"]
    single = "head" in p
    sd = _trunk_state_dict(p, s, encoder_name,
                           ("decoder",) if single else ("decoder1", "decoder2"))
    _edsr(sd, "super_res.", p["super_res"])
    if single:
        _conv(sd, "head", p["head"])
    elif "super_out" in p:
        for name in ("super_out", "seg1", "seg2"):
            _conv(sd, name, p[name])
    else:
        for name in ("seg1", "seg2"):
            _hrfuse_conv_bn(sd, name, p[name], s[name])
    return sd


def lpips_state_dict(variables: Mapping) -> StateDict:
    """LPIPS-alex: ``net.slice{s}.{i}`` (torchvision's ``features``
    indices), ``lin{t}.model.1.weight`` and lpips' ``scaling_layer``
    constants."""
    from srbh_tpu_torch.models.lpips import (
        _ALEX_CONVS,
        scaling_state_dict,
        trunk_conv_name,
    )

    p = variables["params"]
    sd: StateDict = scaling_state_dict()
    for t, (idx, *_rest) in enumerate(_ALEX_CONVS):
        _conv(sd, trunk_conv_name(idx), p["net"][f"conv{t}"])
        _conv(sd, f"lin{t}.model.1", p[f"lin{t}"])
    return sd


def clip_visual_state_dict(variables: Mapping, layers: int = 12) -> StateDict:
    """CLIPVisionTransformer: OpenAI CLIP's / open_clip's ``visual.*``
    names without the prefix (the inverse of ``convert_clip_visual``)."""
    p = variables["params"]
    sd: StateDict = {
        "class_embedding": _t(p["class_embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        "proj": _t(p["proj"])}
    _conv(sd, "conv1", p["conv1"])
    if "ln_pre" in p:
        _norm(sd, "ln_pre", p["ln_pre"])
    for i in range(layers):
        bp, t = p[f"resblock_{i}"], f"transformer.resblocks.{i}."
        _norm(sd, t + "ln_1", bp["ln_1"])
        sd[t + "attn.in_proj_weight"] = _t(np.asarray(bp["attn_in"]["kernel"]).T)
        sd[t + "attn.in_proj_bias"] = _t(bp["attn_in"]["bias"])
        _dense(sd, t + "attn.out_proj", bp["attn_out"])
        _norm(sd, t + "ln_2", bp["ln_2"])
        _dense(sd, t + "mlp.c_fc", bp["mlp_c_fc"])
        _dense(sd, t + "mlp.c_proj", bp["mlp_c_proj"])
    _norm(sd, "ln_post", p["ln_post"])
    return sd


def siglip_visual_state_dict(variables: Mapping, layers: int = 27) -> StateDict:
    """MAPVisionTransformer: timm's SigLIP trunk names, open_clip's
    ``visual.trunk.*`` without the prefix (the inverse of
    ``convert_siglip_visual``)."""
    p = variables["params"]
    width = np.asarray(p["latent"]).shape[-1]
    sd: StateDict = {"pos_embed": _t(p["pos_embed"])[None],
                     "attn_pool.latent": _t(p["latent"]).reshape(1, 1, width)}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    for i in range(layers):
        bp, t = p[f"resblock_{i}"], f"blocks.{i}."
        _norm(sd, t + "norm1", bp["ln_1"])
        _dense(sd, t + "attn.qkv", bp["attn_in"])
        _dense(sd, t + "attn.proj", bp["attn_out"])
        _norm(sd, t + "norm2", bp["ln_2"])
        _dense(sd, t + "mlp.fc1", bp["mlp_c_fc"])
        _dense(sd, t + "mlp.fc2", bp["mlp_c_proj"])
    _norm(sd, "norm", p["norm"])
    for jax_name, name in (("pool_q", "q"), ("pool_kv", "kv"),
                           ("pool_proj", "proj"), ("pool_mlp_fc1", "mlp.fc1"),
                           ("pool_mlp_fc2", "mlp.fc2")):
        _dense(sd, f"attn_pool.{name}", p[jax_name])
    _norm(sd, "attn_pool.norm", p["pool_norm"])
    return sd


def save_tree_npz(path: str, tree: Mapping) -> None:
    """A nested tree of arrays as the JAX package's flat ``.npz``
    (``srbh_tpu.train.convert.save_tree_npz``'s format: keys joined with
    ``\x1f``, and its marker key), which :func:`load_tree_npz` and the JAX
    package read."""
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                flat[_NPZ_SEP.join(path + (k,))] = np.asarray(v)

    walk(tree, ())
    flat[_NPZ_MARKER] = np.zeros(0, np.uint8)
    np.savez(path, **flat)


def _jax_conv(sd: Mapping, name: str) -> dict:
    out = {"kernel": np.asarray(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def _jax_bn(sd: Mapping, name: str):
    return ({"scale": np.asarray(sd[f"{name}.weight"]),
             "bias": np.asarray(sd[f"{name}.bias"])},
            {"mean": np.asarray(sd[f"{name}.running_mean"]),
             "var": np.asarray(sd[f"{name}.running_var"])})


def _jax_basic_block(sd: Mapping, prefix: str):
    p = {c: _jax_conv(sd, f"{prefix}.{c}") for c in ("conv1", "conv2")}
    s = {}
    for b in ("bn1", "bn2"):
        p[b], s[b] = _jax_bn(sd, f"{prefix}.{b}")
    if f"{prefix}.downsample.0.weight" in sd:
        p["down_conv"] = _jax_conv(sd, f"{prefix}.downsample.0")
        p["down_bn"], s["down_bn"] = _jax_bn(sd, f"{prefix}.downsample.1")
    return p, s


def height_model_variables(sd: Mapping, isaggre: bool = True,
                           encoder_name: str = "efficientnet-b4") -> dict:
    """The JAX package's variables of ``SRRegressClsFeature`` from the
    port's (the reference's) state dict: the port's copy of
    ``srbh_tpu.train.convert.convert_height_model``, so the port can write
    the npz that :func:`main` reads back."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
          for k, v in sd.items()}
    params: dict = {"encoder": {"stem_conv": _jax_conv(sd, "encoder._conv_stem")}}
    stats: dict = {"encoder": {}}
    ep, es = params["encoder"], stats["encoder"]
    ep["stem_bn"], es["stem_bn"] = _jax_bn(sd, "encoder._bn0")
    for tn, (name, expands) in enumerate(_encoder_blocks(encoder_name)):
        t, bp, bs = f"encoder._blocks.{tn}", {}, {}
        if expands:
            bp["expand_conv"] = _jax_conv(sd, f"{t}._expand_conv")
            bp["expand_bn"], bs["expand_bn"] = _jax_bn(sd, f"{t}._bn0")
        bp["dw_conv"] = _jax_conv(sd, f"{t}._depthwise_conv")
        bp["dw_bn"], bs["dw_bn"] = _jax_bn(sd, f"{t}._bn1")
        for c in ("se_reduce", "se_expand", "project_conv"):
            bp[c] = _jax_conv(sd, f"{t}._{c}")
        bp["project_bn"], bs["project_bn"] = _jax_bn(sd, f"{t}._bn2")
        ep[name], es[name] = bp, bs
    for dname in ("decoder1", "decoder2"):
        params[dname], stats[dname] = {}, {}
        bi = 0
        while f"{dname}.blocks.{bi}.conv1.0.weight" in sd:
            bp, bs = {}, {}
            for c in ("conv1", "conv2"):
                base = f"{dname}.blocks.{bi}.{c}"
                bp[c] = {"conv": _jax_conv(sd, f"{base}.0")}
                bp[c]["bn"], bn_s = _jax_bn(sd, f"{base}.1")
                bs[c] = {"bn": bn_s}
            params[dname][f"block{bi}"], stats[dname][f"block{bi}"] = bp, bs
            bi += 1
    params["hrfeat"], stats["hrfeat"] = {}, {}
    for i in range(3):
        params["hrfeat"][f"block{i}"], stats["hrfeat"][f"block{i}"] = \
            _jax_basic_block(sd, f"hrfeat.{i}")
    for head in ("reg", "seg"):
        k, ups = 0, {}
        while f"{head}.upsampler.{2 * k}.weight" in sd:
            ups[f"conv_{k}"] = _jax_conv(sd, f"{head}.upsampler.{2 * k}")
            k += 1
        params[head], stats[head] = {"upsampler": ups}, {}
        for i in range(3):
            params[head][f"fuse{i}"], stats[head][f"fuse{i}"] = \
                _jax_basic_block(sd, f"{head}.fuse.{i}")
        params[head]["conv_last"] = _jax_conv(sd, f"{head}.conv_last")
    if isaggre and "aggre_height.weight" in sd:
        params["aggre_height"] = _jax_conv(sd, "aggre_height")
    return {"params": params, "batch_stats": stats}


ARCHS = ("height", "nosuper", "rrdbnet", "rrdbnet-simple", "edsr", "espcn",
         "swinir", "unet-sn", "imagenet-encoder", "sr-regress", "vgg19",
         "lpips", "clip", "siglip")


def _count(params: Mapping, prefix: str) -> int:
    """How many ``{prefix}{i}`` subtrees ``params`` holds."""
    return len([k for k in params if k.startswith(prefix) and k[len(prefix):].isdigit()])


def _variables(tree: Mapping, key: Optional[str]) -> dict:
    """The variables tree to convert: ``tree[key]`` if ``key`` is given
    (e.g. a GAN checkpoint's ``params_ema``), and a bare params tree
    wrapped as ``{"params": ...}``."""
    tree = tree[key] if key else tree
    return dict(tree) if "params" in tree else {"params": tree}


def height_checkpoint(tree: Mapping, sd: StateDict) -> dict:
    """The reference's checkpoint dict (train.py:199-212): ``epoch``,
    ``state_dict``, ``log_vars`` (a list of one-element tensors, the
    adaptive losses' weights) and ``best_acc``, from a JAX height npz's
    ``log_vars/`` (``{"w1": ...}`` scalars or an array) and ``meta/``."""
    lv = tree.get("log_vars")
    if isinstance(lv, Mapping):
        lv = [lv[k] for k in sorted(lv, key=lambda s: int(s[1:]))]
    meta = tree.get("meta", {})
    return {"epoch": int(np.asarray(meta.get("epoch", 0))),
            "state_dict": sd,
            "log_vars": [] if lv is None else [_t(np.reshape(v, (1,))) for v in lv],
            "best_acc": float(np.asarray(meta.get("best_acc", float("inf"))))}


def main(argv=None) -> str:
    """CLI: a JAX ``.npz`` (``srbh_tpu.train.convert.save_tree_npz``'s format)
    -> a torch file that the port's modules load with ``load_state_dict``.

        python -m srbh_tpu_torch.convert height.npz checkpoint20 --arch height
        python -m srbh_tpu_torch.convert sr.npz sr.pth --arch rrdbnet \\
            --key params_ema

    The inverse of ``python -m srbh_tpu.train.convert``. ``--arch height``
    (and ``nosuper``) writes the reference's checkpoint dict ``{'epoch',
    'state_dict', 'log_vars', 'best_acc'}``, which ``trainer.main_test``
    reads and names its acc files by; every other arch writes the state dict
    alone. Block and layer counts are read from the npz."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.convert",
                                 description=main.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="JAX .npz of a variables tree")
    ap.add_argument("output", help="output torch file")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--key", default=None,
                    help="subtree to convert (e.g. params_ema of a GAN npz)")
    ap.add_argument("--no-aggre", action="store_true",
                    help="height / nosuper: model without the aggre_height conv")
    ap.add_argument("--upsampler", default="pixelshuffle", help="SwinIR head mode")
    ap.add_argument("--encoder-name", default="efficientnet-b4")
    args = ap.parse_args(argv)

    if args.arch == "imagenet-encoder":
        out = encoder_state_dict_from_npz(args.input, args.encoder_name)
    else:
        tree = load_tree_npz(args.input)
        v = _variables(tree, args.key)
        p = v["params"]
        if args.arch in ("height", "nosuper"):
            to_sd = MODEL_STATE_DICTS["feature" if args.arch == "height" else "nosuper"]
            out = height_checkpoint(tree, to_sd(v, args.encoder_name,
                                                not args.no_aggre))
        elif args.arch in ("rrdbnet", "rrdbnet-simple"):
            to_sd = (rrdbnet_state_dict if args.arch == "rrdbnet"
                     else rrdbnet_simple_state_dict)
            out = to_sd(v, _count(p, "body_"))
        elif args.arch == "swinir":
            depths = [_count(p[f"layer{i}"], "block")
                      for i in range(_count(p, "layer"))]
            out = swinir_state_dict(v, depths, args.upsampler)
        elif args.arch in ("clip", "siglip"):
            to_sd = (clip_visual_state_dict if args.arch == "clip"
                     else siglip_visual_state_dict)
            out = to_sd(v, _count(p, "resblock_"))
        elif args.arch == "sr-regress":
            out = sr_regress_state_dict(v, args.encoder_name)
        else:
            out = {"edsr": edsr_state_dict, "espcn": espcn_state_dict,
                   "unet-sn": unet_discriminator_sn_state_dict,
                   "vgg19": vgg19_state_dict,
                   "lpips": lpips_state_dict}[args.arch](v)
    torch.save(out, args.output)
    print(f"wrote {args.output} ({args.arch})")
    return args.output


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
