"""The flagship inference pipeline, built at full width with seeded weights.

Counterpart of ``__graft_entry__._flagship`` / ``entry``: frozen Real-ESRGAN
RRDBNet-23 features feeding the EfficientNet-B4 U-Net height model (the
configuration trained by the reference, train.py:133-148). No pretrained
weights are in the repository, so weights are random, drawn from ``seed``.

:func:`dryrun_multichip` is the twin of ``__graft_entry__.dryrun_multichip``:
every parallel mode of the port once, over ``n`` ranks.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.tools.timing import flop_count


def modules(tiny: bool = False, quantize: bool = False,
            compute_mode: str = "literal"):
    """(model, sr): the height model and the RRDBNet as constructed, on the
    default device (``torch.device("meta")`` builds them without memory).
    ``tiny=True`` is the small test configuration (RRDBNet-2 of width 16,
    ``efficientnet-test``); ``quantize`` is the RRDBNet's int8 trunk and
    ``compute_mode`` the height model's (``"packed"``: inference only)."""
    if tiny:
        return (SRRegressClsFeature("efficientnet-test", super_mid=8,
                                    isaggre=True, chans_build=7, sr_chans=16,
                                    compute_mode=compute_mode),
                RRDBNet(num_block=2, num_feat=16, num_grow_ch=8,
                        quantize=quantize))
    return (SRRegressClsFeature("efficientnet-b4", super_mid=16, isaggre=True,
                                chans_build=7, sr_chans=64,
                                compute_mode=compute_mode),
            RRDBNet(num_block=23, num_feat=64, num_grow_ch=32,
                    quantize=quantize))


def flagship(tile: int = 64, batch: int = 8, tiny: bool = False, device=None,
             seed: int = 0, quantize: bool = False,
             compute_mode: str = "literal"):
    """(model, sr, x): the height model and the RRDBNet (:func:`modules`,
    with its layout options) in eval mode on ``device`` (``None`` is the
    card), and a zero NHWC image batch (batch, tile, tile, 8). The weights
    do not depend on the options."""
    dev = resolve_device(device)
    model, sr = modules(tiny, quantize, compute_mode)
    gen = torch.Generator().manual_seed(seed)
    init_weights(sr, gen)
    init_weights(model, gen)
    x = torch.zeros((batch, tile, tile, 8), device=dev)
    return model.eval().to(dev), sr.eval().to(dev), x


def flops_per_tile(tiny: bool = False, tile: int = 64) -> dict:
    """The flagship's FLOPs for one tile (``tools.timing.flop_count`` on the
    meta device): ``trunk``, the RRDB blocks; ``sr``, the whole frozen
    feature pass; ``model``, the height model's forward; ``total``, the
    serving forward (``sr`` + ``model``). Counted once a process for each
    (``tiny``, ``tile``): building the full width on the meta device takes
    seconds."""
    return dict(_flops_per_tile(tiny, tile))


@functools.lru_cache(maxsize=None)
def _flops_per_tile(tiny: bool, tile: int) -> tuple:
    with torch.device("meta"):
        model, sr = modules(tiny)
        x = torch.empty(1, 8, tile, tile)
        fea = torch.empty(1, sr.conv_first.out_channels, 4 * tile, 4 * tile)
        lr = torch.empty(1, sr.conv_first.out_channels, tile, tile)
    counts = {"trunk": flop_count(sr.body, lr),
              "sr": flop_count(sr, x[:, :3], features_only=True),
              "model": flop_count(model.eval(), x, fea)}
    counts["total"] = counts["sr"] + counts["model"]
    return tuple(counts.items())


def forward(model, sr, image):
    """The flagship's float forward on an NHWC (B, 64, 64, 8) batch under
    ``torch.inference_mode()``, with the JAX ``entry``'s output layout:
    height (B, 256, 256), build logits (B, 256, 256, 7) and aggregated
    height (B, 64, 64)."""
    img = image.permute(0, 3, 1, 2)
    with torch.inference_mode():
        fea = sr(img[:, :3], features_only=True)
        height, build, aggre = model(img, fea)
    return height[:, 0], build.permute(0, 2, 3, 1), aggre[:, 0]


def entry(device=None, seed: int = 0):
    """(fn, (x,)): :func:`forward` bound to the full-width flagship, and an
    NHWC (8, 64, 64, 8) example batch."""
    model, sr, x = flagship(tile=64, batch=8, device=device, seed=seed)
    return functools.partial(forward, model, sr), (x,)


def dryrun_multichip(n: int, device=None) -> str:
    """One pass through every parallel mode over ``n`` ranks, at the tiny
    configuration on 32-px tiles and a global batch of ``2 n``: a DP step
    and an FSDP2 step (losses within 1e-3 of each other), the mesh city
    step feeding the sharded stitcher (overlapping windows reach weight
    2), tensor parallelism of the trunk and of the whole flagship, the
    trunk row-sharded (SP) and pipelined (PP, 2 microbatches), each within
    1e-4 of the plain forward (over a model group of 2 when ``n`` is even,
    else 1), and the data-parallel GAN step. By default the ranks are ``n``
    processes on ``n`` cards (NCCL), and fewer cards raise; ``device="cpu"``
    runs ``n`` gloo processes. Prints and returns the JAX form's summary
    line."""
    from srbh_tpu_torch.parallel.mesh import run_ranks

    if device is None:
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices and sees "
                f"{torch.cuda.device_count()}; pass device='cpu' to run {n} "
                f"gloo processes on the CPU")
        kind = "cuda"
    else:
        kind = torch.device(device).type
    line = run_ranks(_dryrun_rank, n, device=kind)[0]
    print(line)
    return line


def _close(label, got, want, tol=1e-4):
    err = (got - want).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label} diverged: {err}")


def _dryrun_rank() -> str:
    """:func:`dryrun_multichip`'s work in one rank."""
    from srbh_tpu_torch.parallel import mesh as pmesh
    from srbh_tpu_torch.parallel.collectives import world
    from srbh_tpu_torch.parallel.data import global_batchnorm
    from srbh_tpu_torch.parallel.pipeline import rrdb_pipeline_features
    from srbh_tpu_torch.parallel.spatial import (
        gather_rows,
        spatial_parallel,
        split_rows,
    )
    from srbh_tpu_torch.parallel.tensor import tensor_parallel
    from srbh_tpu_torch.predict.device_stitcher import stitch_tiles_sharded
    from srbh_tpu_torch.predict.predictor import make_city_step
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step

    n = world()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
    batch_n, tile = 2 * n, 32
    model, sr = modules(tiny=True)
    gen = torch.Generator().manual_seed(0)
    init_weights(sr, gen)
    init_weights(model, gen)
    rng = np.random.default_rng(0)
    h = rng.integers(0, 50, (batch_n, tile * 4, tile * 4)).astype(np.float32)
    batch = {
        "image": rng.uniform(0, 1, (batch_n, tile, tile, 8)).astype(np.float32),
        "height": h,
        "height_aggre": h.reshape(batch_n, tile, 4, tile, 4).mean((2, 4)),
        "build": (h > 10).astype(np.int32) * 3,
        "weight": np.ones_like(h),
        "weight_aggre": np.ones((batch_n, tile, tile), np.float32),
    }
    mesh = pmesh.make_mesh()
    data = mesh.get_group(pmesh.DATA_AXIS)
    local = pmesh.shard_batch(batch, data)

    dp = copy.deepcopy(model).to(dev)
    state = TrainState(dp, n_log_vars=3, lr=1e-3)
    metrics = make_train_step(dp, sr, device=dev, group=data)(state, local, 1e-3)
    loss = metrics["loss"].item()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    fs = global_batchnorm(copy.deepcopy(model).to(dev), data)
    pmesh.shard_state_fsdp(fs, mesh)
    state_fs = TrainState(fs, n_log_vars=3, lr=1e-3)
    loss_fs = make_train_step(fs, sr, device=dev, group=data)(
        state_fs, local, 1e-3)["loss"].item()
    if not abs(loss_fs - loss) <= 1e-3 * max(1.0, abs(loss)):
        raise AssertionError(f"FSDP loss {loss_fs} diverged from DP {loss}")

    # the mesh city step feeding the sharded stitcher
    served = copy.deepcopy(dp)
    heights, builds = make_city_step(served, sr, dtype=torch.float32,
                                     device=dev, mesh=mesh)(batch["image"])
    pos = np.zeros((batch_n, 4), np.int64)
    pos[:, 0] = np.arange(batch_n) * (tile - 8)  # overlapping windows
    pos[:, 2:] = tile
    canvas_w = (batch_n - 1) * (tile - 8) + tile
    _, _, weight = stitch_tiles_sharded(heights, builds, pos,
                                        (tile * 4, canvas_w * 4), mesh, 4)
    if int(weight.max()) < 2:
        raise AssertionError("overlaps did not accumulate")

    # tensor, spatial and pipeline parallelism over a model group
    mesh_mp = pmesh.make_mesh(n_model=2 if n % 2 == 0 else 1)
    group = mesh_mp.get_group(pmesh.MODEL_AXIS)
    x = torch.as_tensor(batch["image"], device=dev).permute(0, 3, 1, 2)
    sr.eval()
    with torch.no_grad():
        ref_fea = sr(x[:, :3], features_only=True)
        tp_sr = tensor_parallel(sr, group)
        _close("TP trunk", tp_sr(x[:, :3], features_only=True), ref_fea)
        ref_h = served(x, ref_fea)[0]
        tp_h = tensor_parallel(served, group)(
            x, tp_sr(x[:, :3], features_only=True))[0]
        _close("TP flagship", tp_h, ref_h)
        band = spatial_parallel(sr, group)(split_rows(x[:, :3], group),
                                           features_only=True)
        _close("SP trunk", gather_rows(band, group), ref_fea)
        _close("PP trunk", rrdb_pipeline_features(sr, x[:, :3], mesh_mp,
                                                  num_microbatches=2), ref_fea)

    # the data-parallel GAN step
    gan = RealESRGANTrainer(num_block=1, num_feat=8, num_grow_ch=8,
                            disc_feat=8, perceptual=False)
    gstate = gan.init(7, (batch_n, 16, 16, 3), device=dev)
    glq = np.random.default_rng(7).uniform(0, 1, (batch_n, 16, 16, 3))
    ggt = np.random.default_rng(8).uniform(0, 1, (batch_n, 64, 64, 3))
    gm = gan.make_step(group=data)(gstate, pmesh.shard_batch(glq, data),
                                   pmesh.shard_batch(ggt, data))
    if not np.isfinite(gm["l_g_total"].item()):
        raise AssertionError("GAN DP step non-finite")
    return (f"dryrun_multichip({n}): loss={loss:.4f} "
            f"rmse={metrics['rmse'].item():.3f} devices={n} "
            f"predict+stitch=ok fsdp=ok tp=ok(trunk+flagship) sp=ok pp=ok "
            f"gan_dp=ok")
