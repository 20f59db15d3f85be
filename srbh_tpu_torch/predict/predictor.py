"""City-scale sliding-window height/build prediction.

Counterpart of ``srbh_tpu/predict/predictor.py``, twin of
predict_realesanet_feature_globe.py:68-233: for each city, iterate the
WSF-valid fishnet grids, run the frozen-SR + height model on batches of
64x64 windows on the card, blend the overlaps, and write
``{city}_build.tif`` (uint8, colormap, 2.5 m) and ``{city}_height.tif``
(uint16 decimetres, DEFLATE).

The per-batch step (``make_city_step``) runs on the device; the loader's
worker processes read the windows; the mosaic is stitched on the host
(``stitch="host"``, the default) or on the device (``stitch="device"``,
when its canvases fit the budget). The last batch of a city is run as it
is, shorter than the others (the JAX package pads it to one shape for
``jit``). A city is skipped when both of its tifs exist.

``make_city_step(mesh=...)`` is the step's mesh form over a process group
(``parallel.mesh.make_mesh``): ``partition="data"`` splits the batch over
the data ranks, ``"spatial"`` also splits the RRDB trunk's rows over the
model ranks (``parallel/spatial.py``; the height model then runs on the
gathered features); either returns the whole batch's outputs on every
rank. ``predict/device_stitcher.py:stitch_tiles_sharded`` is its
stitcher.

Spans (``utils/profiler.py``): ``predict.city`` around each city mapped,
over the loader's ``loader.start``, each batch's ``predict.step`` (with
``predict.sr_features`` and ``predict.height_model``, timed on the card's
stream too) and ``predict.copy_out`` (host stitching), then
``predict.finalize`` and one ``predict.write`` a GeoTIFF. A step called
alone is a root ``predict.step``.
"""
from __future__ import annotations

import os
import pathlib
from functools import partial
from typing import Optional, Sequence

import torch

from srbh_tpu_torch import compute_type, resolve_device
from srbh_tpu_torch.data.grid import GridImageDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.parallel import mesh as pmesh
from srbh_tpu_torch.parallel.collectives import world
from srbh_tpu_torch.parallel.spatial import (
    gather_rows,
    spatial_parallel,
    split_rows,
)
from srbh_tpu_torch.predict.device_stitcher import DeviceMosaicAccumulator
from srbh_tpu_torch.predict.stitcher import MosaicAccumulator
from srbh_tpu_torch.predict.writers import array2raster, array2raster_rio
from srbh_tpu_torch.utils import profiler

# the device-canvas budget off the card (CPU tensors): the JAX package's
CPU_CANVAS_BUDGET = 6 * 2**30


def serving_outputs(model, sr_model, x, rgb_idx=(0, 1, 2),
                    dtype=torch.bfloat16):
    """The flagship's serving forward on a float batch ``x`` (B, 8, 64, 64),
    whose memory format the activations keep: the frozen SR features, the
    height model, then the predictor's post-processing
    (predict/predictor.py:50-56). Returns float heights
    ``clamp(h, 0)`` (B, 256, 256) and build softmax (B, 256, 256, C), and
    their quantised forms: uint16 decimetres ``round(h * 10)`` and uint8
    ``round(softmax * 255)``. ``torch.round`` rounds half to even, like
    ``jnp.round``; the float -> uint16 cast is direct (torch supports it on
    CUDA and on the CPU). For a ``dtype`` other than float32 both models run
    under ``torch.autocast`` on ``x``'s device (weights stay float32, as the
    JAX package's ``dtype`` keeps its params float32); the post-processing
    is float32."""
    return _serve(model, partial(sr_model, features_only=True), x, rgb_idx,
                  dtype)


def _serve(model, features, x, rgb_idx, dtype):
    """:func:`serving_outputs` with ``features`` (RGB batch -> SR features)
    in place of the trunk: the one composition of the serving step."""
    with compute_type(x.device, dtype):
        rgb = _rgb_channels(x, rgb_idx)
        with profiler.span("predict.sr_features", device=True):
            fea = features(rgb)
        with profiler.span("predict.height_model", device=True):
            outs = model(x, fea)
    return postprocess(outs[0], outs[1])


def _rgb_channels(x, rgb_idx):
    """``x[:, rgb_idx]`` in ``x``'s memory format (indexing would return a
    contiguous tensor): ``torch.cat`` of channel slices keeps the layout that
    the slices' strides share."""
    return torch.cat([x[:, i:i + 1] for i in rgb_idx], 1)


def postprocess(height, build):
    """The model's NCHW height (B, 1, H, W) and build logits (B, C, H, W) ->
    the four outputs of :func:`serving_outputs`, in float32."""
    height = height[:, 0].float().clamp(min=0)
    build = torch.softmax(build.float(), dim=1)
    h = torch.round(height * 10).to(torch.uint16)
    b = torch.round(build * 255).to(torch.uint8)
    return (height, build.permute(0, 2, 3, 1), h,
            b.permute(0, 2, 3, 1).contiguous())


def make_city_step(model, sr_model, rgb_idx=(0, 1, 2), dtype=torch.bfloat16,
                   device=None, mesh=None, partition: str = "data"):
    """Batch step: NHWC image (B, 64, 64, 8) -> (uint16 height in decimetres
    (B, 256, 256), uint8 build softmax x 255 (B, 256, 256, C)), the
    quantised outputs of :func:`serving_outputs` in compute type ``dtype``.
    Both models move to ``device`` (``None`` is the card) in eval mode, and
    the step runs under ``torch.inference_mode()``. Outputs stay on the
    device.

    The step runs channels-last: both models' conv weights are converted to
    ``torch.channels_last`` here, in place, and the NHWC image's NCHW view
    is channels-last, so every activation from the first conv to the heads
    keeps that layout and cuDNN's NHWC kernels get their operands without a
    transform a call. The conversion is in place, not on a copy, because
    callers act on the modules they passed: the benchmark's forward timers
    hook them, and ``srbh_tpu_torch.bench`` calls :func:`serving_outputs`
    on them after building the step; a copy would also hold the weights
    twice. A second step built on converted modules gives the same maps.

    With ``mesh`` every rank passes the same whole batch and gets the whole
    batch's outputs: ``partition="data"`` runs each data rank's
    ``shard_batch`` rows; ``"spatial"`` also runs the RRDB trunk on bands of
    the rows over the model ranks, for fewer, larger windows whose trunk
    activations outgrow one card. The batch must divide over the data
    ranks, and the rows over the model ranks, or the step raises."""
    dev = resolve_device(device)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    sr_model = sr_model.eval().to(dev, memory_format=torch.channels_last)
    if partition not in ("data", "spatial"):
        raise ValueError(f"partition {partition!r}: 'data' or 'spatial'")
    features = partial(sr_model, features_only=True)
    if mesh is not None:
        data = mesh.get_group(pmesh.DATA_AXIS)
        rows = mesh.get_group(pmesh.MODEL_AXIS)
        if partition == "spatial":
            banded = spatial_parallel(sr_model, rows)

            def features(rgb):
                band = banded(split_rows(rgb, rows), features_only=True)
                return gather_rows(band, rows)

    def step(image):
        with profiler.span("predict.step"):
            x = torch.as_tensor(image, device=dev).permute(0, 3, 1, 2).float()
            if mesh is not None:
                if partition == "spatial" and x.shape[2] % world(rows):
                    raise ValueError(f"{x.shape[2]} rows do not divide over "
                                     f"{world(rows)} model ranks")
                x = pmesh.shard_batch(x, data)
            with torch.inference_mode():
                h, b = _serve(model, features, x, rgb_idx, dtype)[2:]
            if mesh is None:
                return h, b
            return pmesh.gather_batch(h, data), pmesh.gather_batch(b, data)

    return step


def _canvas_bytes(width: int, height: int, n_classes: int,
                  upscale: int) -> int:
    """int32 height-sum + build-sum + weight canvases at x``upscale``."""
    hw = width * upscale * height * upscale
    return hw * 4 * (2 + n_classes)


def _device_canvas_fits(width: int, height: int, n_classes: int,
                        upscale: int, device=None) -> bool:
    """Memory guard of ``stitch="device"``: twice the canvases (room for
    one transient copy) must fit the budget. ``SRBH_DEVICE_CANVAS_BUDGET``
    (bytes) wins when set; otherwise half the card's memory, and on the CPU
    :data:`CPU_CANVAS_BUDGET`."""
    dev = resolve_device(device)
    if "SRBH_DEVICE_CANVAS_BUDGET" in os.environ:
        budget = float(os.environ["SRBH_DEVICE_CANVAS_BUDGET"])
    elif dev.type == "cuda":
        budget = torch.cuda.get_device_properties(dev).total_memory / 2
    else:
        budget = CPU_CANVAS_BUDGET
    return 2.0 * _canvas_bytes(width, height, n_classes, upscale) <= budget


def _outputs(respath: str, cityname: str):
    return (os.path.join(respath, f"{cityname}_build.tif"),
            os.path.join(respath, f"{cityname}_height.tif"))


def predict_city(
    dataset: GridImageDataset,
    step,
    respath: str,
    cityname: str,
    chans_build: int = 7,
    batch_size: int = 32,
    upscale: int = 4,
    stitch: str = "host",
    device=None,
):
    """Predict one city mosaic with ``step`` (a :func:`make_city_step` on
    ``device``; ``None`` is the card) and write its build and height
    GeoTIFFs; returns their paths.

    ``stitch="device"`` keeps the canvases on the device and adds the
    model's tiles there, with no per-batch copy to the host; when the
    canvases exceed the budget (:func:`_device_canvas_fits`) it prints so
    and stitches on the host. Four loader processes read the windows.
    """
    dev = resolve_device(device)
    build_tif, height_tif = _outputs(respath, cityname)
    # resume: skip only when BOTH artifacts exist (build is written first,
    # so a crash between the two writes must re-run the city — the
    # reference keys on build alone and can lose the height tif forever,
    # predict_…globe.py:129-131)
    if os.path.exists(build_tif) and os.path.exists(height_tif):
        return build_tif, height_tif

    if stitch == "device" and not _device_canvas_fits(
            dataset.width, dataset.height, chans_build, upscale, dev):
        print(f"predict_city[{cityname}]: device canvases "
              f"({_canvas_bytes(dataset.width, dataset.height, chans_build, upscale) / 2**30:.1f} GiB) "
              "exceed the device memory budget; falling back to the host "
              "stitcher")
        stitch = "host"
    if stitch == "device":
        acc = DeviceMosaicAccumulator(dataset.width, dataset.height,
                                      chans_build, upscale, device=dev)
    else:
        acc = MosaicAccumulator(dataset.width, dataset.height, chans_build,
                                upscale)
    # worker processes read the windows while the device computes, and two
    # batches are copied to the card ahead of the step; the windows'
    # positions stay on the host, where both stitchers read them
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        num_workers=4, device_put=True, device=dev,
                        host_keys=("pos",), prefetch=2)
    for batch in loader:
        h, b = step(batch["image"])
        if stitch == "device":
            acc.add_batch(h, b, batch["pos"])
        else:
            with profiler.span("predict.copy_out"):
                h, b = h.cpu().numpy(), b.cpu().numpy()
            acc.add_batch(h, b, batch["pos"].numpy())

    with profiler.span("predict.finalize"):
        height, build_cls, _ = acc.finalize()
    nres = dataset.geotrans[1] / upscale
    os.makedirs(respath, exist_ok=True)
    # atomic artifact commits: the resume check above keys on existence, so
    # a kill mid-write must never leave a truncated raster at the final
    # path (it would be skipped — i.e. shipped — on every later resume)
    with profiler.span("predict.write"):
        array2raster_rio(build_tif + ".tmp", build_cls, dataset.s2path,
                         nresolution=nres, iscmap=True)
    with profiler.span("predict.write"):
        array2raster(height_tif + ".tmp", height, dataset.s2path,
                     nresolution=nres, compress="DEFLATE")
    os.replace(build_tif + ".tmp", build_tif)
    os.replace(height_tif + ".tmp", height_tif)
    return build_tif, height_tif


def predict_cities(
    wholeimgpath: str,
    citynames: Sequence[str],
    model, sr_model,
    datastats: str,
    respath: str,
    s1dir: str = "s1globe_check", s2dir: str = "s2globe_check",
    gridvalid: Optional[str] = "isv",
    nchans: int = 6, chans_build: int = 7, batch_size: int = 32,
    stitch: str = "host",
    device=None,
    **step_kwargs,
):
    """The per-region loop (predict_…globe.py:122-133,221-233) on
    ``device`` (``None`` is the card). ``step_kwargs`` go to
    :func:`make_city_step` (``dtype`` for a float32 sweep)."""
    dev = resolve_device(device)
    step = make_city_step(model, sr_model, device=dev, **step_kwargs)
    results = []
    for cityname in citynames:
        # resume check BEFORE touching the city's inputs: completed cities
        # must skip even if their rasters/grids were archived since
        # (the reference checks first too, predict_…globe.py:129-131)
        build_tif, height_tif = _outputs(respath, cityname)
        if os.path.exists(build_tif) and os.path.exists(height_tif):
            results.append((build_tif, height_tif))
            continue
        with profiler.span("predict.city"):
            ds = GridImageDataset(wholeimgpath, cityname, datastats,
                                  s1dir=s1dir, s2dir=s2dir,
                                  gridvalid=gridvalid, nchans=nchans)
            results.append(predict_city(ds, step, respath, cityname,
                                        chans_build, batch_size,
                                        stitch=stitch, device=dev))
    return results


def city_names_from_dir(wholeimgpath: str) -> list:
    """getcitynamelist (predict_…globe.py:213-218): *_s2.tif stems."""
    return [p.stem[:-3] for p in sorted(
        pathlib.Path(wholeimgpath).glob("*_s2.tif"))]
