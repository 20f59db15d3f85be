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

On a card the step replays its two module forwards (the RRDB trunk's
features, the height model) from CUDA graphs captured for the batch's
shape: a shape's first call runs eagerly, its next call in a row captures,
later calls replay. A shape not seen twice running, such as a city's short
last batch, runs eagerly, as does every forward off a card, over a mesh or
under grad. The step's outputs are fresh tensors on every call.

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
stream too, each over a ``predict.capture`` where the call captures its
graph or a ``predict.replay`` where it replays one) and
``predict.copy_out`` (host stitching), then
``predict.finalize`` and one ``predict.write`` a GeoTIFF. A step called
alone is a root ``predict.step``.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import pathlib
import types
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


# the graphs of the step that is running, which the forward that
# make_city_step installs on its two modules reads; None outside a step
_RUNNING = contextvars.ContextVar("srbh_tpu_torch.city_step", default=None)


def _step_forward(self, *args, **kwargs):
    """A module's forward while :func:`make_city_step` has it: inside a step
    its graphs decide (:class:`_StepGraphs`), anywhere else the class's
    forward runs."""
    graphs = _RUNNING.get()
    if graphs is None:
        return type(self).forward(self, *args, **kwargs)
    return graphs.forward(self, args, kwargs)


@contextlib.contextmanager
def _running(graphs):
    token = _RUNNING.set(graphs)
    with contextlib.ExitStack() as undo:
        undo.callback(_RUNNING.reset, token)
        yield


class _StepGraphs:
    """The CUDA graphs of one step's module forwards, and the step's counts
    of ``captures``, ``replays`` and ``eager`` forwards.

    A forward is keyed by its module, each argument (a tensor's shape,
    dtype, strides, which give its memory format, and device; any other
    value as it is) and the compute type (autocast's state). It runs
    eagerly where a graph could not replay it: a step off a card or over a
    mesh (``capture`` false), grad enabled, a tensor off the card, or a
    forward hook on a module inside it (hooks on the module itself wrap
    the replay). Otherwise the first call with a key runs eagerly, the
    warm-up that a capture needs; when the module's next call has the same
    key, that call captures its forward into a graph and replays it, and
    later calls with the key replay it. A key that is not seen twice
    running (the city's short last batch) stays eager, and holds no graph
    memory.

    A replay copies the tensors it is given into the graph's inputs but a
    static output of the step's other graph, which it reads where it lies:
    the height model's graph is captured on the trunk's features, in the
    trunk graph's memory pool. It returns the graph's static outputs, which
    the next replay overwrites; the step returns only tensors that its
    post-processing makes afresh."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.graphs = {}  # key -> _Graph
        self.last = {}  # id(module) -> key of its last eager forward
        self.inner = {}  # id(module) -> its modules but itself
        self.captures = self.replays = self.eager = 0

    def forward(self, module, args, kwargs):
        names = sorted(kwargs)
        values = [*args, *(kwargs[k] for k in names)]
        key = self._key(module, values, names)
        graph = self.graphs.get(key)
        if graph is not None:
            self.replays += 1
            with profiler.span("predict.replay"):
                return graph.replay(values)
        if key is None or self.last.get(id(module)) != key:
            self.last[id(module)] = key
            self.eager += 1
            return type(module).forward(module, *args, **kwargs)
        owners = {t.data_ptr(): g for g in self.graphs.values()
                  for t in g.outputs}
        with profiler.span("predict.capture"):
            graph = self.graphs[key] = _Graph(module, values, len(args),
                                              names, owners)
        self.captures += 1
        return graph.replay(values)

    def _key(self, module, values, names):
        """The forward's key, or ``None`` where it runs eagerly."""
        if (not self.capture or torch.is_grad_enabled() or self._hooked(module)
                or any(isinstance(v, torch.Tensor) and v.device.type != "cuda"
                       for v in values)):
            return None
        return (id(module), tuple(names), torch.is_autocast_enabled("cuda"),
                torch.get_autocast_dtype("cuda"), *(
                    (tuple(v.shape), v.dtype, v.stride(), v.device)
                    if isinstance(v, torch.Tensor) else v for v in values))

    def _hooked(self, module) -> bool:
        inner = self.inner.get(id(module))
        if inner is None:
            inner = self.inner[id(module)] = list(module.modules())[1:]
        return any(m._forward_hooks or m._forward_pre_hooks for m in inner)


class _Graph:
    """One module forward captured into a CUDA graph: its inputs, the graph
    and its static outputs. ``owners`` maps the address of each static
    output of the step's graphs to its graph: an argument that lies there is
    read in place, in that graph's memory pool."""

    def __init__(self, module, values, n_args, names, owners):
        shared = [owners.get(v.data_ptr()) if isinstance(v, torch.Tensor)
                  else None for v in values]
        pool = next((g.pool for g in shared if g is not None), None)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.inputs = [_static_copy(v) if isinstance(v, torch.Tensor)
                       and g is None else v for v, g in zip(values, shared)]
        kwargs = dict(zip(names, self.inputs[n_args:]))
        self.graph = torch.cuda.CUDAGraph()
        # captured on a side stream that follows the current one, as
        # ``torch.cuda.graph`` does, without its garbage collection and its
        # emptying of the device's and the pinned host memory's caches; the
        # loader's threads may use the card meanwhile ("thread_local")
        dev = next(v.device for v in values if isinstance(v, torch.Tensor))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side), \
                contextlib.ExitStack() as capture:
            self.graph.capture_begin(self.pool,
                                     capture_error_mode="thread_local")
            capture.callback(self.graph.capture_end)
            self.out = type(module).forward(module, *self.inputs[:n_args],
                                            **kwargs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = [t for t in (self.out if isinstance(self.out, tuple)
                                    else (self.out,))
                        if isinstance(t, torch.Tensor)]

    def replay(self, values):
        for static, v in zip(self.inputs, values):
            if isinstance(v, torch.Tensor) and v.data_ptr() != static.data_ptr():
                static.copy_(v)
        with profiler.graph_launch("predict.graph_replay"):
            self.graph.replay()
        return self.out


def _static_copy(t):
    """A copy of ``t`` with its strides (and so its memory format)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


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

    On a card the step replays each of its two module forwards, the trunk's
    features and the height model, from a CUDA graph, so that the host
    enqueues two graph launches and the few small operations around them
    instead of some 3900 kernels. The step sets each module's ``forward``
    to one that, inside this step's calls only, captures and replays the
    module's forward (:class:`_StepGraphs`), and anywhere else runs the
    class's forward: hooks on the two modules fire around every replay, and
    every other caller of them runs eagerly. A batch shape's first call
    runs eagerly, its next call in a row captures, later ones replay; a
    shape not seen twice running (a city's short last batch, which is not
    padded: bf16 outputs depend on the batch size) runs eagerly. Off a
    card, with ``mesh`` or under grad every forward runs eagerly. A replay
    launches the kernels the eager forward launches, autocast's weight
    casts included, and gives the same bits; the step's outputs are fresh
    tensors that a later call leaves alone. ``step.graphs`` holds the
    graphs and the counts of ``captures``, ``replays`` and ``eager``
    forwards.

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
    for m in (model, sr_model):
        m.forward = types.MethodType(_step_forward, m)
    graphs = _StepGraphs(capture=dev.type == "cuda" and mesh is None)
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
            with torch.inference_mode(), _running(graphs):
                h, b = _serve(model, features, x, rgb_idx, dtype)[2:]
            if mesh is None:
                return h, b
            return pmesh.gather_batch(h, data), pmesh.gather_batch(b, data)

    step.graphs = graphs
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
