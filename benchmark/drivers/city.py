"""Mapping cities: the CLI's path, ``predict/predictor.py:predict_cities``
with the arguments ``python -m srbh_tpu_torch.predict`` gives it (the
traffic's ``dtype``, ``batch``, ``stitch`` and the loader's four
processes), over synthetic cities written in set-up (``synth/city.py``).

The cities cycle through the traffic's ``sides``, one ``predict_cities``
call a city, back to back, each into a directory of its own. The rate counts
every window of every city begun in the window, over the time from the
window's start until the last of them is written. The warm-up maps the
``warmup_side`` city once, untimed. Once the window has closed and the
program is freed, one finished city drawn from the seed is read back from
its two GeoTIFFs and compared with ``reference/city.py``'s mosaic in
float32 (TF32 off); then every city's outputs are deleted.

The warm-up also runs the step once at each city's last, shorter batch.
Traffic keys: ``sides``, ``warmup_side``, ``batch``, ``dtype``,
``stitch``, ``trace_city`` (the index in the cycle of the city a traced
run profiles whole).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.drivers.serve import DTYPES, flagship_weights, port_models
from benchmark.harness import env, stats
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Stretch
from benchmark.reference import city as refcity
from benchmark.reference import flagship as ref
from benchmark.synth import city as synth
from benchmark.synth.tiff import read_tiff


@contextlib.contextmanager
def spans_installed(spans: Spans):
    """The benchmark's spans around the predictor's loader, blend, finalize
    and writers, by wrapping the names ``predictor`` looks up; restored
    after."""
    from srbh_tpu_torch.predict import predictor

    saved = {k: getattr(predictor, k) for k in (
        "DataLoader", "MosaicAccumulator", "array2raster", "array2raster_rio",
        "make_city_step")}
    base_loader, base_acc = saved["DataLoader"], saved["MosaicAccumulator"]

    class Loader(base_loader):
        def __iter__(self):
            return spans.wrap_iter("loader_wait", super().__iter__())

    class Accumulator(base_acc):
        def add_batch(self, *args):
            with spans.span("stitch"):
                return super().add_batch(*args)

        def finalize(self):
            with spans.span("finalize"):
                return super().finalize()

    def step_maker(*args, **kwargs):
        return spans.wrap("step", saved["make_city_step"](*args, **kwargs))

    predictor.DataLoader = Loader
    predictor.MosaicAccumulator = Accumulator
    predictor.array2raster = spans.wrap("write", saved["array2raster"])
    predictor.array2raster_rio = spans.wrap("write", saved["array2raster_rio"])
    predictor.make_city_step = step_maker
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(predictor, k, v)


def run(ctx) -> dict:
    from srbh_tpu_torch.predict.predictor import predict_cities

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    root = env.scratch_dir(ctx.cell["name"])
    data, stats_dir = os.path.join(root, "cities"), os.path.join(root, "stats")
    sides = sorted(set(tr["sides"]) | {tr["warmup_side"]})
    cities, n_windows = {}, {}
    for side in sides:
        cities[side] = synth.make(side, ctx.seed, dev)
        n_windows[side] = synth.write(data, stats_dir, f"c{side}",
                                      cities[side])
    model, sr = port_models(cfg, dev)
    hm_state, sr_state = flagship_weights(cfg, ctx.seed, dev)
    model.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    kw = dict(s1dir="s1x", s2dir="s2x", gridvalid="isv", nchans=6,
              chans_build=cfg["model"]["chans_build"], batch_size=tr["batch"],
              stitch=tr["stitch"], device=dev, dtype=DTYPES[tr["dtype"]],
              rgb_idx=tuple(cfg["model"]["rgb_idx"]))
    out_root = os.path.join(root, "out")

    def map_city(k, side):
        respath = os.path.join(out_root, str(k))
        os.makedirs(respath, exist_ok=True)
        return predict_cities(data, [f"c{side}"], model, sr, stats_dir,
                              respath, **kw)[0]

    map_city("warmup", tr["warmup_side"])
    # the last batch of each city is shorter: its shapes are warmed too
    from srbh_tpu_torch.predict.predictor import make_city_step
    step = make_city_step(model, sr, rgb_idx=kw["rgb_idx"], dtype=kw["dtype"],
                          device=dev)
    for tail in {n % tr["batch"] for n in n_windows.values()} - {0}:
        step(torch.zeros((tail, 64, 64, 8), device=dev))
    del step
    spans = Spans() if ctx.trace else None
    if ctx.trace:
        with Stretch():
            map_city("trace_warmup", tr["warmup_side"])
    shutil.rmtree(out_root, ignore_errors=True)
    common.reset_peak(dev)

    done, begun, traced = [], 0, None
    scope = spans_installed(spans) if spans else contextlib.nullcontext()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    with scope:
        k = 0
        while time.perf_counter() - t0 < ctx.seconds:
            side = tr["sides"][k % len(tr["sides"])]
            begun += n_windows[side]
            if ctx.trace and k == tr["trace_city"]:
                with spans.span("city"), Stretch() as traced:
                    paths = map_city(k, side)
            elif spans is not None:
                with spans.span("city"):
                    paths = map_city(k, side)
            else:
                paths = map_city(k, side)
            done.append((side, paths))
            k += 1
    common.sync(dev)
    window = time.perf_counter() - t0
    peak = common.memory_peak(dev)
    del model, sr
    common.free(dev)

    record = {}
    if ctx.trace:
        record = {"trace": traced.reduce() if traced else None,
                  "spans": dict(spans.seconds), "cities": len(done)}

    pick = common.sample_indices(ctx.seed, 3, 1, len(done))[0]
    side, (build_tif, height_tif) = done[pick]
    classes, heights = read_tiff(build_tif)[..., 0], read_tiff(height_tif)[..., 0]
    shutil.rmtree(root, ignore_errors=True)
    reads = check_city(cfg, hm_state, sr_state, cities[side], heights,
                       classes, tr["batch"], dev, DTYPES[tr["dtype"]])
    correct, checks = common.judge(reads, common.limits(ctx.root,
                                                        ctx.cell["name"]))
    notes = [f"cities {[s for s, _ in done]}, windows {begun}, "
             f"window {window:.3f} s, checked city {pick} ({side} px)",
             f"card {common.power_limit(dev)}"]
    return {"correct": correct, "attempted": begun,
            "failed": 0 if correct else n_windows[side],
            "e2e": {"setup_s": setup_s,
                    "city_windows_per_s": stats.rate(begun, window)},
            "record": record, "memory_peak_bytes": peak, "checks": checks,
            "readings": reads, "notes": notes,
            "state": (hm_state, sr_state, cities[side], heights, classes)}


def reference_mosaic(cfg, hm_state, sr_state, city, batch, dev, fp8=False,
                     dtype=torch.float32):
    hm, sr = ref.build(cfg)
    hm.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    hm, sr = hm.to(dev), sr.to(dev)
    if fp8:
        ref.set_fp8(hm)
        ref.set_fp8(sr)
    pos = synth.valid_windows(city["wsf"])[4]
    tables = ((np.zeros(6), np.full(6, synth.S2_MAX)),
              (np.full(2, synth.S1_MIN),
               np.full(2, synth.S1_MAX - synth.S1_MIN)))
    old = common.tf32(False)
    try:
        return refcity.mosaic(hm, sr, city, pos, tables, dev, batch,
                              tuple(cfg["model"]["rgb_idx"]), dtype)
    finally:
        common.restore_tf32(old)


def truth_and_yardstick(cfg, hm_state, sr_state, city, batch, dev, dtype):
    return (reference_mosaic(cfg, hm_state, sr_state, city, batch, dev),
            reference_mosaic(cfg, hm_state, sr_state, city, batch, dev,
                             dtype=dtype))


def check_city(cfg, hm_state, sr_state, city, heights, classes, batch,
               dev, dtype) -> dict:
    """The readings of one mapped city, as read back from its GeoTIFFs,
    against the reference's mosaics."""
    side = city["s2"].shape[0]
    if classes.shape != (4 * side, 4 * side) or heights.dtype != np.uint16:
        return {"height_block_ratio": float("inf"),
                "class_ratio": float("inf"), "outside": float("inf")}
    truth, yard = truth_and_yardstick(cfg, hm_state, sr_state, city, batch,
                                      dev, dtype)
    return refcity.compare(heights, classes, truth, yard)


def control(ctx, out) -> dict:
    """The control: the reference with float8 operands in the program's
    place, its mosaic read as the program's is."""
    hm_state, sr_state, city = out["state"][:3]
    batch = ctx.traffic["batch"]
    h_c, b_c, _ = reference_mosaic(ctx.config, hm_state, sr_state, city,
                                   batch, ctx.device, fp8=True)
    truth, yard = truth_and_yardstick(ctx.config, hm_state, sr_state, city,
                                      batch, ctx.device,
                                      DTYPES[ctx.traffic["dtype"]])
    return refcity.compare(h_c, np.argmax(b_c, 0).astype(np.uint8), truth,
                           yard)


def faults(ctx, out) -> dict:
    """The reading of ``one_tile``: the program's mosaic of the checked city
    with one window's heights +3 m, spread over its footprint as the blend
    spreads one window's output (+30 dm over the count of windows on each
    pixel)."""
    hm_state, sr_state, city, heights, classes = out["state"]
    pos = synth.valid_windows(city["wsf"])[4]
    truth, yard = truth_and_yardstick(ctx.config, hm_state, sr_state, city,
                                      ctx.traffic["batch"], ctx.device,
                                      DTYPES[ctx.traffic["dtype"]])
    x0, y0, xc, yc = pos[len(pos) // 2]
    r, c = slice(4 * y0, 4 * (y0 + yc)), slice(4 * x0, 4 * (x0 + xc))
    h = heights.astype(np.int64)
    h[r, c] += np.round(30.0 / truth[2][r, c]).astype(np.int64)
    return {"one_tile": refcity.compare(h.astype(np.uint16), classes, truth,
                                        yard)}
