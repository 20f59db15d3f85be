"""The city predictor on one synthetic big city, through both stitchers.

    python -m srbh_tpu_torch.tools.predict_stress [--size 2048] [--batch 32]
        [--test-scale]

Counterpart of ``srbh_tpu/tools/predict_stress.py:34-129``. It writes one
synthetic city of ``--size`` x ``--size`` 10 m pixels (S2 uint16, S1
float32, a WSF mask, the 64/56 fishnet and its validity, min-max tables:
the JAX tool's files byte for byte) and maps it with
``predict/predictor.py:predict_city`` and the full-width models in bfloat16
(RRDBNet-23 + EfficientNet-B4, seeded random weights), once with the device
stitcher and once with the host stitcher. It prints the windows, the
canvas bytes (``_canvas_bytes``: int32 sums at 4x), and for each stitcher
the wall time of ``predict_city`` (GeoTIFF writes included) and windows/s,
the peak device memory, and then whether the two outputs are byte-equal.
The device stitcher's line also holds the device busy time, idle share and
leading kernels of one more device-stitched run under the profiler (device
activity only: the host ops of a whole city take the profiler long to
sort).

``predict_city`` stitches on the host when the canvases exceed the device
budget (``SRBH_DEVICE_CANVAS_BUDGET``; half the card's memory by default).
The tool asks the same guard first and fails when the device stitcher was
asked for but would not run, so that a host time never stands under the
device stitcher's name; each line names the stitcher that ran.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from srbh_tpu_torch import entry, resolve_device
from srbh_tpu_torch.data.grid import GridImageDataset, fishgrid_stats, write_fishgrid
from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
from srbh_tpu_torch.predict.predictor import (
    _canvas_bytes,
    _device_canvas_fits,
    make_city_step,
    predict_city,
)
from srbh_tpu_torch.tools import timing

STITCHERS = ("device", "host")


def build_synth_city(root: str, size: int) -> None:
    """The city ``stress`` under ``root``: ``stress_{s2,s1,wsf}.tif``, its
    fishnet ``stress_s2_grid.*`` with validity fields, and ``stats/``."""
    rng = np.random.default_rng(0)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    write_tiff(os.path.join(root, "stress_s2.tif"),
               rng.integers(0, 5000, (size, size, 6)).astype(np.uint16), gt)
    write_tiff(os.path.join(root, "stress_s1.tif"),
               rng.uniform(-25, 5, (size, size, 2)).astype(np.float32), gt)
    write_tiff(os.path.join(root, "stress_wsf.tif"),
               (rng.random((size, size)) < 0.5).astype(np.uint8) * 255, gt)
    write_fishgrid(os.path.join(root, "stress_s2.tif"), 64, 56)
    fishgrid_stats(os.path.join(root, "stress_wsf.tif"),
                   os.path.join(root, "stress_s2_grid.shp"),
                   condition=(0, 20, 4096))
    os.makedirs(os.path.join(root, "stats"), exist_ok=True)
    np.savetxt(os.path.join(root, "stats", "s2x_minmax.txt"),
               np.stack([np.full(6, 0.0), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "stats", "s1x_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))


def run(size: int = 2048, batch: int = 32, seed: int = 0, tiny: bool = False,
        device=None) -> list:
    """The city record, one per stitcher, and the equality record, on
    ``device`` (``None`` is the card); off a card times are ``None``."""
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    model, sr, _ = entry.flagship(batch=batch, tiny=tiny, device=dev, seed=seed)
    step = make_city_step(model, sr, dtype=torch.bfloat16, device=dev)
    records = []
    with tempfile.TemporaryDirectory(prefix="srbh_stress_") as root:
        build_synth_city(root, size)
        ds = GridImageDataset(root, "stress", os.path.join(root, "stats"),
                              s1dir="s1x", s2dir="s2x", gridvalid="isv",
                              nchans=6)
        canvas = _canvas_bytes(ds.width, ds.height, 7, 4)
        records.append({"tool": "predict_stress", "metric": "stress_city",
                        **timing.device_record(dev), "size": size,
                        "batch": batch, "dtype": "bfloat16",
                        "windows": len(ds), "canvas_px": ds.width * 4,
                        "canvas_bytes": canvas})
        if not _device_canvas_fits(ds.width, ds.height, 7, 4, dev):
            raise RuntimeError(f"the device stitcher would not run: canvases of "
                               f"{canvas} bytes exceed the device budget "
                               "(SRBH_DEVICE_CANVAS_BUDGET)")
        outs = {}
        for stitch in STITCHERS:
            respath = os.path.join(root, f"pred_{stitch}")
            timing.reset_peak(dev)
            if timed:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            paths = predict_city(ds, step, respath, "stress", batch_size=batch,
                                 stitch=stitch, device=dev)
            if timed:
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0 if timed else None
            records.append({
                "tool": "predict_stress", "metric": "stress_predict_wallclock",
                "stitcher": stitch, **timing.device_record(dev),
                "repeats": int(timed), "median_ms": None if wall is None else 1e3 * wall,
                "q1_ms": None, "q3_ms": None, "value": wall, "unit": "s",
                "windows_per_sec": None if wall is None else len(ds) / wall,
                "peak_gib": timing.peak_gib(dev), "idle_share": None,
                "busy_ms": None, "kernels": None})
            outs[stitch] = [TiffReader(p).read() for p in paths]
        if timed:  # the device stitcher once more, under the profiler
            prof = timing.profile_window(
                lambda: predict_city(ds, step, os.path.join(root, "pred_prof"),
                                     "stress", batch_size=batch,
                                     stitch="device", device=dev),
                host_ops=False)
            records[1].update(idle_share=prof["idle_share"],
                              busy_ms=prof["busy_ms"], kernels=prof["kernels"])
        equal = {name: bool(np.array_equal(a, b)) for name, a, b in zip(
            ("build_equal", "height_equal"), outs["device"], outs["host"])}
        records.append({"tool": "predict_stress", "metric": "stress_equivalence",
                        **timing.device_record(dev), **equal})
        if not all(equal.values()):
            raise AssertionError(f"device and host stitcher outputs differ: {equal}")
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.predict_stress")
    ap.add_argument("--size", type=int, default=2048,
                    help="city side in 10 m pixels (the canvases are 4x)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--test-scale", action="store_true",
                    help="tiny models (a plumbing check)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "predict_stress.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = run(args.size, args.batch, args.seed, tiny=args.test_scale,
                  device=dev)
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
