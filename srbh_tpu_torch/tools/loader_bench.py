"""Host input-pipeline throughput: tiles/s by worker count.

    python -m srbh_tpu_torch.tools.loader_bench [--tiles 256] [--epochs 2]
        [--workers 0 1 2 4 8]

Counterpart of ``srbh_tpu/tools/loader_bench.py:29-94``. It writes
synthetic tiles of the real shapes to a temporary directory (64x64 uint16
S2, float32 S1, 256x256 uint8 heights, the data list, min-max tables and a
height histogram: the JAX tool's files byte for byte, the list written with
``csv`` where the JAX tool uses pandas) and measures the port's host
pipeline, ``data/{tiff,dataset,pipeline}.py``: GeoTIFF decode, min-max
normalisation, augmentation, the hierarchy targets and aggregation, and
batch assembly by the loader's worker processes, at batch 16. For each
worker count it prints tiles/s over ``--epochs`` epochs after a warm one,
with the host's CPU count. It has no device part: the card's name in each
line says which machine's host it measured.
"""
from __future__ import annotations

import argparse
import csv
import os
import tempfile
import time

import numpy as np

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.data.tiff import write_tiff
from srbh_tpu_torch.tools import timing

GEO = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)


def build_synthetic(root: str, n: int) -> None:
    """``n`` seeded tiles under ``root`` (``s2c``, ``s1c``, ``bhc``), the
    list ``dl.csv``, the tables ``s2c_minmax.txt`` / ``s1c_minmax.txt`` and
    the histogram ``bh_stats.txt``."""
    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(n)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name in names:
        write_tiff(os.path.join(root, "s2c", name),
                   rng.integers(0, 5000, (64, 64, 6)).astype(np.uint16), GEO)
        write_tiff(os.path.join(root, "s1c", name),
                   rng.uniform(-25, 5, (64, 64, 2)).astype(np.float32), GEO)
        write_tiff(os.path.join(root, "bhc", name),
                   rng.integers(0, 100, (256, 256)).astype(np.uint8),
                   (GEO[0], 2.5, 0.0, GEO[3], 0.0, -2.5))
    with open(os.path.join(root, "dl.csv"), "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(
            (name, "s1c", "s2c", "bhc") for name in names)
    np.savetxt(os.path.join(root, "s2c_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "s1c_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(os.path.join(root, "bh_stats.txt"), hist)


def dataset(root: str, **kw) -> S12GlobeDataset:
    """The train dataset over :func:`build_synthetic`'s files (host
    augmentation unless ``kw`` says otherwise)."""
    opts = dict(normmethod="minmax", datarange=(0, 1), aug=True, s1dir="s1c",
                s2dir="s2c", heightdir="bhc",
                preweight=os.path.join(root, "bh_stats.txt"), isaggre=True,
                ishir=True, seed=0)
    opts.update(kw)
    return S12GlobeDataset(os.path.join(root, "dl.csv"), root, datastats=root,
                           **opts)


def run(tiles: int = 256, epochs: int = 2, workers=(0, 1, 2, 4, 8),
        batch: int = 16, device=None) -> list:
    """One record per worker count; ``device`` (``None`` is the card) only
    says whether to time: off a card each loader runs one epoch, unchecked
    against time, and rates are ``None``."""
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    records = []
    with tempfile.TemporaryDirectory(prefix="srbh_loaderbench_") as root:
        build_synthetic(root, tiles)
        ds = dataset(root)
        for n in workers:
            loader = DataLoader(ds, batch_size=batch, shuffle=True,
                                num_workers=n, seed=0, drop_last=True)
            seen = sum(b["image"].shape[0] for b in loader)  # the warm epoch
            if seen != (tiles // batch) * batch:
                raise AssertionError(f"{n} workers gave {seen} tiles")
            rate = None
            if timed:
                count = 0
                t0 = time.perf_counter()
                for _ in range(epochs):
                    for b in loader:
                        count += b["image"].shape[0]
                rate = count / (time.perf_counter() - t0)
            records.append({"tool": "loader_bench",
                            "metric": "loader_tiles_per_sec", "num_workers": n,
                            "batch": batch, "tiles": tiles,
                            "epochs": epochs if timed else 0,
                            "host_cpus": os.cpu_count(),
                            **timing.device_record(dev), "value": rate,
                            "unit": "tiles/s"})
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m srbh_tpu_torch.tools.loader_bench")
    ap.add_argument("--tiles", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 1, 2, 4, 8])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "loader_bench.jsonl"))
    args = ap.parse_args(argv)
    dev = timing.tool_device()
    records = run(args.tiles, args.epochs, args.workers, device=dev)
    timing.emit(records, args.out)
    return records


if __name__ == "__main__":
    main()
