"""Dataset statistics: per-band normalisation tables + height histograms.

The port's copy of ``srbh_tpu/data/stats.py``, without pandas (the card's
machine has none): image lists are read with the ``csv`` module and the
histogram CSV is written as pandas writes it (an index column, the header
``,height,number,rate``, floats as ``repr`` gives them), byte for byte.
Everything here runs on the host; ``python -m srbh_tpu_torch.data.stats``
does no device work and takes no device argument.

Twin of stats_dataset_globe.py:

* per-image band stats (min/max/mean/std — gdal ``ComputeStatistics`` exact
  semantics, computed with numpy on our TIFF reader),
* ``cal_mean_std`` (:24-42): variance-of-means composition across images,
* ``cal_min_max``  (:45-59): 2%/98% percentile of per-image extremes,
* ``main_stats`` / ``main_stats_merge`` (:61-130): write
  ``{subdir}_meanstd.txt`` / ``{subdir}_minmax.txt`` + raw ``.npy``,
* height histogram (256 uint8 bins) per region + merged
  (``bh_stats_{region}.txt``), feeding
  :func:`srbh_tpu_torch.ops.hierarchy.hierweight`,
* ``floor2height`` (:211-226): china floors -> metres x3 with a 2-floor min.
"""
from __future__ import annotations

import importlib.util
import math
import os
from glob import glob
from os.path import join
from typing import Optional, Sequence

import numpy as np

from srbh_tpu_torch.data.datalist import read_rows
from srbh_tpu_torch.data.tiff import TiffReader, read_tiff, write_tiff


def band_stats(path: str, nband: int) -> np.ndarray:
    """(nband, 4) [min, max, mean, std] per band of one image."""
    arr = read_tiff(path).astype(np.float64)
    out = np.zeros((nband, 4))
    for b in range(nband):
        band = arr[..., b]
        out[b] = [band.min(), band.max(), band.mean(), band.std()]
    return out


def cal_mean_std(stats_per_band: Sequence[np.ndarray]):
    """Merge per-image (mean, std) into dataset mean/std via E[x^2] - E[x]^2."""
    mean_all, std_all = [], []
    for stats_b in stats_per_band:
        imean, istd = stats_b[:, 2], stats_b[:, 3]
        ix2_all = (istd * istd + imean * imean).mean()
        imean_all = imean.mean()
        std_all.append(math.sqrt(ix2_all - imean_all * imean_all))
        mean_all.append(imean_all)
    return mean_all, std_all


def cal_min_max(stats_per_band: Sequence[np.ndarray], tmin=2, tmax=98):
    """2%/98% stretch over per-image extremes."""
    min_all = [float(np.percentile(b[:, 0], tmin)) for b in stats_per_band]
    max_all = [float(np.percentile(b[:, 1], tmax)) for b in stats_per_band]
    return min_all, max_all


def main_stats(ipath: str, subdir: str, nband: int, resroot: str = "datastats",
               imglistpath: Optional[str] = None):
    """Compute + write stats tables for one tile directory."""
    s1path = join(ipath, subdir)
    if imglistpath is None:
        imglist = sorted(glob(join(s1path, "*.tif")))
    else:
        imglist = [join(s1path, r[0]) for r in read_rows(imglistpath)]
    num = len(imglist)
    stats = [np.zeros((num, 4)) for _ in range(nband)]
    for i, p in enumerate(imglist):
        s = band_stats(p, nband)
        for b in range(nband):
            stats[b][i] = s[b]
    os.makedirs(resroot, exist_ok=True)
    np.save(join(resroot, subdir + ".npy"), stats)
    _write_tables(stats, subdir, resroot)
    return stats


def _write_tables(stats, subdir, resroot):
    mean_all, std_all = cal_mean_std(stats)
    min_all, max_all = cal_min_max(stats)
    np.savetxt(join(resroot, subdir + "_meanstd.txt"),
               np.array([mean_all, std_all]))
    np.savetxt(join(resroot, subdir + "_minmax.txt"),
               np.array([min_all, max_all]))


def main_stats_merge(s1list: Sequence[str], subdir: str, nband: int,
                     resroot: str = "datastatsglobe"):
    """Merge saved per-region .npy stats into a globe table
    (stats_dataset_globe.py:105-130)."""
    stats = [[] for _ in range(nband)]
    for name in s1list:
        data = np.load(join(resroot, name + ".npy"))
        for b, data_b in enumerate(data):
            stats[b].append(data_b)
    stats = [np.concatenate(b, axis=0) for b in stats]
    _write_tables(stats, subdir, resroot)


def _write_histogram_csv(path: str, hist: np.ndarray) -> None:
    """``pd.DataFrame({"height": arange(256), "number": hist, "rate":
    rate}).to_csv(path)``: an index column, then each float as ``repr``."""
    rate = hist / hist.sum() if hist.sum() else hist
    with open(path, "w") as f:
        f.write(",height,number,rate\n")
        for i in range(len(hist)):
            f.write(f"{i},{i},{float(hist[i])!r},{float(rate[i])!r}\n")


def _plot_histogram(hist: np.ndarray, savepath: str, savename: str) -> None:
    """Bar chart of the first 50 bins -> ``{savename}_plot.jpg``
    (stats_dataset_globe.py:166-175); skipped where matplotlib is not
    installed, as on the card's machine, which then writes no JPEG."""
    if importlib.util.find_spec("matplotlib") is None:
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rate = hist / hist.sum() if hist.sum() else hist
    fig, ax = plt.subplots()
    ax.bar(np.arange(50), rate[:50])
    ax.set_ylabel("Proportion (%)")
    ax.set_xlabel("Number of floors")
    fig.savefig(join(savepath, savename + "_plot.jpg"), dpi=300)
    plt.close(fig)


def height_histogram(height_dir: str, savepath: str, savename: str,
                     filelist: Optional[str] = None,
                     plot: bool = True) -> np.ndarray:
    """256-bin histogram of uint8 height tiles -> ``{savename}.txt`` (+csv
    and ``_plot.jpg``), the ``preweight`` input of the loaders
    (BH_loader.py:313-315)."""
    if filelist is None:
        # recursive like the reference's rglob (stats_dataset_globe.py:137):
        # height tiles are commonly organised in per-city subdirectories
        paths = sorted(glob(join(height_dir, "**", "*.tif"), recursive=True))
        if not paths:
            raise FileNotFoundError(f"no .tif tiles under {height_dir}")
    else:
        paths = [join(height_dir, r[0]) for r in read_rows(filelist)]
    hist = np.zeros((256,), np.float64)
    for p in paths:
        arr = read_tiff(p)[..., 0]
        hist += np.bincount(arr.reshape(-1).astype(np.uint8), minlength=256)
    os.makedirs(savepath, exist_ok=True)
    np.savetxt(join(savepath, savename + ".txt"), hist)
    _write_histogram_csv(join(savepath, savename + ".csv"), hist)
    if plot:
        _plot_histogram(hist, savepath, savename)
    return hist


def merge_height_histograms(bhlist: Sequence[str], savepath: str,
                            savename: str = "bh_stats_globe",
                            plot: bool = True) -> np.ndarray:
    total = np.zeros((256,), np.float64)
    for name in bhlist:
        total += np.loadtxt(join(savepath, name + ".txt"))
    np.savetxt(join(savepath, savename + ".txt"), total)
    _write_histogram_csv(join(savepath, savename + ".csv"), total)
    if plot:
        _plot_histogram(total, savepath, savename)
    return total


def floor2height(tifile: str, resdir: str = "bhchina_height"):
    """China floor-count tiles -> metres: min 2 floors, x3 m/floor
    (stats_dataset_globe.py:211-226)."""
    base = os.path.basename(tifile)
    resfile = join(resdir, base)
    if os.path.exists(resfile):
        return resfile
    r = TiffReader(tifile)
    data = r.read()[..., 0]
    data = data.copy()
    data[(data > 0) & (data < 3)] = 2
    data = data * 3
    os.makedirs(resdir, exist_ok=True)
    write_tiff(resfile, data, geotransform=r.geotransform, like=r.info())
    return resfile


def _cli(argv=None):
    """CLI twin of stats_dataset_globe.py's __main__ driver (:229-320)."""
    import argparse

    ap = argparse.ArgumentParser(prog="srbh-stats")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stats", help="per-band tables for one tile dir")
    p.add_argument("--ipath", required=True)
    p.add_argument("--subdir", required=True)
    p.add_argument("--nband", type=int, required=True)
    p.add_argument("--resroot", default="datastats")
    p.add_argument("--imglist", default=None)

    p = sub.add_parser("merge", help="merge saved region .npy into one table")
    p.add_argument("--regions", nargs="+", required=True)
    p.add_argument("--subdir", required=True)
    p.add_argument("--nband", type=int, required=True)
    p.add_argument("--resroot", default="datastatsglobe")

    p = sub.add_parser("heights", help="256-bin height histogram")
    p.add_argument("--height-dir", required=True)
    p.add_argument("--savepath", required=True)
    p.add_argument("--savename", required=True)
    p.add_argument("--filelist", default=None)

    p = sub.add_parser("merge-heights", help="sum region histograms")
    p.add_argument("--regions", nargs="+", required=True)
    p.add_argument("--savepath", required=True)
    p.add_argument("--savename", default="bh_stats_globe")

    p = sub.add_parser("floor2height", help="china floors -> metres x3")
    p.add_argument("tifs", nargs="+")
    p.add_argument("--resdir", default="bhchina_height")

    a = ap.parse_args(argv)
    if a.cmd == "stats":
        main_stats(a.ipath, a.subdir, a.nband, a.resroot, a.imglist)
    elif a.cmd == "merge":
        main_stats_merge(a.regions, a.subdir, a.nband, a.resroot)
    elif a.cmd == "heights":
        height_histogram(a.height_dir, a.savepath, a.savename, a.filelist)
    elif a.cmd == "merge-heights":
        merge_height_histograms(a.regions, a.savepath, a.savename)
    elif a.cmd == "floor2height":
        for t in a.tifs:
            floor2height(t, a.resdir)


if __name__ == "__main__":  # pragma: no cover
    _cli()
