"""The test-set result files, in the reference's schemas.

Counterpart of ``srbh_tpu/metrics/writers.py`` (metrics.py:344-463):
``acc{N}{suffix}_{num}.txt`` (the RMSE), ``*_seg.csv`` and ``*_he.csv``, and
the classification txt. The JAX package writes the CSVs with pandas'
``DataFrame.to_csv``; the card's machine has no pandas, so these write the
same bytes with the ``csv`` module: no index column, ``\\n`` line ends,
NaN as an empty field, and each float64 as its shortest round-trip repr
(``3.0``, ``1e-05``), as pandas writes a float64 column.
"""
from __future__ import annotations

import csv

import numpy as np


def acc2file_rmse(meter, txtpath: str):
    """The RMSE alone (metrics.py:440-443)."""
    with open(txtpath, "w") as f:
        f.write(str(meter.avg))


def acc2file_cls(metric, txtpath: str):
    """Classification txt (metrics.py:344-380): oa, the f1 / ua / pa rows,
    the transposed confusion matrix, then oa, f1[1], ua[1], pa[1], each
    with ``str()``."""
    oa = metric.overall_accuracy()
    f1, ua, pa = metric.f1(), metric.precision(), metric.recall()
    with open(txtpath, "w") as f:
        f.write("oa, miou, iou, f1, ua, pa, confusion_matrix\n")
        f.write(str(oa) + "\n\n")
        for row in (f1, ua, pa, *metric.confusion_matrix().T):
            f.write(" ".join(str(v) for v in row) + " \n")
        for v in (oa, f1[1], ua[1], pa[1]):
            f.write(str(v) + "\n")


def _field(v) -> str:
    if isinstance(v, str):
        return v
    v = float(v)
    return "" if np.isnan(v) else repr(v)


def _write_csv(path: str, rows, header=None):
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        if header is not None:
            out.writerow(header)
        out.writerows([_field(v) for v in row] for row in rows)


def acc2file_seg(metric, txtpath: str):
    """Segmentation CSV (metrics.py:383-437), written to
    ``<txtpath[:-4]>.csv`` without a header: rows [oa, miou, mfiou] / fiou /
    iou / f1 / ua / pa / the C rows of the transposed confusion matrix, each
    ending in its name."""
    cm = metric.confusion_matrix().T  # row = prediction (metrics.py:390)
    r, c = cm.shape
    data = np.zeros((6 + r, c), np.float64)
    data[0, :3] = [metric.overall_accuracy(), metric.miou(), metric.mfwiou()]
    data[1] = metric.fwiou()
    data[2] = metric.iou()
    data[3] = metric.f1()
    data[4] = metric.precision()
    data[5] = metric.recall()
    data[6:] = cm
    names = ["oa_miou_mfiou", "fiou", "iou", "f1", "ua", "pa"] + r * ["cm"]
    _write_csv(txtpath[:-4] + ".csv",
               [[*row, name] for row, name in zip(data, names)])


def acc2file_height(metric, txtpath: str):
    """Per-class height CSV (metrics.py:446-463), written to
    ``<txtpath[:-4]>.csv``: a class row each, then the balanced and the
    overall row, columns rmse, mae, me, count."""
    each = np.concatenate([metric.avg_each(), metric.count()], axis=1)
    balance = np.zeros((1, 4))
    balance[0, :3] = metric.avg_balance()
    allrow = np.zeros((1, 4))
    allrow[0, :3] = metric.avg_all()
    _write_csv(txtpath[:-4] + ".csv", np.concatenate([each, balance, allrow]),
               header=["rmse", "mae", "me", "count"])
