"""Datalist generation and train/val/test splitting, without pandas.

The port's copy of ``srbh_tpu/data/datalist.py`` (twin of BH_dataset.py):
builds ``datalist_{region}.csv`` from tile dirs, shuffle-splits train 0.7 /
(val 0.33 of the rest / test), and merges china/eu/usa into ``globe`` lists
with per-row s1/s2/bh dir columns.

The JAX package reads and writes these CSVs with pandas; the card's machine
has no pandas, so this module uses the ``csv`` module and writes the same
bytes (no header, no index, minimal quoting, ``\\n`` line ends):

* ``df.sample(frac=1, random_state=1)`` is ``RandomState(1).permutation(n)``
  and ``df.sample(n=k, random_state=1)`` its first ``k`` entries (pandas
  draws ``RandomState(1).choice(n, k, replace=False)``, which is that
  prefix; ``tests/test_torch_datalist_stats.py`` holds both to pandas).
* Fields are kept as text: pandas would rewrite a field that reads as a
  number (``007`` as ``7``), which tile names and dir names never are.
* Rows shorter than the file's widest are padded with empty fields, as
  pandas pads them with NaN and writes NaN as an empty field.

Ordering note: tile names are SORTED before the seeded shuffle (the
reference's raw ``Path.rglob`` order is filesystem-dependent).
"""
from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def read_rows(path: str) -> List[List[str]]:
    """The rows of a header-less CSV, blank lines skipped, each padded to
    the widest row with empty fields."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    width = max((len(r) for r in rows), default=0)
    return [r + [""] * (width - len(r)) for r in rows]


def write_rows(path: str, rows: Sequence[Sequence[str]]) -> None:
    """Header-less CSV, byte-equal to pandas' ``to_csv(header=False,
    index=False)`` of the same text fields."""
    width = max((len(r) for r in rows), default=0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        for r in rows:
            w.writerow(list(r) + [""] * (width - len(r)))


def split_data(datalist_path: str, split_rate: float = 0.9, id: str = "2",
               n1: str = "train", n2: str = "test"):
    """Shuffle-split a CSV into two (BH_dataset.py:35-52); idempotent."""
    data_dir = os.path.dirname(datalist_path)
    base = os.path.basename(datalist_path)[:-4]
    train_path = os.path.join(data_dir, f"{base}_{n1}{id}.csv")
    test_path = os.path.join(data_dir, f"{base}_{n2}{id}.csv")
    if os.path.exists(train_path) and os.path.exists(test_path):
        return train_path, test_path
    rows = read_rows(datalist_path)
    rows = [rows[i] for i in np.random.RandomState(1).permutation(len(rows))]
    num_train = int(len(rows) * split_rate)
    write_rows(train_path, rows[:num_train])
    write_rows(test_path, rows[num_train:])
    return train_path, test_path


def generate_allfile(ipath: str, subdir, invalid: Optional[str] = None,
                     suffix: str = "", numsample: int = 0):
    """Scan tile dirs -> datalist CSV -> 0.7 train / 0.3*(0.33 val, 0.67 test)
    splits (BH_dataset.py:55-96)."""
    if not isinstance(subdir, (list, tuple)):
        subdir = [subdir]
    names = []
    for sd in subdir:
        for f in Path(os.path.join(ipath, sd)).rglob("*.tif"):
            iname = f.stem + ".tif"
            if invalid is None or invalid not in iname:
                names.append(iname)
    names = sorted(names)
    if numsample:
        if numsample > len(names):
            raise ValueError(f"cannot sample {numsample} of {len(names)} "
                             "tiles without replacement")
        order = np.random.RandomState(1).permutation(len(names))[:numsample]
        names = [names[i] for i in order]
    respath = os.path.join(ipath, f"datalist_{suffix}.csv")
    if not os.path.exists(respath):
        write_rows(respath, [[n] for n in names])
    split_data(respath, split_rate=0.7, id="_0.7", n1="train", n2="test")
    split_data(os.path.join(ipath, f"datalist_{suffix}_test_0.7.csv"),
               split_rate=0.33, id="_0.3", n1="val", n2="test")
    return respath


def addabspath(ipath: str, city: str, flist=None, listdir: str = "datalistcopy"):
    """Append per-region s1/s2/bh/... dir columns to each csv
    (BH_dataset.py:168-188)."""
    if flist is None:
        flist = sorted(Path(os.path.join(ipath, listdir)).glob(f"*{city}*.csv"))
    subdir = {"s1": f"s1{city}_check", "s2": f"s2{city}_check",
              "bh": f"bh{city}", "ge": f"ge{city}_check",
              "dem": f"dem{city}", "dsm": f"dsm{city}"}
    for file in flist:
        rows = read_rows(str(file))
        if rows and len(rows[0]) >= 1 + len(subdir):
            continue  # already augmented: re-running the recipe is a no-op
        write_rows(os.path.join(ipath, Path(file).name),
                   [r + list(subdir.values()) for r in rows])


def concat_allfile(ipath: str, flist: Sequence[str] = ("china", "eu", "usa"),
                   suffix: str = "globe", mergetype: str = ""):
    """Concatenate per-region CSVs into a globe list (BH_dataset.py:141-165)."""
    rows = []
    for c in flist:
        rows += read_rows(os.path.join(ipath, f"datalist_{c}{mergetype}.csv"))
    respath = os.path.join(ipath, f"datalist_{suffix}{mergetype}.csv")
    if not os.path.exists(respath):
        write_rows(respath, rows)
    return respath


MERGE_TYPES = ("", "_test_0.7", "_train_0.7", "_test_0.7_test_0.3",
               "_test_0.7_val_0.3")


def build_globe_lists(ipath: str, regions=("china", "eu", "usa"),
                      china_cap: int = 15000):
    """The reference's full __main__ recipe (BH_dataset.py:191-223)."""
    generate_allfile(ipath, "s1usa_check", invalid=None, suffix="usa")
    generate_allfile(ipath, "s1china_check", invalid="shenzhen",
                     suffix="china", numsample=china_cap)
    generate_allfile(ipath, "s1eu_check", invalid=None, suffix="eu")
    for c in regions:
        flist = [Path(ipath) / f"datalist_{c}{m}.csv" for m in MERGE_TYPES]
        addabspath(ipath, c, flist=[f for f in flist if f.exists()])
    for m in MERGE_TYPES:
        concat_allfile(ipath, regions, "globe", m)
