"""The port's datalists and dataset statistics (no pandas) against the JAX
package's (pandas), byte for byte.

* pandas' ``sample(frac=1, random_state=1)`` is
  ``RandomState(1).permutation(n)`` and ``sample(n=k, random_state=1)`` its
  first ``k`` entries: the rule the port's splits rest on.
* ``generate_allfile``, ``split_data``, ``addabspath``, ``concat_allfile``
  and ``build_globe_lists`` write the JAX package's CSVs (a tile name with a
  comma in it included, so the quoting is held too).
* ``main_stats`` / ``main_stats_merge`` write the same ``.npy`` and tables,
  which ``ops.normalize.load_stats_table`` reads back; ``height_histogram``
  / ``merge_height_histograms`` the same ``.txt`` and pandas-formatted
  ``.csv``; ``floor2height`` the same GeoTIFF; each ``_cli`` subcommand the
  same files as the JAX one. Without matplotlib no JPEG is written.
"""
import filecmp
import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from srbh_tpu.data import datalist as jdl
from srbh_tpu.data import stats as jstats
from srbh_tpu.data import tiff as jtiff
from srbh_tpu_torch.data import datalist, stats
from srbh_tpu_torch.ops.normalize import load_stats_table
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_pandas_sample_is_the_seeded_permutation(n):
    df = pd.DataFrame({"a": np.arange(n)})
    perm = np.random.RandomState(1).permutation(n)
    np.testing.assert_array_equal(df.sample(frac=1, random_state=1).index, perm)
    for k in {1, n // 2, n}:
        np.testing.assert_array_equal(
            df.sample(n=k, random_state=1).index, perm[:k])


def _regions(root, n=(20, 12, 15)):
    for region, count in zip(("usa", "china", "eu"), n):
        d = os.path.join(root, f"s1{region}_check", "sub")
        os.makedirs(d)
        names = [f"{region}_{i:03d}.tif" for i in range(count)]
        if region == "china":
            names += ["shenzhen_001.tif", "a,b.tif"]
        for name in names:
            open(os.path.join(d, name), "wb").close()


def test_build_globe_lists_writes_the_jax_csvs(tmp_path):
    for name in ("jax", "port"):
        _regions(str(tmp_path / name))
    # every split holds a row (pandas cannot read an empty CSV back), and
    # the cap keeps the name with a comma in it
    jdl.build_globe_lists(str(tmp_path / "jax"), china_cap=13)
    datalist.build_globe_lists(str(tmp_path / "port"), china_cap=13)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([p for p in got if p.endswith(".csv")]) == 20
    for p in want:
        assert got[p] == want[p], p
    assert b'"a,b.tif",s1china_check' in got["datalist_globe.csv"]


@pytest.mark.parametrize("rate", [0.9, 0.5, 0.0])
def test_split_data_equals_jax(tmp_path, rate):
    rows = [f"t_{i}.tif,s1c,s2c,b h,\"q,{i}\"" for i in range(23)]
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        (tmp_path / name / "list.csv").write_text("\n".join(rows) + "\n")
    a = jdl.split_data(str(tmp_path / "jax" / "list.csv"), rate)
    b = datalist.split_data(str(tmp_path / "port" / "list.csv"), rate)
    for pa, pb in zip(a, b):
        assert os.path.basename(pa) == os.path.basename(pb)
        assert filecmp.cmp(pa, pb, shallow=False)


def test_addabspath_and_concat_equal_jax(tmp_path):
    for name in ("jax", "port"):
        d = tmp_path / name
        os.makedirs(d / "datalistcopy")
        for c, n in (("china", 3), ("eu", 4), ("usa", 2)):
            (d / "datalistcopy" / f"datalist_{c}.csv").write_text(
                "".join(f"{c}_{i}.tif\n" for i in range(n)))
    for mod, name in ((jdl, "jax"), (datalist, "port")):
        for c in ("china", "eu", "usa"):
            mod.addabspath(str(tmp_path / name), c)
            mod.addabspath(str(tmp_path / name), c)  # a no-op the second time
        mod.concat_allfile(str(tmp_path / name))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def _height_tiles(root, rng, n=5):
    os.makedirs(os.path.join(root, "bh", "city"))
    os.makedirs(os.path.join(root, "s2"))
    names = []
    for i in range(n):
        name = f"t{i}.tif"
        names.append(name)
        jtiff.write_tiff(os.path.join(root, "bh", "city", name),
                         rng.integers(0, 90, (16, 16)).astype(np.uint8))
        jtiff.write_tiff(os.path.join(root, "s2", name),
                         rng.integers(0, 5000, (8, 8, 4)).astype(np.uint16))
    with open(os.path.join(root, "list.csv"), "w") as f:
        f.writelines(f"{n}\n" for n in names[1:])
    return names


def test_stats_tables_and_histograms_equal_jax(tmp_path):
    for name in ("jax", "port"):
        _height_tiles(str(tmp_path / name), np.random.default_rng(0))
    for mod, name in ((jstats, "jax"), (stats, "port")):
        root = str(tmp_path / name)
        mod.main_stats(root, "s2", 4, os.path.join(root, "res"))
        mod.main_stats(root, "s2", 4, os.path.join(root, "res_list"),
                       imglistpath=os.path.join(root, "list.csv"))
        os.replace(os.path.join(root, "res_list", "s2.npy"),
                   os.path.join(root, "res", "s2b.npy"))
        mod.main_stats_merge(["s2", "s2b"], "globe", 4, os.path.join(root, "res"))
        mod.height_histogram(os.path.join(root, "bh"), os.path.join(root, "h"),
                             "bh_stats_a", plot=False)
        mod.height_histogram(os.path.join(root, "bh", "city"),
                             os.path.join(root, "h"), "bh_stats_b",
                             filelist=os.path.join(root, "list.csv"), plot=False)
        mod.merge_height_histograms(["bh_stats_a", "bh_stats_b"],
                                    os.path.join(root, "h"), plot=False)
        mod.floor2height(os.path.join(root, "bh", "city", "t1.tif"),
                         os.path.join(root, "floors"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p] == want[p], p
    table = load_stats_table(str(tmp_path / "port" / "res" / "globe_minmax.txt"))
    assert table.shape == (2, 4) and (table[1] >= table[0]).all()
    csv_head = got[os.path.join("h", "bh_stats_globe.csv")].split(b"\n")[:2]
    assert csv_head[0] == b",height,number,rate" and csv_head[1].startswith(b"0,0,")


def test_histogram_plot_needs_matplotlib(tmp_path, monkeypatch):
    _height_tiles(str(tmp_path), np.random.default_rng(1), n=2)
    hist = stats.height_histogram(str(tmp_path / "bh"), str(tmp_path / "h"),
                                  "a", plot=True)
    assert hist.sum() == 2 * 256
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    assert os.path.exists(tmp_path / "h" / "a_plot.jpg") == has_mpl
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    stats.height_histogram(str(tmp_path / "bh"), str(tmp_path / "h"), "b",
                           plot=True)
    assert not os.path.exists(tmp_path / "h" / "b_plot.jpg")


@pytest.mark.parametrize("cmd", ["stats", "merge", "heights", "merge-heights",
                                 "floor2height"])
def test_cli_subcommands_equal_jax(tmp_path, monkeypatch, cmd):
    argv = {
        "stats": ["stats", "--ipath", "{r}", "--subdir", "s2", "--nband", "4",
                  "--resroot", "{r}/res", "--imglist", "{r}/list.csv"],
        "merge": ["merge", "--regions", "s2", "--subdir", "g", "--nband", "4",
                  "--resroot", "{r}/res"],
        "heights": ["heights", "--height-dir", "{r}/bh", "--savepath", "{r}/h",
                    "--savename", "bh_stats_x"],
        "merge-heights": ["merge-heights", "--regions", "bh_stats_x",
                          "--savepath", "{r}/h"],
        "floor2height": ["floor2height", "{r}/bh/city/t0.tif",
                         "{r}/bh/city/t2.tif", "--resdir", "{r}/m"],
    }
    for mod, name in ((jstats, "jax"), (stats, "port")):
        root = str(tmp_path / name)
        _height_tiles(root, np.random.default_rng(2))
        if cmd == "merge":
            mod._cli([a.format(r=root) for a in argv["stats"]])
        if cmd == "merge-heights":
            mod._cli([a.format(r=root) for a in argv["heights"]])
        # JPEG bytes are not compared
        monkeypatch.setattr(mod, "_plot_histogram", lambda *a: None)
        mod._cli([a.format(r=root) for a in argv[cmd]])
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
