"""The port's legacy loaders (no pandas, no cv2) against the JAX package's.

* ``SimpleTileDataset``: samples equal without augmentation (the x4 nearest
  resize and ``[::4, ::4]`` of the JAX package give the tile back) and with
  the multi-scale height pyramid (nearest resizes, exact); with
  augmentation, equal whenever the rotation branch does not fire and within
  the tolerances of ``tests/test_torch_data.py`` (image 0.03 of a [0, 1]
  range, mask agreement > 0.98) when it does.
* ``WholeImageDataset`` and ``load_whole_s12``: equal.
* The ``preprocess_*`` readers: equal at scale 1 and for the labels at any
  scale (nearest); the bilinear image within 1e-5 of the [0, 1] range of
  cv2's. ``_load_label`` reads a PNG (written by cv2) and a TIFF label to
  ``cv2.imread``'s array.
"""
import os

import cv2
import numpy as np
import pandas as pd
import pytest

from srbh_tpu.data import legacy as jleg
from srbh_tpu.data import tiff as jtiff
from srbh_tpu_torch.data import legacy
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    rng = np.random.default_rng(0)
    for d in ("img", "lab", "sen1", "tlc", "tlc1", "img2", "tlc2"):
        os.makedirs(root / d)
    rows = []
    for i in range(4):
        name = f"img{i:03d}.tif"
        jtiff.write_tiff(str(root / "img" / name),
                         rng.integers(0, 255, (16, 16, 3)).astype(np.uint8))
        for d in ("sen1", "img2"):
            jtiff.write_tiff(str(root / d / name),
                             rng.integers(0, 255, (16, 16, 2)).astype(np.uint8))
        for d in ("tlc1", "tlc2"):
            jtiff.write_tiff(str(root / d / name),
                             rng.integers(0, 255, (16, 16, 1)).astype(np.uint8))
        jtiff.write_tiff(str(root / "tlc" / f"tlc{i:03d}.tif"),
                         rng.integers(0, 255, (16, 16, 1)).astype(np.uint8))
        lab = rng.integers(0, 7, (64, 64)).astype(np.uint8)
        jtiff.write_tiff(str(root / "lab" / f"h{i}.tif"), lab)
        assert cv2.imwrite(str(root / "lab" / f"lab{i:03d}.png"),
                           lab[:16, :16])
        label = (str(root / "lab" / f"lab{i:03d}.png") if i % 2 else
                 str(root / "lab" / f"h{i}.tif"))
        rows.append(f"{root / 'img' / name},{label}")
    (root / "list.csv").write_text("\n".join(rows) + "\n")
    tiles64 = [f"{root / 'img' / f'img{i:03d}.tif'},{root / 'lab' / f'h{i}.tif'}"
               for i in range(4)]
    (root / "train.csv").write_text("\n".join(tiles64) + "\n")
    stats = root / "stats"
    os.makedirs(stats)
    np.savetxt(stats / "s2_rgbnir_minmax.txt",
               np.stack([np.zeros(4), np.full(4, 4000.0)]))
    np.savetxt(stats / "s1_vvvhratio_minmax.txt",
               np.stack([np.full(3, -25.0), np.full(3, 5.0)]))
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    jtiff.write_tiff(str(root / "cityA_s2_rgbnir_clip.tif"),
                     rng.integers(0, 5000, (70, 90, 4)).astype(np.uint16),
                     geotransform=gt)
    jtiff.write_tiff(str(root / "cityA_s1_vvvhratio_clip.tif"),
                     rng.uniform(-25, 5, (70, 90, 3)).astype(np.float32),
                     geotransform=gt)
    return root


def _same(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _rotates(rng):
    if rng.random() < 0.5:
        rng.integers(-1, 2)
    if rng.random() < 0.5:
        rng.permutation(4)
    return rng.random() < 0.5


@pytest.mark.parametrize("multi_scale", [False, True])
def test_simple_tile_dataset_equals_jax(tiles, multi_scale):
    ours = legacy.SimpleTileDataset(str(tiles / "train.csv"), num_sample=3,
                                    multi_scale=multi_scale)
    theirs = jleg.SimpleTileDataset(str(tiles / "train.csv"), num_sample=3,
                                    multi_scale=multi_scale)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _same(ours[i], theirs[i])


def test_simple_tile_dataset_augmented_close_to_jax(tiles):
    ours = legacy.SimpleTileDataset(str(tiles / "train.csv"), aug=True, seed=3)
    theirs = jleg.SimpleTileDataset(str(tiles / "train.csv"), aug=True, seed=3)
    exact = 0
    for epoch in range(4):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            if _rotates(ours._sample_rng(i)):
                assert np.abs(a["image"] - b["image"]).max() < 0.03
                assert (a["height"] == b["height"]).mean() > 0.98
            else:
                _same(a, b)
                exact += 1
    assert exact >= 3


def test_whole_image_dataset_and_whole_load_equal_jax(tiles):
    kw = dict(grid=32, stride=30)
    ours = legacy.WholeImageDataset(str(tiles), "cityA", str(tiles / "stats"), **kw)
    theirs = jleg.WholeImageDataset(str(tiles), "cityA", str(tiles / "stats"), **kw)
    assert len(ours) == len(theirs) == 9
    for i in range(len(ours)):
        _same(ours[i], theirs[i])
    a = legacy.load_whole_s12(str(tiles), "cityA", str(tiles / "stats"),
                              grid=32, stride=8)
    b = jleg.load_whole_s12(str(tiles), "cityA", str(tiles / "stats"),
                            grid=32, stride=8)
    _same(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize("reader", ["imglab", "s12lab", "tlclab", "t1t2"])
@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0])
def test_preprocess_readers_equal_jax(tiles, reader, scale):
    rows = legacy.read_rows(str(tiles / "list.csv"))
    frame = pd.read_csv(str(tiles / "list.csv"), header=None)
    ours, theirs = (getattr(m, f"preprocess_{reader}")
                    for m in (legacy, jleg))
    for idx in range(len(rows)):
        a, b = ours(rows, idx, scale), theirs(frame, idx, scale)
        for got, want in zip(a, b):
            assert got.shape == want.shape and got.dtype == want.dtype
        _same(a[1], b[1])
        if scale == 1.0:
            _same(a[0], b[0])
            _same(a[2], b[2])
        else:
            assert np.abs(a[0] - b[0]).max() <= 1e-5
            assert np.abs(a[2] - b[2]).max() <= (1e-5 if a[2].dtype.kind == "f"
                                                 else 0)


@pytest.mark.parametrize("kind", ["png8", "png16", "tif"])
def test_load_label_equals_cv2(tmp_path, kind):
    rng = np.random.default_rng(2)
    if kind == "tif":
        lab = rng.integers(0, 200, (20, 30)).astype(np.uint8)
        path = str(tmp_path / "l.tif")
        jtiff.write_tiff(path, lab)
    else:
        lab = rng.integers(0, 60000 if kind == "png16" else 255,
                           (20, 30)).astype(np.uint16 if kind == "png16"
                                            else np.uint8)
        path = str(tmp_path / "l.png")
        assert cv2.imwrite(path, lab)
    got = legacy._load_label(path)
    _same(got, jleg._load_label(path))
    _same(got, lab)
