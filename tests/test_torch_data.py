"""The port's host data path against the JAX package's.

* The hierarchy LUT and class weights, and the normalisation offsets: equal.
* ``read_tiff`` reads files written by the JAX package's ``write_tiff``
  (none, PackBits, Deflate) and by libtiff (through cv2) and PIL (LZW too)
  bit-equal to the JAX reader; the port's writer emits the same bytes as
  the JAX writer, and round-trips. Several compressed strips encode on a
  thread pool, joined before the write returns; one strip or none
  compressed stay on the caller's thread.
* ``augment_pair_lowres``: flips and grid shuffles equal the JAX package's
  (cv2) exactly; the float32 rotation is held to the tolerances of
  ``tests/test_device_aug.py`` against cv2 (image max 0.03 / mean 0.004 of
  a [0, 1] range, mask agreement > 0.98); the generator ends in the same
  state.
* ``augment_pair``, ``random_flip`` and ``random_rotate`` at full
  resolution: flips, shuffles and every rotated mask equal the JAX
  package's (cv2) exactly (``rotate_mask_nearest`` is OpenCV 5.0's rule,
  held equal to ``cv2.warpAffine`` on uint8, uint16 and float32 masks of
  one and three channels); the rotated image within the low-res rotation's
  bound (max 0.03, mean 0.004); the generator ends in the same state.
* ``S12GlobeDataset`` samples equal the JAX dataset's bit for bit without
  augmentation, and with it whenever the rotation branch does not fire.
* The loader's batches come in the JAX ``DataLoader``'s order.
"""
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from srbh_tpu.data import augment as jaug
from srbh_tpu.data import tiff as jtiff
from srbh_tpu.data.dataset import S12GlobeDataset as JaxDataset
from srbh_tpu.data.pipeline import DataLoader as JaxLoader
from srbh_tpu.ops import hierarchy as jhir
from srbh_tpu.ops import normalize as jnorm
from srbh_tpu_torch.data import augment as taug
from srbh_tpu_torch.data import tiff as ttiff
from srbh_tpu_torch.data.dataset import S12GlobeDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.ops import hierarchy as thir
from srbh_tpu_torch.ops import normalize as tnorm
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def test_hierarchy_lut_and_weights_equal_jax():
    rng = np.random.default_rng(0)
    stats = rng.uniform(1, 1000, 256)
    for hir in (jhir.DEFAULT_HIR, (0, 5, 50, 256)):
        np.testing.assert_array_equal(thir.build_hierarchy_lut(hir),
                                      jhir.build_hierarchy_lut(hir))
        for name in ("sqrt", "simple", "equal"):
            np.testing.assert_array_equal(thir.WEIGHT_METHODS[name](stats, hir),
                                          jhir.WEIGHT_METHODS[name](stats, hir))


def test_normalisation_offsets_equal_jax(tmp_path):
    path = str(tmp_path / "s2_minmax.txt")
    np.savetxt(path, np.stack([np.arange(6.0), 1000 + 7 * np.arange(6.0)]))
    one = str(tmp_path / "one.txt")
    np.savetxt(one, np.array([[2.0], [9.0]]))
    for p, n in ((path, 4), (path, None), (one, None)):
        np.testing.assert_array_equal(tnorm.load_stats_table(p, n),
                                      jnorm.load_stats_table(p, n))
        for method in ("minmax", "meanstd"):
            for a, b in zip(tnorm.norm_offsets(jnorm.load_stats_table(p, n), method),
                            jnorm.norm_offsets(jnorm.load_stats_table(p, n), method)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tnorm.norm_offsets(np.ones((2, 2)), "zscore")


RASTERS = {
    "u16x6": lambda r: np.repeat(r.integers(0, 5000, (37, 12, 6)), 2, axis=1
                                 ).astype(np.uint16),
    "f32x2": lambda r: r.uniform(-25, 5, (20, 17, 2)).astype(np.float32),
    "u8": lambda r: np.repeat(r.integers(0, 100, (300, 64)), 2, axis=0
                              ).astype(np.uint8),
    # many strips at rows_per_strip=64 (12 whole and a short 13th of 23
    # rows): the writer encodes them on its thread pool
    "u16_strips": lambda r: np.repeat(np.repeat(
        r.integers(0, 3000, (198, 10)), 4, axis=0), 4, axis=1
    )[:791].astype(np.uint16),
    "u8x3_strips": lambda r: np.repeat(r.integers(0, 7, (791, 8, 3)), 4,
                                       axis=1).astype(np.uint8),
}


@pytest.mark.parametrize("compress", [None, "PACKBITS", "DEFLATE"])
@pytest.mark.parametrize("kind", sorted(RASTERS))
def test_tiff_reads_and_writes_like_jax(tmp_path, compress, kind):
    arr = RASTERS[kind](np.random.default_rng(len(kind)))
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    theirs, ours = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    jtiff.write_tiff(theirs, arr, gt, compress=compress, rows_per_strip=64)
    ttiff.write_tiff(ours, arr, gt, compress=compress, rows_per_strip=64)
    with open(theirs, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()
    got = ttiff.read_tiff(theirs)
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, jtiff.read_tiff(theirs))
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)
    window = (3, 5, 9, 40)  # crosses strips and the right/bottom edges
    np.testing.assert_array_equal(ttiff.read_tiff(theirs, window),
                                  jtiff.read_tiff(theirs, window))
    assert ttiff.TiffReader(theirs).geotransform == \
        jtiff.TiffReader(theirs).geotransform


def _encode_threads(monkeypatch, barrier=None):
    """The threads ``_compress`` runs on; with ``barrier``, its first two
    calls wait there, so they must come from two threads at once."""
    seen, calls, lock, real = set(), [], threading.Lock(), ttiff._compress

    def spy(data, method):
        with lock:
            seen.add(threading.get_ident())
            calls.append(None)
            first_two = len(calls) <= 2
        if barrier is not None and first_two:
            barrier.wait()
        return real(data, method)

    monkeypatch.setattr(ttiff, "_compress", spy)
    return seen


@pytest.mark.parametrize("compress", ["DEFLATE", "PACKBITS"])
def test_tiff_strips_encode_on_a_pool_and_leave_no_thread(
        tmp_path, monkeypatch, compress):
    cores = len(os.sched_getaffinity(0))
    if cores < 2:
        pytest.skip("one usable core: the writer encodes strips serially")
    arr = RASTERS["u16_strips"](np.random.default_rng(0))
    serial, pooled = str(tmp_path / "serial.tif"), str(tmp_path / "pool.tif")
    before = set(threading.enumerate())
    seen = _encode_threads(monkeypatch, threading.Barrier(2, timeout=30))
    ttiff.write_tiff(pooled, arr, compress=compress, rows_per_strip=64)
    assert 2 <= len(seen) <= min(13, cores)
    assert threading.get_ident() not in seen
    assert set(threading.enumerate()) == before
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    seen = _encode_threads(monkeypatch)
    ttiff.write_tiff(serial, arr, compress=compress, rows_per_strip=64)
    assert seen == {threading.get_ident()}
    with open(serial, "rb") as a, open(pooled, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("rows, compress", [(791, "DEFLATE"), (64, None)])
def test_tiff_one_strip_or_uncompressed_encodes_on_the_caller(
        tmp_path, monkeypatch, rows, compress):
    arr = RASTERS["u16_strips"](np.random.default_rng(0))
    before = set(threading.enumerate())
    seen = _encode_threads(monkeypatch)
    ttiff.write_tiff(str(tmp_path / "a.tif"), arr, compress=compress,
                     rows_per_strip=rows)
    assert seen == {threading.get_ident()}
    assert set(threading.enumerate()) == before
    np.testing.assert_array_equal(
        ttiff.read_tiff(str(tmp_path / "a.tif"))[..., 0], arr)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])  # none/LZW/deflate/packbits
def test_tiff_reads_libtiff_files_like_jax(tmp_path, comp):
    rng = np.random.default_rng(comp)
    img = np.repeat(rng.integers(0, 60000, (37, 23)), 2, axis=1).astype(np.uint16)
    p = str(tmp_path / f"cv{comp}.tif")
    assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    got = ttiff.read_tiff(p)
    np.testing.assert_array_equal(got, jtiff.read_tiff(p))
    np.testing.assert_array_equal(got[..., 0], img)


@pytest.mark.parametrize("pil_comp", ["tiff_lzw", "tiff_deflate", "packbits"])
def test_tiff_reads_pil_files_like_jax(tmp_path, pil_comp):
    from PIL import Image

    arr = np.random.default_rng(3).integers(0, 255, (61, 47, 3)).astype(np.uint8)
    p = str(tmp_path / f"pil_{pil_comp}.tif")
    Image.fromarray(arr).save(p, compression=pil_comp)
    np.testing.assert_array_equal(ttiff.read_tiff(p), jtiff.read_tiff(p))
    np.testing.assert_array_equal(ttiff.read_tiff(p), arr)


def _pair(seed, h=16, c=8, scale=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, h, c)).astype(np.float32)
    mask = rng.integers(0, 120, (h * scale, h * scale)).astype(np.uint8)
    return img, mask


def test_flip_and_grid_shuffle_equal_jax():
    img, mask = _pair(1)
    for d in (-1, 0, 1):
        np.testing.assert_array_equal(taug.flip(img, d), cv2.flip(img, d))
        np.testing.assert_array_equal(taug.flip(mask, d), cv2.flip(mask, d))
    rng = np.random.default_rng(3)
    for odd in (img, img[:15, :13], mask):
        for _ in range(4):
            order = rng.permutation(4)
            np.testing.assert_array_equal(taug.grid_shuffle_2x2(odd, order),
                                          jaug._grid_shuffle_apply(odd, order))


@pytest.mark.parametrize("angle", [-73.4, -30.0, 12.7, 45.0, 88.9])
def test_rotation_close_to_cv2(angle):
    img, mask = _pair(4)
    up = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)
    h, w = up.shape[:2]
    mat = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
    want = jaug._warp(up, mat, cv2.INTER_LINEAR)[::4, ::4]
    err = np.abs(taug.rotate_image_lowres(img, angle, 4) - want)
    assert err.max() < 0.03 and err.mean() < 0.004, (err.max(), err.mean())
    want_m = jaug._warp(mask, mat, cv2.INTER_NEAREST)
    got_m = taug.rotate_mask_nearest(mask, angle)
    assert got_m.dtype == mask.dtype
    assert (got_m == want_m).mean() > 0.98


def _rotates(rng):
    """Whether ``augment_pair_lowres`` with this generator rotates: replay
    its draws."""
    if rng.random() < 0.5:
        rng.integers(-1, 2)
    if rng.random() < 0.5:
        rng.permutation(4)
    return rng.random() < 0.5


@pytest.mark.parametrize("seed", range(12))
def test_augment_pair_lowres_matches_jax(seed):
    img, mask = _pair(seed + 100)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    gi, gm = taug.augment_pair_lowres(ra, img.copy(), mask.copy())
    wi, wm = jaug.augment_pair_lowres(rb, img.copy(), mask.copy())
    assert ra.bit_generator.state == rb.bit_generator.state
    assert gi.shape == wi.shape and gm.shape == wm.shape
    assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
    if _rotates(np.random.default_rng(seed)):
        assert np.abs(gi - wi).max() < 0.03
        assert (gm == wm).mean() > 0.98
    else:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def _full_pair(seed, h=64, w=56):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            rng.integers(0, 120, (h, w)).astype(np.uint8))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("chans", [None, 3])
def test_rotate_mask_nearest_equals_cv2(dtype, chans):
    rng = np.random.default_rng(20)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(5, 140, 2))
        shape = (h, w) if chans is None else (h, w, chans)
        mask = rng.integers(0, 255, shape).astype(dtype)
        angle = float(rng.uniform(-90, 90))
        mat = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
        want = jaug._warp(mask, mat, cv2.INTER_NEAREST)
        np.testing.assert_array_equal(taug.rotate_mask_nearest(mask, angle), want)


@pytest.mark.parametrize("seed", range(4))
def test_random_flip_and_rotate_match_jax(seed):
    img, mask = _full_pair(seed + 200)
    for fn in ("random_flip", "random_rotate"):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        gi, gm = getattr(taug, fn)(ra, img, mask)
        wi, wm = getattr(jaug, fn)(rb, img, mask)
        assert ra.bit_generator.state == rb.bit_generator.state
        assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
        np.testing.assert_array_equal(gm, wm)
        if fn == "random_flip":
            np.testing.assert_array_equal(gi, wi)
        else:
            err = np.abs(gi - wi)
            assert err.max() < 0.03 and err.mean() < 0.004, (err.max(), err.mean())


@pytest.mark.parametrize("seed", range(12))
def test_augment_pair_matches_jax(seed):
    img, mask = _full_pair(seed + 300)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    gi, gm = taug.augment_pair(ra, img.copy(), mask.copy())
    wi, wm = jaug.augment_pair(rb, img.copy(), mask.copy())
    assert ra.bit_generator.state == rb.bit_generator.state
    assert gi.shape == wi.shape and gi.dtype == wi.dtype
    np.testing.assert_array_equal(gm, wm)
    if _rotates(np.random.default_rng(seed)):
        err = np.abs(gi - wi)
        assert err.max() < 0.03 and err.mean() < 0.004, (err.max(), err.mean())
    else:
        np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(6)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(root / d)
    for n in names:
        jtiff.write_tiff(str(root / "s2c" / n),
                         rng.integers(0, 5000, (16, 16, 6)).astype(np.uint16))
        jtiff.write_tiff(str(root / "s1c" / n),
                         rng.uniform(-25, 5, (16, 16, 2)).astype(np.float32))
        if n != "t_5.tif":  # a missing height raster reads as ones
            jtiff.write_tiff(str(root / "bhc" / n),
                             rng.integers(0, 100, (64, 64)).astype(np.uint8))
    with open(root / "list.csv", "w") as f:
        f.writelines(f"{n},s1c,s2c,bhc\n" for n in names)
    with open(root / "names.csv", "w") as f:
        f.writelines(f"{n}\n" for n in names)
    np.savetxt(root / "s2c_minmax.txt", np.stack([np.zeros(6), np.full(6, 4000.0)]))
    np.savetxt(root / "s1c_minmax.txt", np.stack([np.full(2, -20.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000 + np.arange(100)
    np.savetxt(root / "bh_stats.txt", hist)
    return root


def _datasets(root, listname="list.csv", **kw):
    args = dict(datastats=str(root), s1dir="s1c", s2dir="s2c", heightdir="bhc",
                preweight=str(root / "bh_stats.txt"), seed=5, **kw)
    return (S12GlobeDataset(str(root / listname), str(root), **args),
            JaxDataset(str(root / listname), str(root), **args))


def _assert_same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "path":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("listname", ["list.csv", "names.csv"])
@pytest.mark.parametrize("isaggre,ishir", [(True, True), (False, False)])
def test_dataset_samples_equal_jax(tiles, listname, isaggre, ishir):
    ours, theirs = _datasets(tiles, listname, isaggre=isaggre, ishir=ishir,
                             num_sample=5)
    assert len(ours) == len(theirs) == 5
    for i in range(len(ours)):
        _assert_same_sample(ours[i], theirs[i])


def test_augmented_samples_equal_jax_without_rotation(tiles):
    ours, theirs = _datasets(tiles, aug=True, isaggre=True, ishir=True)
    compared = 0
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            if not _rotates(ours._sample_rng(i)):
                _assert_same_sample(a, b)
                compared += 1
    assert compared >= 3


def test_dataset_refuses_what_the_jax_dataset_refuses(tiles, tmp_path):
    with pytest.raises(ValueError, match="ishir"):
        _datasets(tiles, isaggre=True, ishir=False)
    ds = S12GlobeDataset(str(tiles / "list.csv"), str(tiles),
                         datastats=str(tmp_path), s1dir="s1c", s2dir="s2c",
                         heightdir="bhc")
    with pytest.raises(FileNotFoundError, match="S2 stats"):
        ds[0]


class _Indices:
    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, i):
        return {"i": np.int64(i), "path": f"p{i}"}


@pytest.mark.parametrize("shuffle,workers", [(True, 3), (True, 1),
                                             (False, 3)])
def test_loader_order_equals_jax(shuffle, workers):
    ours = DataLoader(_Indices(23), batch_size=4, shuffle=shuffle,
                      num_workers=workers, seed=11)
    theirs = JaxLoader(_Indices(23), batch_size=4, shuffle=shuffle,
                       num_workers=workers, seed=11)
    ours.epoch = theirs.epoch = 2  # a resumed run starts mid-stream
    for _ in range(3):
        got = [(b["i"].tolist(), b["path"]) for b in ours]
        want = [(b["i"].tolist(), b["path"]) for b in theirs]
        assert got == want
    assert ours.dataset.epochs == theirs.dataset.epochs == [2, 3, 4]
    assert len(ours) == len(theirs) == len(got)


def test_loader_copies_to_the_device_and_stops_early():
    loader = DataLoader(_Indices(40), batch_size=4, num_workers=2,
                        device_put=True, device="cpu")
    for k, batch in enumerate(loader):
        assert isinstance(batch["i"], torch.Tensor)
        if k == 1:
            break
    assert [b["i"].tolist() for b in loader][0] == [0, 1, 2, 3]


def test_loader_raises_a_worker_error():
    class Broken(_Indices):
        def __getitem__(self, i):
            if i == 6:
                raise OSError("unreadable tile 6")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="tile 6"):
        list(DataLoader(Broken(12), batch_size=4, num_workers=2))


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_raises_on_a_short_epoch(workers):
    class Stops(_Indices):
        def __getitem__(self, i):
            if i == 21:  # torch's loader ends the epoch here without a word
                raise StopIteration
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="ended after 5 of 10 batches"):
        list(DataLoader(Stops(40), batch_size=4, num_workers=workers))
