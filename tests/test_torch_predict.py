"""The port's city predictor against the JAX package's.

A synthetic 200x150 city (mirrors ``tests/test_predict.py``: 6-band S2
with GeoKeys, 2-band S1, a 50 % WSF mask, a 64/56 fishnet) goes through
``predict_city`` of both packages at the tiny flagship configuration
(RRDBNet-2 of width 16, ``efficientnet-test``), weights carried across with
``convert``, BatchNorm running statistics random and the height head's bias
lifted so heights survive the clamp at 0, float32 on both sides. The
mosaics are quantised: heights may differ by 1 LSB (a value on a rounding
edge rounds either way) on at most 0.1 % of pixels, and classes are equal
on at least 99.9 %. The geotransform, colormap and GeoKeys are equal.
"""
import copy
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from srbh_tpu.data import grid as jgrid
from srbh_tpu.data import tiff as jtiff
from srbh_tpu.predict import predictor as jpred
from srbh_tpu.train.convert import save_tree_npz
from srbh_tpu_torch import convert
from srbh_tpu_torch.data.grid import GridImageDataset
from srbh_tpu_torch.data.tiff import TiffReader
from srbh_tpu_torch.predict import __main__ as cli
from srbh_tpu_torch.predict import predictor
from srbh_tpu_torch.predict.predictor import (
    make_city_step,
    predict_city,
    serving_outputs,
)
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


GT = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
GEO_KEYS = np.array([1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32650],
                    "<u2").tobytes()
LSB_SHARE = 1e-3  # quantised outputs: <= 1 LSB on <= 0.1 % of pixels
KW = dict(s1dir="s1x", s2dir="s2x", gridvalid="isv", nchans=6)


def write_city(root, name="demo", seed=0, w=200, h=150):
    """S2, S1, WSF and the tagged grid of one city, with the JAX package's
    writers, and the min-max tables under ``root/stats``."""
    os.makedirs(os.path.join(root, "stats"), exist_ok=True)
    rng = np.random.default_rng(seed)
    path = lambda suffix: os.path.join(root, f"{name}_{suffix}.tif")
    jtiff.write_tiff(path("s2"), rng.integers(0, 5000, (h, w, 6)).astype(
        np.uint16), geotransform=GT, geo_keys=GEO_KEYS)
    jtiff.write_tiff(path("s1"), rng.uniform(-25, 5, (h, w, 2)).astype(
        np.float32), geotransform=GT)
    jtiff.write_tiff(path("wsf"), (rng.random((h, w)) < 0.5).astype(
        np.uint8) * 255, geotransform=GT)
    jgrid.write_fishgrid(path("s2"), 64, 56)
    jgrid.fishgrid_stats(path("wsf"), path("s2")[:-4] + "_grid.shp",
                         condition=(0, 20, 4096))
    np.savetxt(os.path.join(root, "stats", "s2x_minmax.txt"),
               np.stack([np.full(6, 0.0), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "stats", "s1x_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean"
        else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in tree.items()}


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("city"))
    write_city(root)
    return root


@pytest.fixture(scope="module")
def models():
    """The tiny flagship on both sides, the same weights."""
    jm, jsr, variables, sr_params, _ = graft._flagship(tile=64, batch=2,
                                                       tiny=True)
    params = jax.device_get(variables["params"])
    params["reg"]["conv_last"]["bias"] = np.full((1,), 2.0, np.float32)
    variables = {"params": params, "batch_stats": _random_stats(
        jax.device_get(variables["batch_stats"]), np.random.default_rng(0))}
    sr_params = jax.device_get(sr_params)
    from srbh_tpu_torch import entry

    tm, tsr, _ = entry.flagship(tiny=True, device="cpu")
    tm.load_state_dict(convert.height_model_state_dict(
        variables, "efficientnet-test", isaggre=True), strict=True)
    tsr.load_state_dict(convert.rrdbnet_state_dict(sr_params, 2), strict=True)
    return dict(jm=jm, jsr=jsr, variables=variables, sr_params=sr_params,
                tm=tm, tsr=tsr)


def _port_city(city, models, out, **kw):
    ds = GridImageDataset(city, "demo", os.path.join(city, "stats"), **KW)
    step = make_city_step(models["tm"], models["tsr"], dtype=torch.float32,
                          device="cpu")
    return predict_city(ds, step, out, "demo", device="cpu", **kw)


def test_predict_city_matches_jax(city, models, tmp_path):
    ds = jgrid.GridImageDataset(city, "demo", os.path.join(city, "stats"), **KW)
    step = jpred.make_city_step(models["jm"], models["jsr"], dtype=jnp.float32)
    want = jpred.predict_city(ds, step, models["variables"],
                              models["sr_params"], str(tmp_path / "jax"),
                              "demo", batch_size=5)
    # 12 windows in batches of 5: the port runs the short last batch as is
    got = _port_city(city, models, str(tmp_path / "port"), batch_size=5)
    assert [os.path.basename(p) for p in got] == \
        ["demo_build.tif", "demo_height.tif"]
    (gb, gh), (wb, wh) = ([TiffReader(p) for p in pair] for pair in (got, want))
    heights = gh.read()[..., 0].astype(np.int64), wh.read()[..., 0].astype(np.int64)
    assert heights[0].shape == (600, 800) and gh.dtype == np.uint16
    assert (heights[1] > 0).mean() > 0.5  # the lifted bias: real heights
    diff = np.abs(heights[0] - heights[1])
    assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE
    classes = gb.read()[..., 0], wb.read()[..., 0]
    assert (classes[0] == classes[1]).mean() >= 1 - LSB_SHARE
    assert classes[0].max() <= 6 and gb.dtype == np.uint8
    for a, b in ((gb, wb), (gh, wh)):
        ia, ib = a.info(), b.info()
        assert ia.geotransform == ib.geotransform == (GT[0], 2.5, 0.0, GT[3],
                                                      0.0, -2.5)
        assert ia.geo_keys == ib.geo_keys == GEO_KEYS
        assert (ia.colormap, ia.compression) == (ib.colormap, ib.compression)
    assert gb.info().colormap[6] == (127, 0, 0, 255)
    assert gh.info().compression == 8  # DEFLATE


def _conv_inputs(*modules):
    """Forward pre-hooks on every ``Conv2d`` of ``modules``: the list they
    fill with each call's input, and the hooks' handles."""
    seen, handles = [], []
    for m in modules:
        for conv in m.modules():
            if isinstance(conv, torch.nn.Conv2d):
                handles.append(conv.register_forward_pre_hook(
                    lambda _mod, args: seen.append(args[0])))
    return seen, handles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_runs_channels_last(models, dtype):
    """Inside ``make_city_step``'s step every conv of both models reads a
    channels-last input, so cuDNN's NHWC kernels need no transform; the
    quantised maps match ``serving_outputs`` run NCHW (contiguous weights
    and input) on a deep copy of the same weights, within the file's LSB
    rule."""
    dtype = getattr(torch, dtype)
    image = torch.rand((2, 64, 64, 8),
                       generator=torch.Generator().manual_seed(3))
    nchw = [copy.deepcopy(models[k]).to(memory_format=torch.contiguous_format)
            for k in ("tm", "tsr")]
    seen, handles = _conv_inputs(*nchw)
    with torch.inference_mode():
        want = serving_outputs(*nchw, image.permute(0, 3, 1, 2).contiguous(),
                               dtype=dtype)[2:]
    assert seen and all(t.is_contiguous() for t in seen)
    for h in handles:
        h.remove()
    calls = len(seen)
    step_models = [copy.deepcopy(m) for m in nchw]
    seen, _ = _conv_inputs(*step_models)
    got = make_city_step(*step_models, dtype=dtype, device="cpu")(image)
    assert len(seen) == calls
    assert sum(not t.is_contiguous(memory_format=torch.channels_last)
               for t in seen) == 0
    heights = [h.numpy().astype(np.int64) for h in (got[0], want[0])]
    diff = np.abs(heights[0] - heights[1])
    assert (heights[1] > 0).mean() > 0.5
    assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE
    builds = [b.numpy().astype(np.int64) for b in (got[1], want[1])]
    bdiff = np.abs(builds[0] - builds[1])
    assert bdiff.max() <= 1 and (bdiff > 0).mean() <= LSB_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_city_step_converts_the_passed_modules_in_place(models, dtype):
    """``make_city_step`` converts the modules it is given, not copies (the
    benchmark's forward timers and ``srbh_tpu_torch.bench`` act on them
    after building the step): every conv weight of both is channels-last
    afterwards, and a second step built on them gives the first step's maps
    bit for bit."""
    dtype = getattr(torch, dtype)
    image = torch.rand((2, 64, 64, 8),
                       generator=torch.Generator().manual_seed(5))
    tm, tsr = (copy.deepcopy(models[k]).to(
        memory_format=torch.contiguous_format) for k in ("tm", "tsr"))
    first = make_city_step(tm, tsr, dtype=dtype, device="cpu")(image)
    weights = [m.weight for net in (tm, tsr) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    assert len(weights) > 10
    assert all(w.is_contiguous(memory_format=torch.channels_last)
               for w in weights)
    second = make_city_step(tm, tsr, dtype=dtype, device="cpu")(image)
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _explode(_image):
    raise AssertionError("the step ran for a finished city")


def test_resume_needs_both_tifs(city, models, tmp_path):
    ds = GridImageDataset(city, "demo", os.path.join(city, "stats"), **KW)
    out = str(tmp_path / "out")
    build, height = _port_city(city, models, out, batch_size=8)
    stamp = os.stat(height).st_mtime_ns, os.stat(build).st_mtime_ns
    assert predict_city(ds, _explode, out, "demo", device="cpu") == \
        (build, height)
    assert (os.stat(height).st_mtime_ns, os.stat(build).st_mtime_ns) == stamp
    with open(height, "rb") as f:
        want = f.read()
    os.remove(height)  # a crash between the two writes: the city runs again
    _port_city(city, models, out, batch_size=8)
    with open(height, "rb") as f:
        assert f.read() == want
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]


def test_device_stitch_tifs_equal_host_stitch_tifs(city, models, tmp_path):
    paths = {stitch: _port_city(city, models, str(tmp_path / stitch),
                                batch_size=4, stitch=stitch)
             for stitch in ("host", "device")}
    for a, b in zip(paths["host"], paths["device"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_device_canvas_budget_guard(city, models, tmp_path, monkeypatch,
                                   capsys):
    fits = predictor._device_canvas_fits
    assert predictor._canvas_bytes(2048, 2048, 7, 4) == 8192 * 8192 * 4 * 9
    monkeypatch.delenv("SRBH_DEVICE_CANVAS_BUDGET", raising=False)
    # on the CPU: the JAX package's 6 GiB
    assert fits(2048, 2048, 7, 4, "cpu") and not fits(4096, 4096, 7, 4, "cpu")
    # on a card: half its memory (an 80 GB card here)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80e9))
    assert fits(2048, 2048, 7, 4, "cuda") and not fits(8192, 8192, 7, 4, "cuda")
    monkeypatch.setenv("SRBH_DEVICE_CANVAS_BUDGET", str(2 * 2**30))
    assert not fits(2048, 2048, 7, 4, "cuda") and fits(512, 512, 7, 4, "cuda")
    monkeypatch.undo()
    # end to end: a tiny budget sends stitch="device" to the host stitcher
    monkeypatch.setenv("SRBH_DEVICE_CANVAS_BUDGET", "1000")
    btif, htif = _port_city(city, models, str(tmp_path / "guard"),
                            batch_size=4, stitch="device")
    assert "falling back to the host stitcher" in capsys.readouterr().out
    assert os.path.exists(btif) and os.path.exists(htif)


def _cli_tree(root, models):
    """The CLI's inputs: two cities of one urban-center group, the min-max
    tables, the JAX package's npz checkpoint ``checkpoint20.npz`` (epoch
    20) and SR weights."""
    region = os.path.join(root, "data", "urban", "input_data", "s2chn_large")
    write_city(region, "alpha", seed=1, w=120, h=120)
    write_city(region, "beta", seed=2, w=140, h=100)
    logdir = os.path.join(root, "logs")
    os.makedirs(logdir)
    save_tree_npz(os.path.join(logdir, "checkpoint20.npz"), {
        "params": models["variables"]["params"],
        "batch_stats": models["variables"]["batch_stats"],
        "log_vars": np.array([0.1, -0.2, 0.3], np.float32),
        "epoch": np.array(20)})
    save_tree_npz(os.path.join(root, "sr.npz"), models["sr_params"])
    return ["--datapath", os.path.join(root, "data"), "--logdir", logdir,
            "--logdirhr", os.path.join(root, "sr.npz"),
            "--datastats", os.path.join(region, "stats"), "--s1dir", "s1x",
            "--s2dir", "s2x", "--encoder_name", "efficientnet-test",
            "--super_mid", "8", "--sr_num_block", "2", "--sr_num_feat", "16",
            "--sr_num_grow", "8"]


def test_cli_main_reads_a_jax_npz_checkpoint(models, tmp_path):
    argv = _cli_tree(str(tmp_path), models)
    got = cli.main(argv, device="cpu")
    respath = str(tmp_path / "logs" / "pred_20_citychn_large")
    assert got == [(os.path.join(respath, f"{c}_build.tif"),
                    os.path.join(respath, f"{c}_height.tif"))
                   for c in ("alpha", "beta")]
    # the CLI's weights are the npz's: the same cities through the port's
    # predictor with the converted weights (bfloat16, batch 16) give the
    # same bytes
    region = os.path.join(str(tmp_path), "data", "urban", "input_data",
                          "s2chn_large")
    want = predictor.predict_cities(
        region, ["alpha", "beta"], models["tm"], models["tsr"],
        os.path.join(region, "stats"), str(tmp_path / "direct"), batch_size=16,
        device="cpu", **{k: v for k, v in KW.items() if k != "gridvalid"})
    for pair_a, pair_b in zip(got, want):
        for a, b in zip(pair_a, pair_b):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
    assert TiffReader(got[1][1]).width == 4 * 140
    stamps = [os.stat(p).st_mtime_ns for pair in got for p in pair]
    assert cli.main(argv, device="cpu") == got  # resumed: nothing rewritten
    assert [os.stat(p).st_mtime_ns for pair in got for p in pair] == stamps
