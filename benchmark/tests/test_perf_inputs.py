"""Inputs and weights made from the seed: the same seed gives the same,
another seed another; and the port reads the benchmark's files as the
reference does."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers import common, gan, serve
from benchmark.synth import city, pairs

from conftest import DATA

BIG = 2**31 + 12345


def _cfg(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_flagship_weights_follow_the_seed():
    cfg = _cfg("flagship_tiny")
    w1 = serve.flagship_weights(cfg, BIG, "cpu")
    w2 = serve.flagship_weights(cfg, BIG, "cpu")
    w3 = serve.flagship_weights(cfg, BIG + 1, "cpu")
    assert _same(w1[0], w2[0]) and _same(w1[1], w2[1])
    assert not torch.equal(w1[1]["conv_first.weight"],
                           w3[1]["conv_first.weight"])



def test_flagship_heads_are_normalised():
    """Whatever the seed, the calibration batch maps to heights of mean 25
    m and spread 5 m, and build logits of spread 2."""
    from benchmark.reference import flagship
    cfg = _cfg("flagship_tiny")
    for seed in (BIG, BIG + 1):
        hm_state, sr_state = serve.flagship_weights(cfg, seed, "cpu")
        hm, rsr = flagship.build(cfg)
        hm.load_state_dict(hm_state)
        rsr.load_state_dict(sr_state)
        x = serve.tile_pool(1, 8, cfg, seed ^ 0xCA11B, "cpu")[0]
        with torch.no_grad():
            xx = x.permute(0, 3, 1, 2)
            h, b, _ = hm(xx, rsr(xx[:, :3], features_only=True))
        assert float(h.mean()) == pytest.approx(25.0, rel=1e-4)
        assert float(h.std()) == pytest.approx(5.0, rel=1e-4)
        b = b - hm_state["seg.conv_last.bias"].view(1, -1, 1, 1)
        assert float(b.std()) == pytest.approx(2.0, rel=1e-4)


def test_gan_weights_follow_the_seed():
    cfg = _cfg("realesrgan_tiny")
    a, b = gan.gan_weights(cfg, BIG, "cpu"), gan.gan_weights(cfg, BIG, "cpu")
    assert all(_same(x, y) for x, y in zip(a, b))
    u = a[1]["conv1.weight_u"]
    assert abs(float(u.norm()) - 1.0) < 1e-6


def test_tile_pool_and_samples_follow_the_seed():
    cfg = _cfg("flagship_tiny")
    p1 = serve.tile_pool(2, 3, cfg, BIG, "cpu")
    p2 = serve.tile_pool(2, 3, cfg, BIG, "cpu")
    assert torch.equal(p1, p2) and p1.shape == (2, 3, 64, 64, 8)
    assert not torch.equal(p1, serve.tile_pool(2, 3, cfg, BIG + 1, "cpu"))
    assert common.sample_indices(BIG, 1, 6, 60) == \
        common.sample_indices(BIG, 1, 6, 60)


def test_pairs_follow_the_seed_and_the_port_reads_them(tmp_path):
    from srbh_tpu_torch.data.dataset import LRHRPairDataset
    lq, gt = pairs.make(5, 16, BIG, "cpu")
    lq2, gt2 = pairs.make(5, 16, BIG, "cpu")
    assert np.array_equal(lq, lq2) and np.array_equal(gt, gt2)
    files = pairs.write(str(tmp_path), lq, gt)
    ds = LRHRPairDataset(files["datalist"], files["rootname"],
                         files["datastats"], s2dir="s2", gedir="ge", nchans=3)
    x, y = pairs.normalised(lq, gt)
    for i in range(5):
        s = ds[i]
        assert torch.equal(torch.as_tensor(s["lq"]).float().permute(2, 0, 1),
                           x[i])
        assert torch.equal(torch.as_tensor(s["gt"]).float().permute(2, 0, 1),
                           y[i])


def test_epoch_order_is_the_loaders():
    from srbh_tpu_torch.data.pipeline import _EpochOrder
    order = _EpochOrder(40, True, 77)
    order.epoch = 0
    assert list(order) == gan.epoch_order(40, 77, 0).tolist()


def test_city_follows_the_seed_and_the_port_reads_its_grid(tmp_path):
    from srbh_tpu_torch.data.grid import GridImageDataset
    c1, c2 = city.make(200, BIG, "cpu"), city.make(200, BIG, "cpu")
    assert all(np.array_equal(c1[k], c2[k]) for k in c1)
    n = city.write(str(tmp_path / "c"), str(tmp_path / "s"), "x", c1)
    ds = GridImageDataset(str(tmp_path / "c"), "x", str(tmp_path / "s"),
                          s1dir="s1x", s2dir="s2x", gridvalid="isv")
    pos = city.valid_windows(c1["wsf"])[4]
    assert len(ds) == n == len(pos) and [tuple(p) for p in ds.pos] == pos
    from benchmark.reference.city import window_batch
    tables = ((np.zeros(6), np.full(6, city.S2_MAX)),
              (np.full(2, city.S1_MIN), np.full(2, city.S1_MAX - city.S1_MIN)))
    mine = window_batch(c1["s2"], c1["s1"], pos[:3], tables)
    for i in range(3):
        assert np.array_equal(ds[i]["image"], mine[i])
