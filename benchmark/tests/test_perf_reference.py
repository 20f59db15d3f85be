"""The frozen references against the port at tiny sizes on the CPU (float32,
one state dict given to both)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers import gan, serve
from benchmark.reference import flagship, maps
from benchmark.reference import gan as refgan

from conftest import DATA

SEED = 2**32 + 99


def _cfg(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def test_flagship_reference_matches_the_port():
    from srbh_tpu_torch.predict.predictor import serving_outputs
    cfg = _cfg("flagship_tiny")
    model, sr = serve.port_models(cfg, "cpu")
    hm_state, sr_state = serve.flagship_weights(cfg, SEED, "cpu")
    model.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    hm, rsr = flagship.build(cfg)
    hm.load_state_dict(hm_state)
    rsr.load_state_dict(sr_state)
    x = serve.tile_pool(1, 3, cfg, SEED, "cpu")[0]
    with torch.no_grad():
        h, p = serving_outputs(model.eval(), sr.eval(),
                               x.permute(0, 3, 1, 2), dtype=torch.float32)[:2]
    h_ref, p_ref, _ = flagship.serve(hm, rsr, x)
    scale = float(h_ref.abs().max())
    assert float((h - h_ref).abs().max()) <= 1e-5 * scale
    assert float((p - p_ref).abs().max()) <= 1e-5
    assert float(h_ref.std()) > 0.1  # the heights carry the network's signal


def test_map_check_reads_one_for_the_yardstick_itself():
    cfg = _cfg("flagship_tiny")
    hm_state, sr_state = serve.flagship_weights(cfg, SEED, "cpu")
    hm, rsr = flagship.build(cfg)
    hm.load_state_dict(hm_state)
    rsr.load_state_dict(sr_state)
    x = serve.tile_pool(1, 2, cfg, SEED, "cpu")[0]
    h, p, _ = flagship.serve(hm, rsr, x)
    yard = flagship.quantised(*flagship.serve(hm, rsr, x,
                                              dtype=torch.bfloat16)[:2])
    same = maps.MapCheck()
    same.add(*yard, h, p, *yard)
    assert same.readings() == {"height_tile_ratio": 1.0,
                               "build_tile_ratio": 1.0}
    exact = maps.MapCheck()
    exact.add(*flagship.quantised(h, p), h, p, *yard)
    r = exact.readings()
    assert r["height_tile_ratio"] < 1.0 and r["build_tile_ratio"] < 1.0


def test_map_check_reads_one_wrong_tile_by_itself():
    """One tile's heights +3 m among many reads that tile's error over the
    yardstick's worst tile, not a share of the batch's."""
    cfg = _cfg("flagship_tiny")
    hm_state, sr_state = serve.flagship_weights(cfg, SEED, "cpu")
    hm, rsr = flagship.build(cfg)
    hm.load_state_dict(hm_state)
    rsr.load_state_dict(sr_state)
    x = serve.tile_pool(1, 8, cfg, SEED, "cpu")[0]
    h, p, _ = flagship.serve(hm, rsr, x)
    yard = flagship.quantised(*flagship.serve(hm, rsr, x,
                                              dtype=torch.bfloat16)[:2])
    wrong = yard[0].to(torch.int32)
    wrong[3] += 30
    check = maps.MapCheck()
    check.add(wrong.to(torch.uint16), yard[1], h, p, *yard)
    worst_yard = check.stats()["yardstick_worst_tile_m"]
    assert check.readings()["height_tile_ratio"] >= 3.0 / worst_yard * 0.9
    assert check.readings()["height_tile_ratio"] > 3.0


def test_city_blocks_read_one_wrong_window_by_itself():
    from benchmark.reference import city
    rng = np.random.default_rng(SEED)
    truth = rng.integers(200, 300, (1024, 1024)).astype(np.uint16)
    yard = (truth.astype(np.int64) + rng.integers(-2, 3, truth.shape)
            ).astype(np.uint16)
    m = np.ones(truth.shape, bool)
    m[:, 900:] = False
    wrong = yard.astype(np.int64)
    wrong[256:512, 512:768] += 30
    worst = city.block_rms(yard, truth, m).max()
    assert city.block_rms(yard, truth, m).shape == (16,)
    assert city.block_rms(wrong.astype(np.uint16), truth, m).max() > 10 * worst


def test_gan_reference_matches_the_port_over_three_steps():
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
    cfg = _cfg("realesrgan_tiny")
    t, g = cfg["model"]["train"], cfg["model"]["generator"]
    states = gan.gan_weights(cfg, SEED, "cpu")
    trainer = RealESRGANTrainer(num_block=g["num_block"],
                                num_feat=g["num_feat"],
                                num_grow_ch=g["num_grow_ch"],
                                disc_feat=cfg["model"]["discriminator"]["num_feat"])
    state = trainer.init(0, (t["batch"], t["lq"], t["lq"], 3),
                         g_state=states[0], d_state=states[1],
                         vgg_state=states[2], device="cpu")
    step = trainer.make_step()
    gen = torch.Generator().manual_seed(SEED)
    batches = [(torch.rand(t["batch"], 3, t["lq"], t["lq"], generator=gen),
                torch.rand(t["batch"], 3, t["gt"], t["gt"], generator=gen))
               for _ in range(3)]
    rec = gan.reference_record(cfg, states, batches, "cpu")
    for k, (lq, gt) in enumerate(batches):
        m = step(state, lq.permute(0, 2, 3, 1), gt.permute(0, 2, 3, 1))
        for name, v in rec["losses"][k].items():
            assert float(m[name]) == pytest.approx(v, rel=1e-5), (k, name)
    ref_params = refgan.GANStep(cfg, *states, "cpu")
    del ref_params
    after = {"g." + n: p for n, p in state.net_g.named_parameters()}
    before = {"g." + n: v for n, v in states[0].items()}
    change = gan.norms({k: after[k] - before[k] for k in after})
    worst = max(abs(change[k] - rec["change"][k]) / max(rec["change"][k], 1e-12)
                for k in change)
    assert worst < 1e-3
