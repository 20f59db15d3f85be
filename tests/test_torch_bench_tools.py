"""The port's measurement tools on the CPU, against the JAX package's.

* ``tools.timing.flop_count`` on the meta device: the full-width flagship's
  RRDB trunk is 135 +- 2 GFLOP a tile (23 x 3 RDBs x 9 x (64 + 96 + 128 +
  160) x 32 + 192 x 64 MAC x 4096 px x 2 = 135.4 G), the serving forward
  150-160; a small stack of each counted layer type by hand.
* ``tools/_trace.check_convs``: it sees every convolution of a tiny train
  step, and fires when the SR features are computed outside the timed call
  (the twin of ``tests/test_bench_chains.py``'s guard on XLA's hoisting).
* ``tools/profile_flagship``'s stages on carried weights: composed, they
  give the full serving forward bit for bit (float32 and bfloat16); each
  matches the JAX stage function of ``srbh_tpu/tools/profile_flagship.py``
  within 1e-4 x (1 + |b|).
* the synthetic data of ``loader_bench`` and ``predict_stress``: their
  files are byte-equal to the JAX tools' (``loader_bench.py:29``,
  ``predict_stress.py:34``) for the same seed at a small size.
* every tool's ``run(device="cpu")`` at tiny width: its records have the
  documented keys, every time and rate is ``None``, and nothing is written
  outside the tool's temporary directories (``composed_bench``'s run also
  holds the ``device`` and ``device_norm`` batches bit-equal; the
  ``predict_stress`` run, the two stitchers' outputs byte-equal); every
  ``main`` raises without a card and prints nothing; the item-15 switches
  (int8, packed, remat) run their modes and say so.
"""
import filecmp
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srbh_tpu import models
from srbh_tpu.tools.loader_bench import _build_synthetic
from srbh_tpu.tools.predict_stress import build_synth_city
from srbh_tpu.train.convert import convert_height_model, convert_rrdbnet
from srbh_tpu_torch import bench, entry
from srbh_tpu_torch.tools import (
    _trace,
    composed_bench,
    conv_microbench,
    export_model,
    loader_bench,
    predict_stress,
    profile_flagship,
    ref_bench,
    sr_train_bench,
    timing,
    train_bench,
    train_diag,
)
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
TILE, BATCH = 32, 2


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= tol, err


def test_flop_count_of_the_full_width_flagship():
    flops = entry.flops_per_tile()
    assert abs(flops["trunk"] / 1e9 - 135) <= 2
    assert 150 <= flops["total"] / 1e9 <= 160
    assert flops["total"] == flops["sr"] + flops["model"]


def test_flop_count_by_hand():
    with torch.device("meta"):
        net = torch.nn.Sequential(
            torch.nn.Conv2d(3, 8, 3, padding=1),
            torch.nn.Conv2d(8, 8, 3, padding=1, groups=4),
            torch.nn.ConvTranspose2d(8, 4, 2, stride=2),
            torch.nn.Flatten(), torch.nn.Linear(4 * 20 * 20, 5))
        x = torch.empty(2, 3, 10, 10)
    macs = (2 * 100 * 8 * 3 * 9 + 2 * 100 * 8 * 2 * 9 + 2 * 100 * 8 * 4 * 4
            + 2 * 5 * 1600)
    assert timing.flop_count(net, x) == 2 * macs


@pytest.fixture(scope="module")
def tiny_train():
    state, step = train_bench.build(train_bench.train_config(True, seed=1337),
                                    torch.float32, torch.device("cpu"),
                                    False, False)
    batch = train_bench.host_batches(1, BATCH, TILE, 0, "cpu")[0]
    return state, step, batch


def test_trace_guard_counts_every_conv_of_the_train_step(tiny_train):
    state, step, batch = tiny_train
    ref = train_bench.sr_reference(state.model, state.sr_model, batch)
    rec = _trace.check_convs(lambda: step(state, batch, 1e-3), ref,
                             state.model, state.sr_model)
    n_convs = len(_trace.conv_modules(state.model, state.sr_model))
    # every conv but RRDBNet's conv_last, which the feature path skips
    assert rec["conv_modules"] == rec["modules_called"] == n_convs - 1
    assert rec["profiled_convs"] == rec["conv_calls"] == n_convs - 1
    assert rec["profiled_on_device"] is None


def test_trace_guard_fires_on_features_computed_outside(tiny_train):
    state, step, batch = tiny_train
    x = batch["image"].permute(0, 3, 1, 2)
    with torch.no_grad():
        fea = state.sr_model(x[:, :3], features_only=True)
    frozen = torch.nn.Module()
    frozen.forward = lambda image, features_only=True: fea  # the set-up's features
    hoisted = train_bench.make_train_step(state.model, frozen, seed=1337,
                                          device="cpu")
    ref = train_bench.sr_reference(state.model, state.sr_model, batch)
    with pytest.raises(AssertionError, match="left out"):
        _trace.check_convs(lambda: hoisted(state, batch, 1e-3), ref,
                           state.model, state.sr_model)


@pytest.fixture(scope="module")
def pair():
    """The tiny flagship in the port, with random BatchNorm statistics and
    the height head's bias lifted (so heights survive the clamp), and the
    same weights as JAX variables through the JAX package's own converter
    (``srbh_tpu/train/convert.py``)."""
    tm, tsr, _ = entry.flagship(tiny=True, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for name, t in tm.state_dict().items():
        if name.endswith("running_mean"):
            t.normal_(0, 0.1, generator=gen)
        elif name.endswith("running_var"):
            t.uniform_(0.5, 1.5, generator=gen)
    with torch.no_grad():
        tm.reg.conv_last.bias.fill_(2.0)
    numpy = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    jm = models.SRRegressClsFeature(encoder_name="efficientnet-test", super_mid=8,
                                    isaggre=True, chans_build=7)
    jsr = models.RRDBNet(num_block=2, num_feat=16, num_grow_ch=8)
    return dict(jm=jm, jsr=jsr, tm=tm, tsr=tsr,
                variables=convert_height_model(numpy(tm), True, "efficientnet-test"),
                sr_params=convert_rrdbnet(numpy(tsr), 2))


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_profile_stages_compose_to_the_full_forward(pair, dtype):
    fns = profile_flagship.stage_fns(pair["tm"], pair["tsr"], dtype)
    x = torch.rand(BATCH, 8, TILE, TILE, generator=torch.Generator().manual_seed(1))
    for got, want in zip(profile_flagship.compose(fns, x), fns["full"](x)):
        assert torch.equal(got, want)


def test_profile_stages_match_the_jax_stages(pair):
    """The JAX tool's stage functions (profile_flagship.py:95-135, without
    their ``mean``) against the port's, on each stage's own seeded input."""
    jm, variables = pair["jm"], pair["variables"]
    fns = profile_flagship.stage_fns(pair["tm"], pair["tsr"], torch.float32)
    ins = profile_flagship.stage_inputs(pair["tm"], pair["tsr"], BATCH, TILE, 3,
                                        "cpu")
    j = lambda t: jnp.asarray(nhwc(t))

    def stages(v, sr_params, x3, fea, x8, dec, hr16):
        def encdec(m, xx):
            feats = m.encoder(xx, False)
            return m.decoder1(*feats, train=False), m.decoder2(*feats, train=False)

        apply = functools.partial(jm.apply, v)
        return {"trunk": pair["jsr"].apply(sr_params, x3, features_only=True),
                "hrfeat": apply(fea, method=lambda m, f: m.hrfeat(f, False)),
                "encdec": apply(x8, method=encdec),
                "heads": apply(dec, hr16, method=lambda m, lr, hr: (
                    m.reg(lr, hr, False), m.seg(lr, hr, False))),
                "aggre": apply(dec, method=lambda m, f: m.aggre_height(f))}

    dec, _, hr16 = ins["heads"]
    want = jax.jit(stages)(variables, pair["sr_params"], j(ins["trunk"][0]),
                           j(ins["hrfeat"][0]), j(ins["encdec"][0]), j(dec), j(hr16))
    for name in ("trunk", "hrfeat", "aggre"):
        close(nhwc(fns[name](*ins[name])), want[name])
    for name in ("encdec", "heads"):
        for got, w in zip(fns[name](*ins[name]), want[name]):
            close(nhwc(got), w)
    height, build = ins["postproc"]
    xp = jnp.concatenate([j(height), j(build)], -1)
    want_h = jnp.round(jnp.clip(xp[..., 0], 0, None) * 10).astype(jnp.uint16)
    want_b = jnp.round(jax.nn.softmax(xp[..., 1:8], axis=-1) * 255
                       ).astype(jnp.uint16)
    got = fns["postproc"](height, build)
    np.testing.assert_array_equal(got[2].numpy().astype(np.int64),
                                  np.asarray(want_h, np.int64))
    np.testing.assert_array_equal(got[3].numpy().astype(np.int64),
                                  np.asarray(want_b, np.int64))


def _same_files(a, b):
    files = lambda root: sorted(str(p.relative_to(root))
                                for p in Path(root).rglob("*") if p.is_file())
    assert files(a) == files(b) and files(a)
    for f in files(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def test_loader_files_are_byte_equal_to_jax(tmp_path):
    _build_synthetic(str(tmp_path / "jax"), 3)
    loader_bench.build_synthetic(str(tmp_path / "port"), 3)
    _same_files(tmp_path / "jax", tmp_path / "port")


def test_city_files_are_byte_equal_to_jax(tmp_path):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    build_synth_city(str(tmp_path / "jax"), 150)
    predict_stress.build_synth_city(str(tmp_path / "port"), 150)
    _same_files(tmp_path / "jax", tmp_path / "port")


CPU = dict(device="cpu")
RUNS = {
    "bench": lambda: bench.run(batch=1, tile=TILE, tiny=True, **CPU),
    "profile_flagship": lambda: [profile_flagship.run(
        batch=1, dtype="float32", tile=TILE, tiny=True, **CPU)],
    "conv_microbench": lambda: [conv_microbench.run(
        batch=16, side=8, dtypes=("float32",), **CPU)],
    "train_bench": lambda: train_bench.run(batch=2, dtypes=("float32",),
                                           norm=True, tile=TILE, tiny=True, **CPU),
    "train_diag": lambda: [train_diag.diagnose(2, tile=TILE, tiny=True, **CPU)],
    "sr_train_bench": lambda: sr_train_bench.run(
        batch=1, dtypes=("float32",), lq=8, num_block=1, num_feat=8,
        num_grow_ch=4, disc_feat=8, **CPU),
    "loader_bench": lambda: loader_bench.run(tiles=4, epochs=1, workers=(0,),
                                             batch=2, **CPU),
    "composed_bench": lambda: composed_bench.run(
        batch=2, tiles=2, workers=(0,), modes=("device_norm",), tiny=True, **CPU),
    "predict_stress": lambda: predict_stress.run(size=120, batch=4, tiny=True,
                                                 **CPU),
    "ref_bench": lambda: [ref_bench.run(batch=1, tile=TILE, tiny=True, **CPU)],
}
# keys every record of the tool has, and those that must be None on the CPU
KEYS = {
    "bench": ({"metric", "batch", "dtype", "value", "flop_per_tile", "mfu",
               "peak_gib", "idle_share", "busy_ms", "convs", "median_ms",
               "q1_ms", "q3_ms", "event_ms", "repeats"},
              {"value", "median_ms", "q1_ms", "q3_ms", "event_ms",
               "tflop_per_s", "mfu", "peak_gib", "idle_share", "busy_ms"}),
    "profile_flagship": ({"stages", "sum_of_parts_ms", "full_ms", "repeats"},
                         {"sum_of_parts_ms", "full_ms", "full_tiles_per_sec"}),
    "conv_microbench": ({"cases", "chain", "repeats"}, set()),
    "train_bench": ({"metric", "value", "mfu", "idle_share", "busy_ms",
                     "kernels", "convs", "median_ms", "q1_ms", "q3_ms",
                     "event_ms", "repeats", "loss"},
                    {"value", "median_ms", "event_ms", "mfu", "tflop_per_s",
                     "idle_share", "busy_ms", "kernels", "peak_gib"}),
    "train_diag": ({"sr", "fwd", "step", "max_memory_allocated_gib",
                    "max_memory_reserved_gib", "repeats"},
                   {"sr_fwd_ms", "loss_fwd_ms", "step_ms", "tiles_per_sec",
                    "max_memory_allocated_gib", "max_memory_reserved_gib"}),
    "sr_train_bench": ({"metric", "value", "kernels", "idle_share", "busy_ms",
                        "median_ms", "event_ms", "repeats", "l_g_total"},
                       {"value", "median_ms", "event_ms", "kernels",
                        "idle_share", "busy_ms", "peak_gib"}),
    "loader_bench": ({"metric", "num_workers", "value", "host_cpus"}, {"value"}),
    "composed_bench": ({"metric"}, {"value", "median_ms", "pageable_mb_s",
                                    "pinned_mb_s", "transfer_bound_tiles_per_sec"}),
    "predict_stress": ({"metric"}, {"value", "median_ms", "windows_per_sec",
                                    "peak_gib", "idle_share", "busy_ms",
                                    "kernels"}),
    "ref_bench": ({"metric", "value", "mfu", "convs", "median_ms", "event_ms",
                   "repeats"},
                  {"value", "median_ms", "event_ms", "mfu", "tflop_per_s",
                   "idle_share", "busy_ms"}),
}


@pytest.mark.parametrize("tool", sorted(RUNS))
def test_run_on_the_cpu_has_null_times(tool, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = sorted(os.listdir(REPO))
    records = RUNS[tool]()
    assert sorted(os.listdir(REPO)) == before and not os.listdir(tmp_path)
    want, null = KEYS[tool]
    for rec in records:
        assert rec["tool"] == tool and rec["device"] == "cpu"
        assert rec["power_limit"] is None and "tf32" in rec
        assert want <= set(rec) or rec["metric"] not in {r["metric"] for r in records[:1]}
        for k in null & set(rec):
            assert rec[k] is None, k
        assert rec.get("repeats", 0) == 0
    if tool == "profile_flagship":
        assert all(v["median_ms"] is None for v in records[0]["stages"].values())
    if tool == "conv_microbench":
        assert all(v["ms_per_conv"] is None for v in records[0]["cases"].values())
    if tool == "composed_bench":
        assert records[0]["device_equals_device_norm"]
        assert records[1]["bytes_per_tile"] == 147456  # raw s2 + s1 + height
    if tool == "predict_stress":
        eq = records[-1]
        assert eq["build_equal"] and eq["height_equal"]
        assert [r["stitcher"] for r in records[1:3]] == ["device", "host"]
        assert {"idle_share", "busy_ms", "kernels"} <= set(records[1])


MAINS = {
    "bench": (bench.main, []),
    "bench --train": (bench.main, ["--train"]),
    "bench --sr-train": (bench.main, ["--sr-train"]),
    "profile_flagship": (profile_flagship.main, []),
    "conv_microbench": (conv_microbench.main, []),
    "train_bench": (train_bench.main, []),
    "train_diag": (train_diag.main, []),
    "sr_train_bench": (sr_train_bench.main, []),
    "loader_bench": (loader_bench.main, []),
    "composed_bench": (composed_bench.main, []),
    "predict_stress": (predict_stress.main, []),
    "ref_bench": (ref_bench.main, []),
    "export_model": (export_model.main, ["flagship.pt2"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_needs_a_card_and_prints_nothing(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(argv)
    assert capsys.readouterr().out == "" and not os.listdir(tmp_path)


SWITCHED = {  # the record's key that names the mode, and its metric suffix
    "SRBH_BENCH_INT8": (RUNS["bench"], "int8", "_int8"),
    "SRBH_BENCH_PACKED": (RUNS["bench"], "packed", "_packed"),
    "SRBH_TRAIN_REMAT": (RUNS["train_bench"], "remat", "_remat"),
    "SRBH_TRAIN_REMAT diag": (RUNS["train_diag"], "remat", None),
    "SRBH_SR_REMAT": (RUNS["sr_train_bench"], "remat", "_remat"),
}


@pytest.mark.parametrize("var", sorted(SWITCHED) + ["stages"])
def test_item_15_switches_raise(var, monkeypatch):
    """The JAX tools' item-15 switches, which raised until the layout
    options were ported: each now runs its mode on the CPU at tiny size
    (the bench's conv guard included) and says so in its records; the
    profiler's packed and grouped stages run beside the literal ones."""
    if var == "stages":
        stages = profile_flagship.STAGES[-4:]
        rec = profile_flagship.run(batch=1, dtype="float32", tile=TILE,
                                   tiny=True, stages=stages, **CPU)
        assert sorted(rec["stages"]) == sorted(stages)
        return
    run, key, suffix = SWITCHED[var]
    monkeypatch.setenv(var.split()[0], "1")
    records = run()
    for rec in records:
        assert rec[key] is True
        if suffix:
            assert rec["metric"].endswith(suffix)
    if var.startswith("SRBH_BENCH"):
        assert records[0]["convs"]["reference_unhooked"] > 0
    monkeypatch.delenv(var.split()[0])
    assert all(rec[key] is False for rec in run())
