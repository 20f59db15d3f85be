"""The port's own spans (``srbh_tpu_torch/utils/profiler.py``) on the CPU.

A tiny city (``test_torch_predict.write_city``, 200x150, 12 windows) goes
through ``predict_cities`` at the tiny flagship, and the GAN step runs at
``test_torch_gan_step``'s small settings:

* off (no profiler, no ``recording()``), ``span()`` is one shared object
  that reads no clock, takes no keyword dict and records no CUDA event,
  and nothing is stored;
* under ``recording()`` the city gives one tree: a step and a copy a
  batch, the loader's start before the first step, one strip encode under
  each of the two writes, and each span's self time; under a CPU profiler
  with no ``recording()``, the same spans, and ``srbh.`` ranges nesting as
  they do;
* a GAN step is a root ``gan.step`` over its five parts; the store keeps
  its newest ``STORE_SPANS`` spans;
* the GeoTIFFs' bytes, the GAN's losses and its parameters after a step are
  bit-equal with recording on and off.
"""
import collections
import contextlib
import inspect
import os
import threading

import pytest
import torch

from srbh_tpu_torch import entry
from srbh_tpu_torch.data.grid import GridImageDataset
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.predict.predictor import predict_cities
from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer
from srbh_tpu_torch.utils import profiler
from test_torch_gan_step import _batches, _kw
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_predict import KW, write_city

BATCH = 5  # 12 windows: batches of 5, 5 and 2
CITY_TREE = {"loader.start": "predict.city", "predict.step": "predict.city",
             "predict.sr_features": "predict.step",
             "predict.height_model": "predict.step",
             "predict.copy_out": "predict.city",
             "predict.finalize": "predict.city",
             "predict.write": "predict.city", "tiff.encode": "predict.write"}
GAN_PARTS = ["gan.g_pass", "gan.g_adam", "gan.d_pass", "gan.d_adam",
             "gan.ema"]


@pytest.fixture(autouse=True)
def _empty_store():
    profiler.clear()
    yield
    profiler.clear()


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("city"))
    write_city(root)
    return root


@pytest.fixture(scope="module")
def models():
    model, sr, _ = entry.flagship(tiny=True, device="cpu")
    return model, sr


def _map(city, models, out, stitch="host"):
    model, sr = models
    return predict_cities(city, ["demo"], model, sr,
                          os.path.join(city, "stats"), out, **KW,
                          batch_size=BATCH, stitch=stitch, device="cpu",
                          dtype=torch.float32)[0]


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _gan(record):
    trainer = RealESRGANTrainer(**_kw())
    state = trainer.init(0, (2, 8, 8, 3), device="cpu")
    (lq, gt), = _batches(1, seed=3)
    scope = profiler.recording() if record else contextlib.nullcontext()
    with scope:
        metrics = trainer.make_step()(state, lq, gt)
    return state, metrics


def _parent_names(spans):
    return [(s["name"], None if s["parent"] is None
             else spans[s["parent"]]["name"]) for s in spans]


class _NoClock:
    def perf_counter_ns(self):
        raise AssertionError("a span read the clock while off")


def _no_event(*args, **kwargs):
    raise AssertionError("a span made a CUDA event while off")


def test_off_is_one_shared_object(monkeypatch):
    monkeypatch.setattr(profiler, "time", _NoClock())
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    first = profiler.span("predict.step")
    for _ in range(100):
        with profiler.span("gan.g_pass", device=True) as sp:
            assert sp is first
    assert profiler.spans() == []
    # no ``**kwargs``: a call builds no dict
    kinds = {p.kind for p in inspect.signature(
        profiler.span).parameters.values()}
    assert kinds == {inspect.Parameter.POSITIONAL_OR_KEYWORD}


def test_off_records_nothing_over_a_city_and_a_gan_step(city, models,
                                                        tmp_path):
    _map(city, models, str(tmp_path / "off"))
    _gan(record=False)
    assert profiler.spans() == []


def test_city_tree_under_recording(city, models, tmp_path):
    with profiler.recording():
        paths = _map(city, models, str(tmp_path / "on"))
    spans = profiler.spans()
    assert [s["name"] for s in spans if s["parent"] is None] == \
        ["predict.city"]
    for name, parent in _parent_names(spans):
        assert parent == CITY_TREE.get(name), name
    ds = GridImageDataset(city, "demo", os.path.join(city, "stats"), **KW)
    n_batches = -(-len(ds) // BATCH)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    assert len(by_name["predict.step"]) == n_batches
    assert len(by_name["predict.copy_out"]) == n_batches
    assert len(by_name["predict.finalize"]) == 1
    start, = by_name["loader.start"]
    # the loader's start ends before the first step: it spans no yield
    assert start["t1_ns"] <= by_name["predict.step"][0]["t0_ns"]
    # the build map's write, then the heights': each over its strip encode
    writes, encodes = by_name["predict.write"], by_name["tiff.encode"]
    assert len(writes) == len(encodes) == 2
    for w, e in zip(writes, encodes):
        assert spans[e["parent"]] is w
        assert w["self_ns"] == (w["t1_ns"] - w["t0_ns"]) - (
            e["t1_ns"] - e["t0_ns"])
    assert all(os.path.exists(p) for p in paths)
    # self time: the span's length less its children's
    for i, s in enumerate(spans):
        kids = sum(k["t1_ns"] - k["t0_ns"] for k in spans
                   if k["parent"] == i)
        assert s["self_ns"] == s["t1_ns"] - s["t0_ns"] - kids >= 0
        assert s["device_ms"] is None
        assert s["t0_ns"] <= s["t1_ns"]


def test_device_stitching_has_no_copy_out(city, models, tmp_path):
    with profiler.recording():
        _map(city, models, str(tmp_path / "device"), stitch="device")
    names = collections.Counter(s["name"] for s in profiler.spans())
    assert names["predict.copy_out"] == 0
    assert names["predict.step"] == 3 and names["predict.finalize"] == 1


def test_a_profiler_records_the_same_spans_and_ranges(city, models,
                                                      tmp_path):
    with profiler.recording():
        _map(city, models, str(tmp_path / "rec"))
    want = sorted(_parent_names(profiler.spans()))
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _map(city, models, str(tmp_path / "prof"))
    assert sorted(_parent_names(profiler.spans())) == want
    ranges = []
    for e in prof.events():
        if not e.name.startswith(profiler.RANGE_PREFIX):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(
                profiler.RANGE_PREFIX):
            up = up.cpu_parent
        strip = len(profiler.RANGE_PREFIX)
        ranges.append((e.name[strip:], up.name[strip:] if up else None))
    assert sorted(ranges) == want


def test_gan_step_spans():
    state, _ = _gan(record=True)
    spans = profiler.spans()
    assert [s["name"] for s in spans] == ["gan.step"] + GAN_PARTS
    assert [s["parent"] for s in spans] == [None] + [0] * 5
    assert state.step == 1
    parts = sum(s["t1_ns"] - s["t0_ns"] for s in spans[1:])
    assert spans[0]["self_ns"] == \
        spans[0]["t1_ns"] - spans[0]["t0_ns"] - parts


def test_threads_keep_their_own_parents():
    seen = {}

    def other():
        with profiler.span("gan.ema") as sp:
            seen["other"] = sp

    with profiler.recording():
        with profiler.span("predict.city"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiler.span("predict.step"):
                pass
        for _ in range(2):
            with profiler.span("predict.step", device=True):
                pass
    spans = profiler.spans()
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("predict.city", None), ("gan.ema", None), ("predict.step", 0),
        ("predict.step", None), ("predict.step", None)]
    assert spans[3]["device_ms"] is None  # no card in this process


def test_open_and_orphaned_spans_are_left_out():
    with profiler.recording():
        with profiler.span("predict.city"):
            with profiler.span("predict.step"):
                pass
            assert profiler.spans() == []  # its parent is still open
    assert [s["name"] for s in profiler.spans()] == ["predict.city",
                                                     "predict.step"]


def test_store_stays_bounded():
    n = profiler.STORE_SPANS
    with profiler.recording():
        for k in range(n + 10):
            with profiler.span("predict.step" if k >= 10 else "gan.step"):
                pass
    spans = profiler.spans()
    assert len(spans) == n
    assert {s["name"] for s in spans} == {"predict.step"}


def test_loader_start_ends_before_the_first_batch_of_a_short_epoch():
    data = [{"x": torch.full((2,), float(i))} for i in range(3)]
    loader = DataLoader(data, batch_size=2, num_workers=0, prefetch=2)
    with profiler.recording():
        got = []
        for b in loader:
            with profiler.span("predict.step"):
                got.append(b["x"])
    assert [g.tolist() for g in got] == [[[0, 0], [1, 1]], [[2, 2]]]
    assert [(s["name"], s["parent"]) for s in profiler.spans()] == [
        ("loader.start", None), ("predict.step", None),
        ("predict.step", None)]


def test_outputs_are_bit_equal_with_recording_on_and_off(city, models,
                                                         tmp_path):
    off = _read(_map(city, models, str(tmp_path / "off")))
    with profiler.recording():
        on = _read(_map(city, models, str(tmp_path / "on")))
    assert on == off
    s_off, m_off = _gan(record=False)
    s_on, m_on = _gan(record=True)
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for net in ("net_g", "net_d", "g_ema"):
        a = getattr(s_off, net).state_dict()
        b = getattr(s_on, net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
