"""The readers of the program's spans (``source: program_span``) against
hand-built span lists: the median over the cell's roots but the oldest
(the warm-up stretch's root moves it not, also beside a single unit, as
in the city cell), spans under roots of another kind left out, and
``None`` where there are no roots or the program records no spans."""
from __future__ import annotations

import json
import os

import pytest

from benchmark.harness.registry import metric_reader

from conftest import REPO

# metric -> (root, paths under the root to the spans it reads, the value
# read, the metric's unit per second or ms, sum or mean over the spans)
# ("own": the span's host time less its children's)
READERS = {
    "serve.sr_trunk_host_ms": ("predict.step", [["predict.sr_features"]],
                               "host", 1e3, "sum"),
    "serve.height_model_host_ms": ("predict.step", [["predict.height_model"]],
                                   "host", 1e3, "sum"),
    "gan.g_pass_stream_ms": ("gan.step", [["gan.g_pass"]], "device", 1.0,
                             "sum"),
    "gan.g_pass_host_ms": ("gan.step", [["gan.g_pass"]], "host", 1e3, "sum"),
    "gan.d_pass_stream_ms": ("gan.step", [["gan.d_pass"]], "device", 1.0,
                             "sum"),
    "gan.d_pass_host_ms": ("gan.step", [["gan.d_pass"]], "host", 1e3, "sum"),
    "gan.update_stream_ms": ("gan.step", [["gan.g_adam"], ["gan.d_adam"],
                                          ["gan.ema"]], "device", 1.0, "sum"),
    "gan.update_host_ms": ("gan.step", [["gan.g_adam"], ["gan.d_adam"],
                                        ["gan.ema"]], "host", 1e3, "sum"),
    "city.copy_out_ms": ("predict.city", [["predict.copy_out"]] * 3, "host",
                         1e3, "mean"),
    "city.loader_start_s": ("predict.city", [["loader.start"]], "host", 1.0,
                            "sum"),
    "city.finalize_s": ("predict.city", [["predict.finalize"]], "host", 1.0,
                        "sum"),
    "city.tiff_encode_s": ("predict.city",
                           [["predict.write", "tiff.encode"]] * 2, "host",
                           1.0, "sum"),
    "city.write_io_s": ("predict.city", [["predict.write"]] * 2, "own", 1.0,
                        "sum"),
}
OTHER_ROOT = {"predict.step": "predict.city", "gan.step": "predict.step",
              "predict.city": "gan.step"}


def _tree(spans, root, paths, kind, value, parent=None, decoy=True):
    """Append a root (or a child of ``parent``) and, under it, each path
    ending in a span worth ``value``, and one span no reader asks for."""
    def add(name, up, v=None):
        ns = int((v or 0) * 1e9) if kind != "device" or v is None else 0
        # an "own" value: the span's self time, its children's time on top
        spans.append({"name": name, "parent": up, "t0_ns": 0,
                      "t1_ns": ns + (int(3e9) if kind == "own" else 0),
                      "self_ns": ns if kind == "own" else 0,
                      "device_ms": v if kind == "device" else None})
        return len(spans) - 1

    top = add(root, parent)
    for path in paths:
        up = top
        for name in path[:-1]:
            up = add(name, up)
        add(path[-1], up, value)
    if decoy:
        add("predict.other", top, 1000.0)
    return spans


def _spec_entry(name):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry, = [m for m in spec["per_layer"] if m["name"] == name]
    return entry


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_takes_the_median_over_its_roots(name, monkeypatch):
    from srbh_tpu_torch.utils import profiler
    root, paths, kind, scale, how = READERS[name]
    spans = _tree([], root, paths, kind, 100.0)  # the warm-up stretch's
    for v in (0.25, 0.5, 0.5, 100.0, 0.75):
        _tree(spans, root, paths, kind, v)
    # the same spans under a root of another kind, and one level down
    _tree(spans, OTHER_ROOT[root], [[root] + p for p in paths], kind, 50.0)
    outer = _tree(spans, OTHER_ROOT[root], [], kind, 0.0, decoy=False)
    _tree(spans, root, paths, kind, 70.0, parent=len(outer) - 1)
    monkeypatch.setattr(profiler, "spans", lambda: spans)
    per_root = 0.5 * (len(paths) if how == "sum" else 1)
    assert metric_reader(REPO, name)({}) == pytest.approx(per_root * scale)
    entry = _spec_entry(name)
    assert entry["source"] == "program_span"
    assert entry["unit"] == ("ms" if scale == 1e3 or kind == "device"
                             else "s")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_leaves_out_the_warm_up_root_beside_one_unit(name,
                                                            monkeypatch):
    """The city cell profiles the warm-up city and one city of the window:
    the reader reads the window's alone, not the mean of the two."""
    from srbh_tpu_torch.utils import profiler
    root, paths, kind, scale, how = READERS[name]
    spans = _tree([], root, paths, kind, 9.0)  # the warm-up stretch's
    _tree(spans, root, paths, kind, 0.5)
    monkeypatch.setattr(profiler, "spans", lambda: spans)
    per_root = 0.5 * (len(paths) if how == "sum" else 1)
    assert metric_reader(REPO, name)({}) == pytest.approx(per_root * scale)
    # the warm-up root alone leaves nothing to read
    monkeypatch.setattr(profiler, "spans",
                        lambda: _tree([], root, paths, kind, 9.0))
    assert metric_reader(REPO, name)({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_roots_reads_none(name, monkeypatch):
    from srbh_tpu_torch.utils import profiler
    root, paths, kind, _, _ = READERS[name]
    reader = metric_reader(REPO, name)
    monkeypatch.setattr(profiler, "spans", lambda: [])
    assert reader({}) is None
    other = _tree([], OTHER_ROOT[root], paths, kind, 1.0)
    monkeypatch.setattr(profiler, "spans", lambda: other)
    assert reader({}) is None
    # roots without the spans the reader sums
    monkeypatch.setattr(profiler, "spans", lambda: _tree(
        _tree([], root, [], kind, 1.0), root, [], kind, 1.0))
    assert reader({}) is None
    # a program whose profiler records no spans (an older checkout)
    monkeypatch.delattr(profiler, "spans")
    assert reader({}) is None


def test_a_root_without_device_time_is_left_out(monkeypatch):
    """A step recorded off a card (no device time) leaves the median to the
    steps that have one."""
    from srbh_tpu_torch.utils import profiler
    spans = _tree([], "gan.step", [["gan.g_pass"]], "device", 9.0)
    _tree(spans, "gan.step", [["gan.g_pass"]], "device", 4.0)
    _tree(spans, "gan.step", [["gan.g_pass"]], "host", 1.0)
    monkeypatch.setattr(profiler, "spans", lambda: spans)
    assert metric_reader(REPO, "gan.g_pass_stream_ms")({}) == 4.0
    assert metric_reader(REPO, "gan.g_pass_host_ms")({}) == \
        pytest.approx(500.0)
