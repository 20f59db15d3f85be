"""SwinIR's spans (``swinir.apply`` in the harness's ``apply``, a root, over
``swinir.body`` over one ``swinir.rstb`` an RSTB, then
``swinir.upsample``) on the CPU, at small widths of the real-world x4
preset: they record and nest under ``recording()`` and under a CPU
profiler; off, every span is the shared no-op object, nothing is stored,
and neither ``window_attention.launches`` nor the output moves."""
import pytest
import torch

from srbh_tpu_torch.models import swinir as tswin
from srbh_tpu_torch.ops.window_attention import window_attention
from srbh_tpu_torch.tools import swinir_harness
from srbh_tpu_torch.utils import profiler
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TREE = [("swinir.apply", None), ("swinir.body", "swinir.apply"),
        ("swinir.rstb", "swinir.body"), ("swinir.rstb", "swinir.body"),
        ("swinir.rstb", "swinir.body"), ("swinir.upsample", "swinir.apply")]


@pytest.fixture(autouse=True)
def _empty_store():
    profiler.clear()
    yield
    profiler.clear()


@pytest.fixture(scope="module")
def model():
    m = tswin.SwinIR(embed_dim=16, depths=(2, 2, 2), num_heads=(8, 8, 8),
                     window_size=8, mlp_ratio=2, upscale=4,
                     upsampler="nearest+conv", resi_connection="3conv",
                     num_feat=8)
    return m.eval()


def _x():
    return torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(3))


def _tree(spans):
    return [(s["name"], None if s["parent"] is None
             else spans[s["parent"]]["name"]) for s in spans]


def test_spans_record_and_nest(model):
    with profiler.recording():
        swinir_harness.apply(model, _x())
    spans = profiler.spans()
    assert _tree(spans) == TREE
    apply = spans[0]
    assert all(apply["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= apply["t1_ns"]
               for s in spans)
    assert all(s["device_ms"] is None for s in spans)  # no card


def test_a_profiler_records_them_as_ranges(model):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        swinir_harness.apply(model, _x())
    assert _tree(profiler.spans()) == TREE
    names = [e.name for e in prof.events()]
    for name, _ in TREE:
        assert profiler.RANGE_PREFIX + name in names


def test_off_is_the_shared_no_op_and_changes_nothing(model, monkeypatch):
    made = []
    span = profiler.span

    def watched(name, device=False):
        made.append((name, span(name, device)))
        return made[-1][1]

    monkeypatch.setattr(profiler, "span", watched)
    launches = window_attention.launches
    off = swinir_harness.apply(model, _x())
    assert window_attention.launches == launches
    assert [n for n, _ in made] == [n for n, _ in TREE]
    assert all(s is profiler._OFF for _, s in made)
    assert profiler.spans() == []
    with profiler.recording():
        on = swinir_harness.apply(model, _x())
    assert window_attention.launches == launches
    assert torch.equal(off, on)


def test_only_body_and_head_time_the_stream(model, monkeypatch):
    """``swinir.body`` and ``swinir.upsample`` ask for a CUDA event pair;
    the root and the nine RSTBs a forward are host spans: their event
    pairs would cost more under a profiler than they tell."""
    asked = []
    span = profiler.span

    def watched(name, device=False):
        asked.append((name, device))
        return span(name, device)

    monkeypatch.setattr(profiler, "span", watched)
    with profiler.recording():
        swinir_harness.apply(model, _x())
    assert asked == [(n, n in ("swinir.body", "swinir.upsample"))
                     for n, _ in TREE]
