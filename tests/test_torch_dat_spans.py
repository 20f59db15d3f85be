"""DAT's spans and its attention counter on the CPU, at small widths: under
``swinir.apply`` (the harness's root) ``dat.body`` holds one ``dat.group``
a residual group, each over its blocks' ``dat.spatial_attn`` (over one
``dat.spatial_core`` a window branch) or ``dat.channel_attn``, and
``dat.sgfn``; then ``dat.upsample``. They record and nest under
``recording()`` and under a CPU profiler; only ``dat.body`` and
``dat.upsample`` ask for a CUDA event pair; off, every span is the shared
no-op object, nothing is stored and the output does not move. The counter
``ops/dat_attention.calls`` adds two window branches a spatial block and
one call a channel block, recording or not."""
import pytest
import torch

from srbh_tpu_torch.models.dat import DAT
from srbh_tpu_torch.ops import dat_attention
from srbh_tpu_torch.tools import swinir_harness
from srbh_tpu_torch.utils import profiler
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

BLOCKS = [("dat.spatial_attn", "dat.group"),
          ("dat.spatial_core", "dat.spatial_attn"),
          ("dat.spatial_core", "dat.spatial_attn"),
          ("dat.sgfn", "dat.group"),
          ("dat.channel_attn", "dat.group"),
          ("dat.sgfn", "dat.group")]
TREE = ([("swinir.apply", None), ("dat.body", "swinir.apply")]
        + 2 * ([("dat.group", "dat.body")] + BLOCKS)
        + [("dat.upsample", "swinir.apply")])


@pytest.fixture(autouse=True)
def _empty_store():
    profiler.clear()
    yield
    profiler.clear()


@pytest.fixture(scope="module")
def model():
    m = DAT(embed_dim=32, split_size=(4, 8), depth=(2, 2), num_heads=(4, 4),
            expansion_factor=2.0, num_feat=8)
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
    off = swinir_harness.apply(model, _x())
    assert [n for n, _ in made] == [n for n, _ in TREE]
    assert all(s is profiler._OFF for _, s in made)
    assert profiler.spans() == []
    with profiler.recording():
        on = swinir_harness.apply(model, _x())
    assert torch.equal(off, on)


def test_only_body_and_head_time_the_stream(model, monkeypatch):
    asked = []
    span = profiler.span

    def watched(name, device=False):
        asked.append((name, device))
        return span(name, device)

    monkeypatch.setattr(profiler, "span", watched)
    with profiler.recording():
        swinir_harness.apply(model, _x())
    assert asked == [(n, n in ("dat.body", "dat.upsample"))
                     for n, _ in TREE]


@pytest.mark.parametrize("recording", [False, True])
def test_the_counter_counts_every_attention(model, recording):
    before = dict(dat_attention.calls)
    if recording:
        with profiler.recording():
            swinir_harness.apply(model, _x())
    else:
        swinir_harness.apply(model, _x())
    assert {k: dat_attention.calls[k] - before[k] for k in before} == {
        "spatial": 4, "channel": 2}


def test_the_published_forward_counts_36_and_18():
    """A 64 x 64 forward of the published preset: 18 spatial blocks of two
    branches, 18 channel blocks (on the meta device: shapes alone)."""
    with torch.device("meta"):
        model = DAT(**swinir_harness._dat_preset("classical_sr", 4)).eval()
        before = dict(dat_attention.calls)
        model(torch.empty(1, 3, 64, 64))
    assert {k: dat_attention.calls[k] - before[k] for k in before} == {
        "spatial": 36, "channel": 18}
