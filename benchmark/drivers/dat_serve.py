"""DAT serving: a closed loop of one client sending batches of RGB tiles
through the port's SR harness (``tools/swinir_harness.py``) with DAT built
in SwinIR's place.

The model is the configuration's preset built by ``define_model(...,
arch="dat")`` with the benchmark's seeded weights loaded by
``load_state_dict``. Each request takes one batch of the traffic's
``batch`` NHWC float32 tiles in [0, 1] from a pool of ``pool_batches``
seeded batches in pinned host memory (``sr_serve.tile_pool``), copies it to
the card, runs ``apply``, copies the (batch, 4 t, 4 t, 3) float32 output
into pinned host memory and synchronises once. A request's latency is that
whole span; the rate counts every tile of every request over the whole
window.

Every attention of a forward counts itself in ``ops/dat_attention.calls``
(a window branch of a spatial block, a channel block): a request whose
forward adds other than the configuration's numbers is a failed request
and fails the run (``attn_call_misses``, limit 0).

``checked_requests`` request indices, drawn from the seed, keep their
outputs apart, and the input and the attention output (before the gates)
of two attention modules of the middle residual group: its first shifted
spatial block and its first channel block (:func:`tapped`). Once the window
has closed and the program is freed, the reference (``reference/dat.py``)
recomputes those batches in float32 with TF32 off (the truth) and at the
configuration's TF32 defaults (the yardstick: on a card cuDNN's TF32
convolutions, elsewhere the reference's emulation of them).
``sr_tile_ratio``: the program's worst tile by RMS error against the truth
over the yardstick's worst tile. The TF32 convolutions' error hides a lower
precision of the attention at the output, so ``dat_attn_err`` holds the
attention to float32 alone: the reference recomputes each tapped module's
attention output (qkv linear, windows, shift and mask or the channel
attention; no convolution) from the program's own input, TF32 off, and the
reading is the worst tile's RMS error over the RMS of the reference's
output.

Traffic keys: ``batch``, ``pool_batches``, ``warmup_requests``,
``checked_requests``, ``trace_skip`` / ``trace_units`` (the profiled
stretch of a traced run, in requests).
"""
from __future__ import annotations

import contextlib
import fnmatch
import time

import torch
from torch import nn

from benchmark.drivers import common
from benchmark.drivers.sr_serve import (
    Phases,
    TileCheck,
    range_kernel_ms,
    tf32_flags,
    tile_pool,
)
from benchmark.harness import dat_counts, stats
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import seeded_state
from benchmark.reference import dat as ref

# the port's ranges whose kernels a traced run sums (``srbh.`` + span name)
RANGES = ("dat.body", "dat.upsample", "dat.spatial_attn", "dat.channel_attn",
          "dat.spatial_core")


def dat_weights(cfg: dict, seed: int, dev) -> dict:
    """The state dict drawn on ``dev`` from the seed, with the names of the
    reference (on the meta device, so nothing of the port moves the draw),
    by the configuration's rules (``weights``)."""
    w = cfg["weights"]
    with torch.device("meta"):
        model = ref.build(cfg)
    template = model.state_dict()
    gains = {k: g for pat, g in w["gains"].items() for k in template
             if fnmatch.fnmatchcase(k, pat)}
    state = seeded_state(template, seed, dev, gains=gains,
                         default_gain=w["default_gain"],
                         bias_std=w["bias_std"], constants=w["constants"])
    for name, m in model.named_modules():
        if isinstance(m, nn.LayerNorm):
            k = name + ".weight"
            state[k] = 1.0 + w["layernorm_scale_std"] * state[k]
        elif isinstance(m, ref.Adaptive_Channel_Attention):
            k = name + ".temperature"
            state[k] = 1.0 + w["temperature_std"] * state[k]
    return state


def expected_calls(cfg: dict) -> dict:
    """The attention calls of one forward: two window branches a spatial
    block (even index), one a channel block (odd)."""
    depth = cfg["model"]["depth"]
    return {"spatial": sum(2 * ((d + 1) // 2) for d in depth),
            "channel": sum(d // 2 for d in depth)}


def port_model(cfg: dict, state: dict, dev):
    """The configuration's preset through ``swinir_harness.define_model`` on
    ``dev``, with ``state`` loaded."""
    from srbh_tpu_torch.tools import swinir_harness

    m = cfg["model"]
    model = swinir_harness.define_model(m["task"], m["scale"], arch=m["arch"],
                                        device=dev)
    model.load_state_dict(state)
    return model


def tapped(model) -> list:
    """The attention modules whose every forward a checked request keeps:
    the middle residual group's first shifted spatial block and its first
    channel block, the port's or the reference's (the same state-dict
    path)."""
    g = len(model.layers) // 2
    blocks = model.layers[g].blocks
    first = next(b for b in range(0, len(blocks), 2) if ref.shifted(g, b))
    return [blocks[first].attn, blocks[1].attn]


def unshift(model):
    """A fault: the middle group's first shifted block (the tapped one) run
    unshifted (no roll, no mask)."""
    tapped(model)[0].shift = False
    return model


@contextlib.contextmanager
def attn_tap(model, into: list):
    """Append to ``into`` a (module index, input tokens, attention output)
    float32 copy, both (B, H W, C), of each forward of the :func:`tapped`
    modules of ``model`` (the port's ``attend`` from the qkv projection, or
    the reference's ``attend_qkv``)."""
    undo = []
    for i, m in enumerate(tapped(model)):
        name = "attend_qkv" if hasattr(m, "attend_qkv") else "attend"
        inner = getattr(m, name)
        seen = {}

        def pre(_m, args, seen=seen):
            seen["x"] = args[0]

        def wrapped(qkv, *rest, i=i, inner=inner, seen=seen):
            out = inner(qkv, *rest)
            x = seen.pop("x")
            into.append((i, x.float().reshape(x.shape[0], -1, x.shape[-1])
                         .clone(),
                         out.float().reshape(out.shape[0], -1, out.shape[-1])
                         .clone()))
            return out

        setattr(m, name, wrapped)
        undo.append((m, name, m.register_forward_pre_hook(pre)))
    try:
        yield
    finally:
        for m, name, hook in undo:
            delattr(m, name)
            hook.remove()


class Check(TileCheck):
    """``sr_serve.TileCheck``'s output tiles, and each tile's relative RMS
    error of the tapped attention outputs against the reference's from the
    same inputs."""

    def __init__(self):
        super().__init__()
        self.attn = []

    def add_attn(self, out, ref_out):
        size = ref_out.cpu().double().pow(2).flatten(1).mean(1)
        self.attn.append((self._tile_sq(out, ref_out)
                          / size.clamp_min(1e-300)).sqrt())

    def readings(self) -> dict:
        out = super().readings()
        if self.attn:
            out["dat_attn_err"] = float(torch.cat(self.attn).max())
        return out

    def stats(self) -> dict:
        return {**super().stats(),
                "attn_err_median": (float(torch.cat(self.attn).median())
                                    if self.attn else None)}


def reference(cfg: dict, state: dict, dev):
    model = ref.build(cfg).eval()
    model.load_state_dict(state)
    return model.to(dev)


def yardstick(model, x, dev):
    """The reference at the configuration's TF32 defaults: cuDNN's TF32
    convolutions on a card, their emulation elsewhere."""
    if dev.type == "cuda":
        return ref.nhwc(model, x, cudnn_tf32=True)
    ref.set_tf32(model, True)
    try:
        return ref.nhwc(model, x)
    finally:
        ref.set_tf32(model, False)


def reference_check(cfg, state, pool, kept, dev) -> Check:
    """Recompute the pool batches of the kept requests with the reference
    and compare; ``kept`` maps a pool index to a list of the program's
    (output, tapped (index, input, attention output) triples) of that
    batch. The tapped attentions are recomputed from the program's own
    inputs in float32 with TF32 off."""
    model = reference(cfg, state, dev)
    mods = tapped(model)
    t = cfg["model"]["tile"]
    check = Check()
    for p, outs in sorted(kept.items()):
        x = pool[p].to(dev)
        truth = ref.nhwc(model, x)
        yard = yardstick(model, x, dev)
        for out, taps in outs:
            check.add(out, truth, yard)
            for i, xin, aout in taps:
                with tf32_flags(False, False), torch.no_grad():
                    want = mods[i].attend(xin.to(dev), t, t)
                check.add_attn(aout, want)
    return check


def _readings(check, misses=0) -> dict:
    return {**check.readings(), "attn_call_misses": misses}


def _in_place(cfg, state, pool, pool_idx, dev, forward) -> dict:
    """The readings with ``forward(model, x)`` of the reference put in the
    program's place on the pool batches ``pool_idx``."""
    model = reference(cfg, state, dev)
    kept = {}
    for p in pool_idx:
        taps = []
        with attn_tap(model, taps):
            out = forward(model, pool[p].to(dev))
        kept[p] = [(out.float(), taps)]
    del model
    return _readings(reference_check(cfg, state, pool, kept, dev))


def control(ctx, out) -> dict:
    """The control: the reference under bfloat16 autocast in the program's
    place, on the pool batches a run checked."""
    state, pool, _ = out["state"]

    def bf16(model, x):
        with torch.autocast(ctx.device.type, dtype=torch.bfloat16):
            return ref.nhwc(model, x)

    return _in_place(ctx.config, state, pool, out["checked_pool"], ctx.device,
                     bf16)


def faults(ctx, out) -> dict:
    """The readings of the faults, on a run's checked batches: ``one_tile``
    (one tile's output +0.01), ``unshifted_block`` (the program with
    :func:`unshift` planted), ``channel_norm`` (the reference in the
    program's place with every channel block's q and k normalised over
    channels instead of tokens) and, beside them, the TF32-matmul control
    (``tf32_matmul``: the reference with cuBLAS's TF32 on too, in the
    program's place; the same as the truth off a card)."""
    from srbh_tpu_torch.tools import swinir_harness

    state, pool, by_pool = out["state"]
    cfg, dev = ctx.config, ctx.device
    readings = {}
    kept, first = {}, True
    for p, outs in sorted(by_pool.items()):
        kept[p] = []
        for o, taps in outs:
            o = o.clone()
            if first:
                o[0] += 0.01
                first = False
            kept[p].append((o, taps))
    readings["one_tile"] = _readings(reference_check(cfg, state, pool, kept,
                                                     dev))
    model = unshift(port_model(cfg, state, dev))
    kept = {}
    for p in by_pool:
        taps = []
        with attn_tap(model, taps):
            o = swinir_harness.apply(model, pool[p].to(dev))
        kept[p] = [(o.float(), taps)]
    del model
    common.free(dev)
    readings["unshifted_block"] = _readings(reference_check(
        cfg, state, pool, kept, dev))

    def channel_norm(model, x):
        for m in model.modules():
            if isinstance(m, ref.Adaptive_Channel_Attention):
                m.normalise_over = -2
        return ref.nhwc(model, x)

    readings["channel_norm"] = _in_place(cfg, state, pool, sorted(by_pool),
                                         dev, channel_norm)

    def tf32_matmul(model, x):
        return ref.nhwc(model, x, cudnn_tf32=True, matmul_tf32=True)

    readings["tf32_matmul"] = _in_place(cfg, state, pool, sorted(by_pool),
                                        dev, tf32_matmul)
    return readings


def run(ctx) -> dict:
    from srbh_tpu_torch.ops import dat_attention
    from srbh_tpu_torch.tools import swinir_harness

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, n_pool = tr["batch"], tr["pool_batches"]
    phases = Phases(ctx.t_start)
    phases.mark("start")
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        common.sync(dev)
        phases.mark("cuda init")
    state = dat_weights(cfg, ctx.seed, dev)
    phases.mark("weights")
    model = port_model(cfg, state, dev)
    phases.mark("model")
    per_forward = expected_calls(cfg)
    pool = tile_pool(n_pool, batch, cfg, ctx.seed, dev)
    side = cfg["model"]["upscale"] * cfg["model"]["tile"]
    shape = (batch, side, side, cfg["model"]["out_chans"])
    ring = [common.host_buffer(shape, torch.float32, dev) for _ in range(2)]
    checked = common.sample_indices(ctx.seed, 1, tr["checked_requests"],
                                    max(2 * tr["checked_requests"],
                                        int(2 * ctx.seconds)))
    kept = {j: common.host_buffer(shape, torch.float32, dev) for j in checked}
    taps = {j: [] for j in checked}
    calls = []
    phases.mark("pool")

    def request(i):
        out = kept.get(i, ring[i % 2])
        n0 = dict(dat_attention.calls)
        x = pool[i % n_pool].to(dev, non_blocking=True)
        with (attn_tap(model, taps[i]) if i in taps
              else contextlib.nullcontext()):
            y = swinir_harness.apply(model, x)
        out.copy_(y, non_blocking=True)
        common.sync(dev)
        calls.append({k: dat_attention.calls[k] - n0[k] for k in n0})

    # warm-up: the one batch shape the traffic sends, untimed; a traced run
    # also starts the profiler once, whose first start takes seconds
    for w in range(tr["warmup_requests"]):
        swinir_harness.apply(model, pool[w % n_pool].to(dev))
        common.sync(dev)
        phases.mark("first request" if w == 0 else "warm-up")
    if ctx.trace:
        with Stretch():
            swinir_harness.apply(model, pool[0].to(dev))
    common.reset_peak(dev)

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    # the profiled stretch is timed from before the profiler starts to after
    # it stops, so that the rate of the other requests leaves it out
    lat, i, stretch, t_end, traced_s = [], 0, None, t0, 0.0
    trace_end = tr["trace_skip"] + tr["trace_units"]
    while True:
        if ctx.trace and i == tr["trace_skip"]:
            t_trace = time.perf_counter()
            stretch = Stretch().__enter__()
        ts = time.perf_counter()
        request(i)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        i += 1
        if stretch is not None and i == trace_end:
            stretch.__exit__(None, None, None)
            t_end = time.perf_counter()
            traced_s = t_end - t_trace
        if t_end - t0 >= ctx.seconds:
            break
    if stretch is not None and i < trace_end:
        stretch.__exit__(None, None, None)
        t_end = time.perf_counter()
        traced_s = t_end - t_trace
    window = t_end - t0
    tiles_per_s = stats.rate(batch * i, window)
    peak = common.memory_peak(dev)
    misses = sum(c != per_forward for c in calls)

    record = {}
    if ctx.trace:
        n_traced = max(0, min(i, trace_end) - tr["trace_skip"])
        events = stretch.prof.events()
        record = {"trace": stretch.reduce(),
                  "tiles_per_s": stats.rate(batch * (i - n_traced),
                                            window - traced_s),
                  "counts": dat_counts.serve_counts(cfg, batch),
                  "traced_requests": n_traced,
                  "range_kernel_ms": range_kernel_ms(events, RANGES),
                  "batch": batch}

    del model
    common.free(dev)
    by_pool = {}
    for j in checked:
        if j < i:
            by_pool.setdefault(j % n_pool, []).append((kept[j], taps[j]))
    done = sum(len(v) for v in by_pool.values())
    check = reference_check(cfg, state, pool, by_pool, dev)
    readings = _readings(check, misses) if done else {}
    correct, checks = common.judge(readings,
                                   common.limits(ctx.root, ctx.cell["name"]))
    notes = [f"requests {i}, checked {[j for j in checked if j < i]}, "
             f"window {window:.3f} s",
             f"attention calls a request: "
             f"{sorted({tuple(sorted(c.items())) for c in calls})} "
             f"(expected {sorted(per_forward.items())})",
             f"reference {check.stats() if done else None}",
             f"setup {phases}",
             f"card {common.power_limit(dev)}"]
    ratio, limit = checks.get("sr_tile_ratio", (None, None))
    failed = min(i, misses + (0 if ratio is not None and ratio <= limit
                              else done))
    return {"correct": correct and done > 0, "attempted": i,
            "failed": failed,
            "e2e": {"setup_s": setup_s, "serve_tiles_per_s": tiles_per_s,
                    "serve_p95_ms": 1e3 * stats.percentile(lat, 95)},
            "record": record, "memory_peak_bytes": peak, "checks": checks,
            "readings": readings, "checked_pool": sorted(by_pool),
            "state": (state, pool, by_pool), "notes": notes}
