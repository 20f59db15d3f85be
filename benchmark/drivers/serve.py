"""Serving: a closed loop of one client sending batches of tiles through the
port's per-batch city step, ``predict/predictor.py:make_city_step``.

Each request takes one batch of the traffic's ``batch`` tiles from a pool
of ``pool_batches`` seeded batches in pinned host memory, copies it to the
card, runs the step in the traffic's ``dtype``, copies both quantised maps
(uint16 heights, uint8 build softmax) back into pinned host memory and
synchronises once, as the host-stitching CLI does. A request's latency is
that whole span; the rate counts every tile of every request over the whole
window. ``checked_requests`` request indices, drawn from the seed, keep
their outputs apart; once the window has closed and the program is freed
the reference recomputes those batches in float32 (TF32 off) and
``reference/maps.py`` compares.

Traffic keys: ``batch``, ``pool_batches``, ``dtype``, ``warmup_requests``,
``checked_requests``, ``trace_skip`` / ``trace_units`` (the profiled
stretch of a traced run, in requests).
"""
from __future__ import annotations

import time

import torch

from benchmark.drivers import common
from benchmark.harness import counts, stats
from benchmark.harness.spans import ForwardTimer, Spans
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import seeded_state
from benchmark.reference import flagship as ref
from benchmark.reference.maps import MapCheck

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_models(cfg: dict, dev):
    """The port's height model and RRDBNet, built on ``dev``."""
    from srbh_tpu_torch.models.height_model import SRRegressClsFeature
    from srbh_tpu_torch.models.rrdbnet import RRDBNet
    m = cfg["model"]
    with torch.device(dev):
        model = SRRegressClsFeature(
            m["encoder"]["name"], super_mid=m["super_mid"], isaggre=True,
            chans_build=m["chans_build"], sr_chans=m["sr"]["num_feat"],
            decoder_channels=tuple(m["decoder_channels"]))
        sr = RRDBNet(num_in_ch=m["sr"]["num_in_ch"],
                     num_out_ch=m["sr"]["num_out_ch"],
                     num_feat=m["sr"]["num_feat"],
                     num_block=m["sr"]["num_block"],
                     num_grow_ch=m["sr"]["num_grow_ch"])
    return model, sr


def flagship_weights(cfg: dict, seed: int, dev) -> tuple:
    """(height model state, SR state), drawn on ``dev`` from the seed in
    the order of the reference modules' state dicts (built on the meta
    device, so that nothing of the port moves the weights), the two heads
    then normalised (:func:`normalise_heads`)."""
    with torch.device("meta"):
        hm, sr = ref.build(cfg)
    template = {**{"sr." + k: v for k, v in sr.state_dict().items()},
                **{"hm." + k: v for k, v in hm.state_dict().items()}}
    w = cfg["weights"]
    state = seeded_state(template, seed, dev, gains=w["gains"],
                         default_gain=w["default_gain"],
                         bias_std=w["bias_std"], constants=w["constants"])
    hm_state = {k[3:]: v for k, v in state.items() if k.startswith("hm.")}
    sr_state = {k[3:]: v for k, v in state.items() if k.startswith("sr.")}
    normalise_heads(cfg, hm_state, sr_state, seed, dev)
    return hm_state, sr_state


@torch.no_grad()
def normalise_heads(cfg: dict, hm_state: dict, sr_state: dict, seed: int,
                    dev) -> None:
    """Rescale the height and build heads in place so that, over a seeded
    calibration batch run through the reference (float32, TF32 off), the
    heights have the configuration's mean and spread and the build logits
    its spread, whatever the seed's weights make of the scale upstream (a
    layer-sequential unit-variance init of the last layer): every seed then
    maps to heights and classes of one distribution, and the host work that
    depends on them (the GeoTIFF writer's DEFLATE) stays the same."""
    norm = cfg["weights"]["normalise"]
    hm, sr = ref.build(cfg)
    hm.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    hm, sr = hm.to(dev), sr.to(dev)
    x = tile_pool(1, norm["calibration_tiles"], cfg, seed ^ 0xCA11B, dev)[0]
    old = common.tf32(False)
    try:
        xx = x.to(dev).permute(0, 3, 1, 2)
        fea = sr(xx[:, list(cfg["model"]["rgb_idx"])], features_only=True)
        h, b, _ = hm(xx, fea)
    finally:
        common.restore_tf32(old)
    raw_h = h - hm_state["reg.conv_last.bias"].view(1, -1, 1, 1)
    k = norm["height_std_m"] / float(raw_h.std())
    hm_state["reg.conv_last.weight"].mul_(k)
    hm_state["reg.conv_last.bias"].fill_(norm["height_mean_m"]
                                         - k * float(raw_h.mean()))
    raw_b = b - hm_state["seg.conv_last.bias"].view(1, -1, 1, 1)
    hm_state["seg.conv_last.weight"].mul_(norm["build_logit_std"]
                                          / float(raw_b.std()))


def tile_pool(n: int, batch: int, cfg: dict, seed: int, dev) -> torch.Tensor:
    """``n`` batches of normalised NHWC tiles, uniform in [0, 1), drawn on
    ``dev`` from the seed and kept in (pinned) host memory."""
    t = cfg["model"]["tile"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed ^ 0x5EED)
    x = torch.rand((n, batch, t, t, cfg["model"]["in_chans"]), generator=gen,
                   device=dev)
    host = common.host_buffer(x.shape, torch.float32, dev)
    host.copy_(x)
    return host


def serve_flops(cfg: dict, batch: int) -> dict:
    """The benchmark's count of one batch's serving forward, on the
    reference modules at the meta device: ``flops`` and ``bytes`` (bf16) of
    the SR trunk, and ``flops`` of the whole step."""
    m = cfg["model"]
    t = m["tile"]
    with torch.device("meta"):
        hm, sr = ref.build(cfg)
        x = torch.empty(batch, m["in_chans"], t, t)
        fea = torch.empty(batch, m["sr"]["num_feat"], 4 * t, 4 * t)
    trunk = counts.conv_counts(sr, x[:, :3], itemsize=2, features_only=True)
    head = counts.conv_counts(hm, x, fea, itemsize=2)
    return {"trunk_flops": trunk["flops"], "trunk_bytes": trunk["bytes"],
            "step_flops": trunk["flops"] + head["flops"]}


def reference_check(cfg, hm_state, sr_state, pool, kept, dev,
                    dtype=torch.bfloat16) -> MapCheck:
    """Recompute the pool batches of the kept requests with the reference,
    in float32 (TF32 off) and, for the yardstick, in ``dtype``, and
    compare; ``kept`` maps a pool index to a list of (heights, build) host
    outputs of the program."""
    hm, sr = ref.build(cfg)
    hm.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    hm, sr = hm.to(dev), sr.to(dev)
    rgb = tuple(cfg["model"]["rgb_idx"])
    old = common.tf32(False)
    check = MapCheck()
    try:
        for p, outs in sorted(kept.items()):
            x = pool[p].to(dev)
            h_ref, p_ref, _ = ref.serve(hm, sr, x, rgb)
            yard = ref.quantised(*ref.serve(hm, sr, x, rgb, dtype)[:2])
            for h_u16, b_u8 in outs:
                check.add(h_u16, b_u8, h_ref, p_ref, *yard)
    finally:
        common.restore_tf32(old)
    return check


def control_readings(cfg, hm_state, sr_state, pool, pool_idx, dev,
                     tr_dtype="bfloat16") -> dict:
    """The control: the reference with float8 operands (``set_fp8``) put
    in the program's place on the pool batches ``pool_idx``, its outputs
    quantised as the port's, compared as the program's are."""
    hm, sr = ref.build(cfg)
    hm.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    hm, sr = ref.set_fp8(hm.to(dev)), ref.set_fp8(sr.to(dev))
    old = common.tf32(False)
    try:
        kept = {p: [ref.quantised(*ref.serve(
                    hm, sr, pool[p].to(dev), tuple(cfg["model"]["rgb_idx"]))[:2])]
                for p in pool_idx}
    finally:
        common.restore_tf32(old)
    del hm, sr
    return reference_check(cfg, hm_state, sr_state, pool, kept, dev,
                           DTYPES[tr_dtype]).readings()


def control(ctx, out) -> dict:
    """The control's readings on the pool batches a run checked."""
    hm_state, sr_state, pool, _ = out["state"]
    return control_readings(ctx.config, hm_state, sr_state, pool,
                            out["checked_pool"], ctx.device,
                            ctx.traffic["dtype"])


def faults(ctx, out) -> dict:
    """The readings of the serving faults, planted in the program's kept
    maps of a run: ``one_tile`` (one tile's heights +3 m) and
    ``half_batch`` (each checked request's second half of tiles given the
    first half's maps)."""
    hm_state, sr_state, pool, by_pool = out["state"]
    cfg, dev, dtype = ctx.config, ctx.device, DTYPES[ctx.traffic["dtype"]]

    def one_tile(k, h, b):
        if k:
            return h, b
        h = h.to(torch.int32)
        h[0] += 30
        return h.to(torch.uint16), b

    def half_batch(k, h, b):
        n = (h.shape[0] + 1) // 2
        return (torch.cat([h[:n], h[:h.shape[0] - n]]),
                torch.cat([b[:n], b[:b.shape[0] - n]]))

    readings = {}
    for name, plant in (("one_tile", one_tile), ("half_batch", half_batch)):
        kept, k = {}, 0
        for p, outs in sorted(by_pool.items()):
            kept[p] = []
            for h, b in outs:
                kept[p].append(plant(k, h, b))
                k += 1
        readings[name] = reference_check(cfg, hm_state, sr_state, pool, kept,
                                         dev, dtype).readings()
    return readings


def run(ctx) -> dict:
    from srbh_tpu_torch.predict.predictor import make_city_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, n_pool = tr["batch"], tr["pool_batches"]
    model, sr = port_models(cfg, dev)
    hm_state, sr_state = flagship_weights(cfg, ctx.seed, dev)
    model.load_state_dict(hm_state)
    sr.load_state_dict(sr_state)
    step = make_city_step(model, sr, rgb_idx=tuple(cfg["model"]["rgb_idx"]),
                          dtype=DTYPES[tr["dtype"]], device=dev)
    pool = tile_pool(n_pool, batch, cfg, ctx.seed, dev)
    t = cfg["model"]["tile"]
    ring = [(common.host_buffer((batch, 4 * t, 4 * t), torch.uint16, dev),
             common.host_buffer((batch, 4 * t, 4 * t,
                                 cfg["model"]["chans_build"]), torch.uint8,
                                dev)) for _ in range(2)]
    checked = common.sample_indices(ctx.seed, 1, tr["checked_requests"],
                                    max(2 * tr["checked_requests"],
                                        int(2 * ctx.seconds)))
    kept = {j: tuple(common.host_buffer(b.shape, b.dtype, dev) for b in ring[0])
            for j in checked}

    # a traced run's spans and forward timers are on for the profiled
    # stretch alone: the other requests run as an untraced run's do
    spans = Spans() if ctx.trace else None
    timers = []

    def request(i, traced):
        h_out, b_out = kept.get(i, ring[i % 2])
        if not traced:
            x = pool[i % n_pool].to(dev, non_blocking=True)
            h, b = step(x)
            h_out.copy_(h, non_blocking=True)
            b_out.copy_(b, non_blocking=True)
            common.sync(dev)
            return
        with spans.span("request"):
            with spans.span("copy_in"):
                x = pool[i % n_pool].to(dev, non_blocking=True)
            with spans.span("step"):
                h, b = step(x)
            with spans.span("copy_out"):
                h_out.copy_(h, non_blocking=True)
                b_out.copy_(b, non_blocking=True)
            with spans.span("sync"):
                common.sync(dev)

    # warm-up: the one batch shape the traffic sends, untimed; a traced
    # run also starts the profiler once, whose first start takes seconds
    for w in range(tr["warmup_requests"]):
        x = pool[w % n_pool].to(dev)
        step(x)
    if ctx.trace:
        with Stretch():
            step(pool[0].to(dev))
    common.reset_peak(dev)

    def close_stretch():
        stretch.__exit__(None, None, None)
        for tm in timers:
            tm.remove()
        return time.perf_counter()

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    # the profiled stretch is timed from before the profiler starts to after
    # it stops (and has parsed its events), so that the rate of the other
    # requests leaves out all of the profiler's time
    lat, i, stretch, t_end, traced_s = [], 0, None, t0, 0.0
    trace_end = tr["trace_skip"] + tr["trace_units"]
    while True:
        if ctx.trace and i == tr["trace_skip"]:
            t_trace = time.perf_counter()
            timers = [ForwardTimer(sr, "sr_trunk"),
                      ForwardTimer(model, "height_model")]
            stretch = Stretch().__enter__()
        ts = time.perf_counter()
        request(i, stretch is not None and i < trace_end)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        i += 1
        if stretch is not None and i == trace_end:
            t_end = close_stretch()
            traced_s = t_end - t_trace
        if t_end - t0 >= ctx.seconds:
            break
    if stretch is not None and i < trace_end:
        t_end = close_stretch()
        traced_s = t_end - t_trace
    window = t_end - t0
    tiles_per_s = stats.rate(batch * i, window)
    peak = common.memory_peak(dev)

    record = {}
    if ctx.trace:
        red = stretch.reduce()
        fl = serve_flops(cfg, batch)
        n_traced = max(0, min(i, trace_end) - tr["trace_skip"])
        # the rate of the requests the profiler did not slow
        record = {"trace": red, "tiles_per_s": stats.rate(
                      batch * (i - n_traced), window - traced_s),
                  "flops": fl, "forward_ms": {tm.name: tm.ms() for tm in timers},
                  "batch": batch}

    del step, model, sr
    common.free(dev)
    done = {j: kept[j] for j in checked if j < i}
    by_pool = {}
    for j, outs in done.items():
        by_pool.setdefault(j % n_pool, []).append(outs)
    check = reference_check(cfg, hm_state, sr_state, pool, by_pool, dev,
                            DTYPES[tr["dtype"]])
    readings = check.readings() if done else {}
    correct, checks = common.judge(readings,
                                   common.limits(ctx.root, ctx.cell["name"]))
    notes = [f"requests {i}, checked {sorted(done)}, window {window:.3f} s",
             f"reference heights {check.stats() if done else None}",
             f"card {common.power_limit(dev)}"]
    return {"correct": correct and bool(done), "attempted": i,
            "failed": 0 if correct else len(done),
            "e2e": {"setup_s": setup_s, "serve_tiles_per_s": tiles_per_s,
                    "serve_p95_ms": 1e3 * stats.percentile(lat, 95)},
            "record": record, "memory_peak_bytes": peak, "checks": checks,
            "readings": readings, "checked_pool": sorted(by_pool),
            "state": (hm_state, sr_state, pool, by_pool),
            "notes": notes}
