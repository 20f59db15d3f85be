"""SR serving: a closed loop of one client sending batches of RGB tiles
through the port's SwinIR harness, ``tools/swinir_harness.py``.

The model is the configuration's preset built by ``define_model`` with the
benchmark's seeded weights loaded by ``load_state_dict``. Each request takes
one batch of the traffic's ``batch`` NHWC float32 tiles in [0, 1] from a
pool of ``pool_batches`` seeded batches in pinned host memory, copies it to
the card, runs ``apply`` (the NHWC forward that ``tiled_inference``,
``run_folder`` and ``main`` use), copies the (batch, 4 t, 4 t, 3) float32
output into pinned host memory and synchronises once. A request's latency
is that whole span; the rate counts every tile of every request over the
whole window.

On a card every window attention launches the Hopper kernel: a request
whose forward does not add one to ``window_attention.launches`` a Swin
block is a failed request and fails the run (``launch_misses``, limit 0).
On the CPU the plain version runs and the count to expect is 0.

``checked_requests`` request indices, drawn from the seed, keep their
outputs apart, and the input and output of two Swin blocks
(:func:`tapped_blocks`); once the window has closed and the program is
freed, the reference (``reference/swinir.py``) recomputes those batches in
float32 with TF32 off (the truth) and at the configuration's TF32 defaults
(the yardstick: on a card cuDNN's TF32 convolutions, elsewhere the
reference's emulation of them). ``sr_tile_ratio``: the program's worst tile
by RMS error against the truth over the yardstick's worst tile. The TF32
convolutions' error in the residual stream hides any lower precision of
the blocks' linears there, at the output as at the body's features; so
``sr_block_err`` holds the blocks to float32 alone: the reference
recomputes each tapped block from the program's own input, and the reading
is the worst tile's RMS error of the block's output over the RMS of the
block's change to its input.

Traffic keys: ``batch``, ``pool_batches``, ``warmup_requests``,
``checked_requests``, ``trace_skip`` / ``trace_units`` (the profiled
stretch of a traced run, in requests).
"""
from __future__ import annotations

import contextlib
import fnmatch
import time

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.drivers import common
from benchmark.harness import stats, swin_counts
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import seeded_state
from benchmark.reference import swinir as ref

KERNEL = "window_attention_kernel"


def swin_weights(cfg: dict, seed: int, dev) -> dict:
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
        elif isinstance(m, ref.WindowAttention):
            k = name + ".relative_position_bias_table"
            state[k] = w["position_bias_std"] * state[k]
    return state


def port_model(cfg: dict, state: dict, dev):
    """The configuration's preset through ``swinir_harness.define_model`` on
    ``dev``, with ``state`` loaded."""
    from srbh_tpu_torch.tools import swinir_harness

    m = cfg["model"]
    model = swinir_harness.define_model(m["task"], m["scale"],
                                        large_model=m["large_model"],
                                        device=dev)
    model.load_state_dict(state)
    return model


def unshift(model):
    """A fault: the first shifted block of the middle RSTB run unshifted (no
    roll, no mask)."""
    layer = model.layers[len(model.layers) // 2]
    block = next(b for b in layer.residual_group.blocks if b.shift_size)
    block.shift_size = 0
    return model


def tile_pool(n: int, batch: int, cfg: dict, seed: int, dev) -> torch.Tensor:
    """``n`` batches of NHWC RGB tiles in [0, 1], drawn on ``dev`` from the
    seed and kept in (pinned) host memory: a smooth luminance field with
    rectangular patches (edges), each tile its own tint and brightness, and
    a little pixel noise, as a Sentinel-2 true-colour composite."""
    t, k, m = cfg["model"]["tile"], 6, n * batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed ^ 0x5A1E)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(lo, hi):
        return torch.randint(lo, hi, (m, k, 1, 1), generator=gen, device=dev)

    field = F.interpolate(rand(m, 1, 5, 5), size=(t, t), mode="bilinear",
                          align_corners=True)
    y0, x0, hh, ww = randint(0, t), randint(0, t), randint(3, 20), randint(3, 20)
    ys = torch.arange(t, device=dev).view(1, 1, t, 1)
    xs = torch.arange(t, device=dev).view(1, 1, 1, t)
    inside = ((ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww))
    patches = (inside.float() * (0.6 * rand(m, k, 1, 1) - 0.3)).sum(1, True)
    lum = 0.6 * field + patches
    rgb = 0.1 * rand(m, 1, 1, 1) + (0.8 + 0.4 * rand(m, 3, 1, 1)) * lum
    rgb = (rgb + 0.03 * (rand(m, 3, t, t) - 0.5)).clamp(0, 1)
    x = rgb.permute(0, 2, 3, 1).reshape(n, batch, t, t, 3)
    host = common.host_buffer(x.shape, torch.float32, dev)
    host.copy_(x)
    return host


def tapped_blocks(model) -> list:
    """The Swin blocks whose every forward a checked request keeps: the
    first two of the middle RSTB (one unshifted, one shifted and masked),
    the port's or the reference's (the same state-dict path)."""
    return list(model.layers[len(model.layers) // 2].residual_group
                .blocks[:2])


@contextlib.contextmanager
def block_tap(model, into: list):
    """Append to ``into`` an (input, output) float32 copy of each forward of
    the :func:`tapped_blocks` of ``model``, on the model's device."""
    hooks = [b.register_forward_hook(
        lambda _m, args, out: into.append((args[0].float().clone(),
                                           out.float().clone())))
             for b in tapped_blocks(model)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def with_blocks(forward, model, x) -> tuple:
    """(output, the tapped blocks' (input, output) pairs) of
    ``forward(model, x)``."""
    got = []
    with block_tap(model, got):
        out = forward(model, x)
    return out, got


class TileCheck:
    """Each tile's mean square error against the truth, of the program and
    of the yardstick (float64, on the host), at the output; and each tile's
    relative RMS error of the tapped blocks' outputs against the
    reference's blocks in float32 from the same inputs."""

    def __init__(self):
        self.sq = {"p": [], "y": []}
        self.truth = []
        self.block = []

    @staticmethod
    def _tile_sq(a, truth):
        d = a.cpu().double() - truth.cpu().double()
        return d.pow(2).flatten(1).mean(1)

    def add(self, prog, truth, yard):
        self.sq["p"].append(self._tile_sq(prog, truth))
        self.sq["y"].append(self._tile_sq(yard, truth))
        self.truth.append(truth.cpu().double().flatten())

    def add_block(self, x, out, ref_out):
        """A tapped block's input ``x``, its output and the reference's
        output from ``x``: each tile's error over the size of the block's
        own change to it (its attention and MLP branches)."""
        err = self._tile_sq(out, ref_out)
        size = self._tile_sq(ref_out, x)
        self.block.append((err / size.clamp_min(1e-300)).sqrt())

    def _worst(self, key) -> float:
        return float(torch.cat(self.sq[key]).max()) ** 0.5

    def readings(self) -> dict:
        out = {"sr_tile_ratio": self._worst("p") / max(self._worst("y"),
                                                       1e-30)}
        if self.block:
            out["sr_block_err"] = float(torch.cat(self.block).max())
        return out

    def stats(self) -> dict:
        t = torch.cat(self.truth)
        return {"tiles": int(torch.cat(self.sq["p"]).numel()),
                "truth_mean": float(t.mean()), "truth_std": float(t.std()),
                "rms": float(torch.cat(self.sq["p"]).mean()) ** 0.5,
                "yardstick_rms": float(torch.cat(self.sq["y"]).mean()) ** 0.5,
                "yardstick_worst_tile": self._worst("y"),
                "block_err_median": (float(torch.cat(self.block).median())
                                     if self.block else None)}


@contextlib.contextmanager
def tf32_flags(cudnn: bool, matmul: bool):
    old = common.tf32(False)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        common.restore_tf32(old)


def reference(cfg: dict, state: dict, dev):
    model = ref.build(cfg).eval()
    model.load_state_dict(state)
    return model.to(dev)


def yardstick(model, x, dev):
    """The reference at the configuration's TF32 defaults: cuDNN's TF32
    convolutions on a card, their emulation elsewhere."""
    if dev.type == "cuda":
        with tf32_flags(cudnn=True, matmul=False):
            return ref.nhwc(model, x)
    ref.set_tf32(model, True)
    try:
        with tf32_flags(False, False):
            return ref.nhwc(model, x)
    finally:
        ref.set_tf32(model, False)


def reference_check(cfg, state, pool, kept, dev) -> TileCheck:
    """Recompute the pool batches of the kept requests with the reference
    and compare; ``kept`` maps a pool index to a list of the program's
    (output, tapped blocks' (input, output) pairs) of that batch. The
    tapped blocks are recomputed from the program's own inputs in float32
    with TF32 off: they hold no convolution, so there the configuration's
    precision is float32's."""
    model = reference(cfg, state, dev)
    blocks = tapped_blocks(model)
    check = TileCheck()
    for p, outs in sorted(kept.items()):
        x = pool[p].to(dev)
        with tf32_flags(False, False):
            truth = ref.nhwc(model, x)
        yard = yardstick(model, x, dev)
        for out, pairs in outs:
            check.add(out, truth, yard)
            for (xin, xout), block in zip(pairs, blocks):
                with tf32_flags(False, False), torch.no_grad():
                    check.add_block(xin, xout, block(xin.to(dev)))
    return check


def _readings(check, misses=0) -> dict:
    return {**check.readings(), "launch_misses": misses}


def _in_place(cfg, state, pool, pool_idx, dev, forward) -> dict:
    """The readings with ``forward(model, x)`` of the reference put in the
    program's place on the pool batches ``pool_idx``."""
    model = reference(cfg, state, dev)
    kept = {}
    for p in pool_idx:
        out, pairs = with_blocks(forward, model, pool[p].to(dev))
        kept[p] = [(out.float(), pairs)]
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
    :func:`unshift` planted) and, beside them, the TF32-matmul control
    (``tf32_matmul``: the reference with cuBLAS's TF32 on too, in the
    program's place; the same as the truth off a card)."""
    from srbh_tpu_torch.tools import swinir_harness

    state, pool, by_pool = out["state"]
    cfg, dev = ctx.config, ctx.device
    readings = {}
    kept, first = {}, True
    for p, outs in sorted(by_pool.items()):
        kept[p] = []
        for o, pairs in outs:
            o = o.clone()
            if first:
                o[0] += 0.01
                first = False
            kept[p].append((o, pairs))
    readings["one_tile"] = _readings(reference_check(cfg, state, pool, kept,
                                                     dev))
    model = unshift(port_model(cfg, state, dev))
    kept = {}
    for p in by_pool:
        out, pairs = with_blocks(swinir_harness.apply, model,
                                 pool[p].to(dev))
        kept[p] = [(out.float(), pairs)]
    del model
    common.free(dev)
    readings["unshifted_block"] = _readings(reference_check(
        cfg, state, pool, kept, dev))

    def tf32_matmul(model, x):
        with tf32_flags(cudnn=True, matmul=True):
            return ref.nhwc(model, x)

    readings["tf32_matmul"] = _in_place(cfg, state, pool, sorted(by_pool),
                                        dev, tf32_matmul)
    return readings


def kernel_seconds(events, name: str) -> tuple:
    """(device seconds, count) of the kernels whose name holds ``name``."""
    from torch.autograd import DeviceType
    ks = [e for e in events if e.device_type == DeviceType.CUDA
          and name in e.name]
    return (sum((e.time_range.end - e.time_range.start) / 1e6 for e in ks),
            len(ks))


class Phases:
    """The set-up's phases on the host's clock, from the process's start."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.s = {}

    def mark(self, name: str):
        t = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + t - self.t
        self.t = t

    def __str__(self):
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.s.items())


# the port's ranges whose kernels a traced run sums (``srbh.`` + span name)
RANGES = ("swinir.body", "swinir.upsample")


def range_kernel_ms(events, names) -> dict:
    """Span name -> the device milliseconds of the kernels launched inside
    each of the port's ranges of that name in the trace, oldest first
    (empty where the port opens no such span)."""
    from torch.autograd import DeviceType
    out = {n: [] for n in names}
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name.startswith("srbh.")
                and e.name[5:] in out):
            out[e.name[5:]].append(e.device_time_total / 1e3)
    return out


def unlinked_kernel_ms(events, name: str) -> float:
    """Device milliseconds of the kernels whose name holds ``name`` that
    the trace links to no operation: the hand kernel's launches go through
    ctypes, outside any PyTorch operation, so no range counts them."""
    from torch.autograd import DeviceType
    linked = sum(k.duration for e in events if e.device_type == DeviceType.CPU
                 for k in e.kernels if name in k.name)
    return kernel_seconds(events, name)[0] * 1e3 - linked / 1e3


def run(ctx) -> dict:
    from srbh_tpu_torch.ops.window_attention import window_attention
    from srbh_tpu_torch.tools import swinir_harness

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, n_pool = tr["batch"], tr["pool_batches"]
    phases = Phases(ctx.t_start)
    phases.mark("start")
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        common.sync(dev)
        phases.mark("cuda init")
    state = swin_weights(cfg, ctx.seed, dev)
    phases.mark("weights")
    model = port_model(cfg, state, dev)
    phases.mark("model")
    per_forward = sum(cfg["model"]["depths"]) if dev.type == "cuda" else 0
    pool = tile_pool(n_pool, batch, cfg, ctx.seed, dev)
    side = cfg["model"]["upscale"] * cfg["model"]["tile"]
    shape = (batch, side, side, cfg["model"]["out_chans"])
    ring = [common.host_buffer(shape, torch.float32, dev) for _ in range(2)]
    checked = common.sample_indices(ctx.seed, 1, tr["checked_requests"],
                                    max(2 * tr["checked_requests"],
                                        int(2 * ctx.seconds)))
    kept = {j: common.host_buffer(shape, torch.float32, dev) for j in checked}
    taps = {j: [] for j in checked}
    launches = []
    phases.mark("pool")

    # a traced run's spans are on for the profiled stretch alone: the
    # other requests run as an untraced run's do
    spans = Spans() if ctx.trace else None

    def request(i, traced):
        out = kept.get(i, ring[i % 2])
        n0 = window_attention.launches
        span = spans.span if traced else (lambda _: contextlib.nullcontext())
        with span("copy_in"):
            x = pool[i % n_pool].to(dev, non_blocking=True)
        with span("apply"), (block_tap(model, taps[i]) if i in taps
                             else contextlib.nullcontext()):
            y = swinir_harness.apply(model, x)
        with span("copy_out"):
            out.copy_(y, non_blocking=True)
        with span("sync"):
            common.sync(dev)
        launches.append(window_attention.launches - n0)

    # warm-up: the one batch shape the traffic sends (the kernel's first
    # use builds it), untimed; a traced run also starts the profiler once,
    # whose first start takes seconds
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
        request(i, stretch is not None and i < trace_end)
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
    misses = sum(n != per_forward for n in launches)

    record = {}
    if ctx.trace:
        n_traced = max(0, min(i, trace_end) - tr["trace_skip"])
        events = stretch.prof.events()
        kernel_s, kernels = kernel_seconds(events, KERNEL)
        # every window attention of a request runs inside the body
        ranges = range_kernel_ms(events, RANGES)
        hand_ms = unlinked_kernel_ms(events, KERNEL) / max(n_traced, 1)
        ranges["swinir.body"] = [ms + hand_ms for ms in ranges["swinir.body"]]
        record = {"trace": stretch.reduce(),
                  "tiles_per_s": stats.rate(batch * (i - n_traced),
                                            window - traced_s),
                  "counts": swin_counts.serve_counts(cfg, batch),
                  "traced_requests": n_traced, "attn_kernel_s": kernel_s,
                  "attn_kernels": kernels, "launches": launches,
                  "range_kernel_ms": ranges,
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
             f"kernel launches a request: {sorted(set(launches))} "
             f"(expected {per_forward})",
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
