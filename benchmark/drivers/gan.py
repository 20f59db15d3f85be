"""GAN finetuning: ``train_sr``'s loop over the port's objects.

Set-up writes ``pairs`` seeded LR / HR pairs (``synth/pairs.py``), builds
``LRHRPairDataset`` over them, the port's ``DataLoader`` (``num_workers``
processes, shuffled from the seed, ``drop_last``, batches copied to the
card) and ``RealESRGANTrainer``'s state with the benchmark's seeded weights
(``trainer.init(g_state=, d_state=, vgg_state=)``), then drives that state
through its first ``checked_steps`` steps with the window's own call and
feed (the first step tunes cuDNN inside the step's own scope). Those steps
are what the check compares: each step's five losses, the first gradient
as Adam took it (its first moment after one step over 1 - beta1) and each
tensor's change over the steps, against ``reference/gan.py`` run from the
same weights on the same rows. The same state and loader then run back to
back, epoch after epoch, for the window; the rate counts the tiles of every
whole step over the window's time, ended by a synchronise.

Traffic keys: ``pairs``, ``num_workers``, ``checked_steps``,
``trace_skip`` / ``trace_units`` (the profiled stretch, in steps).
"""
from __future__ import annotations

import gc
import shutil
import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.harness import counts, env, stats
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Stretch
from benchmark.harness.weights import seeded_state
from benchmark.reference import gan as ref
from benchmark.synth import pairs as synth


def reference_modules(cfg: dict) -> tuple:
    """(G, D, VGG19) of the reference, on the default device."""
    n = cfg["model"]
    g, d = n["generator"], n["discriminator"]
    return (ref.RRDBNet(g["num_in_ch"], g["num_out_ch"], g["num_feat"],
                        g["num_block"], g["num_grow_ch"]),
            ref.UNetDiscriminatorSN(g["num_out_ch"], d["num_feat"]),
            ref.VGG19Features())


def gan_weights(cfg: dict, seed: int, dev) -> tuple:
    """(G, D, VGG19) state dicts drawn on ``dev`` from the seed, with the
    port's names (taken from the reference modules on the meta device)."""
    with torch.device("meta"):
        nets = reference_modules(cfg)
    template = {p + k: v for p, net in zip(("g.", "d.", "v."), nets)
                for k, v in net.state_dict().items()}
    w = cfg["weights"]
    state = seeded_state(template, seed, dev, gains=w["gains"],
                         default_gain=w["default_gain"],
                         bias_std=w["bias_std"], constants=w["constants"])
    return tuple({k[2:]: v for k, v in state.items() if k.startswith(p)}
                 for p in ("g.", "d.", "v."))


def step_flops(cfg: dict) -> int:
    """Operations of one step of the reference on the meta device: the
    generator's forward and backward, the discriminator's three forwards
    and the backwards they need, VGG19's two forwards and the backward
    through one, USM."""
    t = cfg["model"]["train"]
    with torch.device("meta"):
        states = [net.state_dict() for net in reference_modules(cfg)]
        gs = ref.GANStep(cfg, *states, "meta")
        lq = torch.empty(t["batch"], 3, t["lq"], t["lq"])
        gt = torch.empty(t["batch"], 3, t["gt"], t["gt"])
    return counts.step_flops(gs.step, lq, gt, as_tensors=True)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The loader's shuffle of epoch ``epoch``: ``default_rng(seed +
    epoch)`` over ``arange(n)``, as BasicSR's sampler is re-seeded each
    epoch."""
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-12)


def _objective_gaps(prog_losses, ref_losses) -> list:
    """Each step's worst relative gap of its two objectives, the
    generator's total (L1 + perceptual + GAN) and the discriminator's (real
    + fake); infinite for a step the program lacks."""
    def totals(ls):
        return [(l["l_g_pix"] + l["l_g_percep"] + l["l_g_gan"],
                 l["l_d_real"] + l["l_d_fake"]) for l in ls]

    gaps = [max(_rel(p, r) for p, r in zip(pt, rt))
            for pt, rt in zip(totals(prog_losses), totals(ref_losses))]
    return gaps + [float("inf")] * (len(ref_losses) - len(gaps))


def _moved(refr) -> tuple:
    """(parameters, tensors of ``change``) that count: those whose reference
    gradient in the first step is at least a thousandth of the median
    leaf's (the EMA's by their generator tensor's)."""
    g_ref = refr["grad1"]
    med = float(np.median(list(g_ref.values())))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    keep = [k for k in refr["change"] if
            (k[4:] if k.startswith("ema.") else k) in moved
            or ("g." + k[4:]) in moved]
    return moved, keep


def readings(prog: dict, refr: dict) -> dict:
    """The numbers compared, from each side's record: ``losses`` (one dict
    of the five a step), ``grad1`` (norms of the first gradients) and
    ``change`` (norms of each tensor's change over the checked steps).

    * ``loss1_gap``: the worst relative gap of the first step's two
      objectives (:func:`_objective_gaps`); ``loss_gap``: the same over
      every checked step. (A single small loss, the discriminator's on
      confident fakes, reads its logits' absolute error as a relative one;
      the totals are steady from seed to seed.)
    * ``grad_err``: the relative error of the first gradient itself,
      ``|g_prog - g_ref| / |g_ref|`` over every tensor of a network, the
      worse of G's and D's (the norms' gaps below are a second-order
      measure, and separate neither the control nor half a batch);
    * ``grad_gap``, ``change_gap``: the worst leaf (``worst_leaf``).
      Leaves whose reference gradient is under a thousandth of the median
      leaf's move by round-off alone and are left out of both
      (:func:`_moved`).

    ``loss1_each`` (not compared) is the worst relative gap of the first
    step's five losses one by one."""
    gaps = _objective_gaps(prog["losses"], refr["losses"])
    each = max(_rel(prog["losses"][0][k], r)
               for k, r in refr["losses"][0].items())
    moved, keep = _moved(refr)
    grad_gap = ref.worst_leaf(prog["grad1"], refr["grad1"], moved)
    change_gap = ref.worst_leaf(prog["change"], refr["change"], keep)
    grad_err = 0.0
    for net in ("g.", "d."):
        names = [k for k in moved if k.startswith(net)]
        if any(k not in prog["grad1_t"] for k in names):
            grad_err = float("inf")
            break
        diff = sum(float((prog["grad1_t"][k].double()
                          - refr["grad1_t"][k].double()).pow(2).sum())
                   for k in names)
        base = sum(float(refr["grad1_t"][k].double().pow(2).sum())
                   for k in names)
        grad_err = max(grad_err, (diff / max(base, 1e-300)) ** 0.5)
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
            "grad_err": grad_err, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "loss1_each": each}


def window_readings(prog: dict, refr: dict) -> dict:
    """The numbers compared of the window's sampled steps, each side's
    record holding ``losses`` and ``change`` from the same state:
    ``window_loss_gap`` (the worst step's objectives, as ``loss_gap``) and
    ``window_change_gap`` (as ``change_gap``, the leaves chosen by the
    reference's gradient of the sample's first step)."""
    _, keep = _moved(refr)
    return {"window_loss_gap": max(_objective_gaps(prog["losses"],
                                                   refr["losses"])),
            "window_change_gap": ref.worst_leaf(prog["change"],
                                                refr["change"], keep)}


def snapshot(state) -> dict:
    """Device copies of the program's train state, in the form
    ``reference.gan.GANStep.load_state`` takes (``t`` as tensors)."""
    snap = {"g": {k: v.detach().clone()
                  for k, v in state.net_g.state_dict().items()},
            "d": {k: v.detach().clone()
                  for k, v in state.net_d.state_dict().items()},
            "ema": {k: v.detach().clone()
                    for k, v in state.g_ema.named_parameters()},
            "m": {}, "v": {}, "t": {}}
    for pre, net, opt in (("g.", state.net_g, state.opt_g),
                          ("d.", state.net_d, state.opt_d)):
        for name, p in net.named_parameters():
            st = opt.state.get(p)
            if st:
                snap["m"][pre + name] = st["exp_avg"].detach().clone()
                snap["v"][pre + name] = st["exp_avg_sq"].detach().clone()
                snap["t"][pre] = torch.as_tensor(st["step"]).detach().clone()
    return snap


def trained(state) -> dict:
    """Device copies of every trained tensor: ``g.*``, ``d.*``, ``ema.*``."""
    out = {pre + k: v.detach().clone()
           for pre, net in (("g.", state.net_g), ("d.", state.net_d))
           for k, v in net.named_parameters()}
    out.update({"ema." + k: v.detach().clone()
                for k, v in state.g_ema.named_parameters()})
    return out


def reference_record(cfg, states, batches, dev, dtype=torch.float32,
                     snap=None) -> dict:
    """The reference's record over ``batches`` (lq, gt) from ``states``, or
    from the program's train state ``snap`` (:func:`snapshot`)."""
    old = common.tf32(False)
    try:
        gs = ref.GANStep(cfg, *states, dev, dtype=dtype)
        if snap is not None:
            gs.load_state(snap)
        p0 = {k: v.clone() for k, v in gs.params().items()}
        losses, grad1_t = [], None
        for k, (lq, gt) in enumerate(batches):
            losses.append(gs.step(lq.to(dev), gt.to(dev)))
            if k == 0:
                grad1_t = {n: g.clone() for n, g in gs.grads.items()}
        p3 = gs.params()
        change = norms({k: p3[k] - p0[k] for k in p3})
    finally:
        common.restore_tf32(old)
    return {"losses": losses, "grad1": norms(grad1_t), "grad1_t": grad1_t,
            "change": change}


def run(ctx) -> dict:
    from srbh_tpu_torch.data.dataset import LRHRPairDataset
    from srbh_tpu_torch.data.pipeline import DataLoader
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, t = cfg["model"], cfg["model"]["train"]
    g, d = n["generator"], n["discriminator"]
    batch = t["batch"]
    marks = [("imports", time.perf_counter())]
    lq_u16, gt_u8 = synth.make(tr["pairs"], t["lq"], ctx.seed, dev)
    root = env.scratch_dir(ctx.cell["name"])
    files = synth.write(root, lq_u16, gt_u8)
    marks.append(("pairs", time.perf_counter()))
    states = gan_weights(cfg, ctx.seed, dev)
    marks.append(("weights", time.perf_counter()))

    trainer = RealESRGANTrainer(
        out_ch=g["num_out_ch"], num_block=g["num_block"], scale=g["scale"],
        num_feat=g["num_feat"], num_grow_ch=g["num_grow_ch"],
        ema_decay=t["ema_decay"], lr=t["lr"], gan_weight=t["gan_weight"],
        disc_feat=d["num_feat"], l1_gt_usm=t["l1_gt_usm"],
        percep_gt_usm=t["percep_gt_usm"], gan_gt_usm=t["gan_gt_usm"])
    state = trainer.init(ctx.seed, (batch, t["lq"], t["lq"], 3),
                         g_state=states[0], d_state=states[1],
                         vgg_state=states[2], device=dev)
    marks.append(("trainer_init", time.perf_counter()))
    dataset = LRHRPairDataset(files["datalist"], files["rootname"],
                              files["datastats"], normmethod="minmax",
                              s2dir="s2", gedir="ge", nchans=3)
    loader_seed = ctx.seed % (2**31)
    loader = DataLoader(dataset, batch_size=batch, shuffle=True,
                        num_workers=tr["num_workers"], seed=loader_seed,
                        drop_last=True, device_put=True, device=dev)
    step = trainer.make_step()
    spans = Spans() if ctx.trace else None

    def batches():
        while True:
            for b in loader:
                yield b

    feed = batches()
    if spans is not None:
        feed = spans.wrap_iter("loader_wait", feed)
        step = spans.wrap(name="step", fn=step)

    # the checked steps: the window's call and feed, on the seed's first
    # rows; recorded from the state the window then goes on with
    b1 = t["betas"][0]
    prog = {"losses": []}
    nets = {"g.": state.net_g, "d.": state.net_d}
    opts = {"g.": state.opt_g, "d.": state.opt_d}
    for k in range(tr["checked_steps"]):
        b = next(feed)
        m = step(state, b["lq"], b["gt"])
        prog["losses"].append({key: float(m[key]) for key in (
            "l_g_pix", "l_g_percep", "l_g_gan", "l_d_real", "l_d_fake")})
        if k == 0:
            prog["grad1_t"] = {
                pre + name: opts[pre].state[p]["exp_avg"] / (1 - b1)
                for pre, net in nets.items()
                for name, p in net.named_parameters()
                if p in opts[pre].state}
            prog["grad1"] = norms(prog["grad1_t"])
        common.sync(dev)
        marks.append((f"step{k + 1}", time.perf_counter()))
    after = trained(state)
    before = {**{"g." + k: v for k, v in states[0].items()},
              **{"d." + k: v for k, v in states[1].items()},
              **{"ema." + k: v for k, v in states[0].items()}}
    prog["change"] = norms({k: after[k] - before[k] for k in after
                            if k in before})
    del after
    if ctx.trace:
        with Stretch():
            step(state, *(lambda b: (b["lq"], b["gt"]))(next(feed)))
    common.sync(dev)
    common.reset_peak(dev)

    # the window's checked sample: steps s0 .. s0 + k_win - 1 of the window,
    # fed batches n_setup + s0 .. of the loader
    wc = tr["window_check"]
    s0 = wc["from"] + common.sample_indices(ctx.seed, 4, 1,
                                            wc["below"] - wc["from"])[0]
    k_win, n_setup = wc["steps"], tr["checked_steps"] + int(ctx.trace)
    win = {"losses": [], "batches": []}

    def one_step(k):
        if k == s0:
            win["before"] = snapshot(state)
        b = next(feed)
        m = step(state, b["lq"], b["gt"])
        if s0 <= k < s0 + k_win:
            win["losses"].append({key: m[key].detach() for key in refr_keys})
            win["batches"].append(n_setup + k)
            if k == s0 + k_win - 1:
                win["after"] = trained(state)

    refr_keys = ("l_g_pix", "l_g_percep", "l_g_gan", "l_d_real", "l_d_fake")
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    steps, stretch, traced_s = 0, None, 0.0
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and steps == tr["trace_skip"]:
            common.sync(dev)
            t_trace = time.perf_counter()
            stretch = Stretch().__enter__()
        one_step(steps)
        steps += 1
        if stretch is not None and steps == tr["trace_skip"] + tr["trace_units"]:
            stretch.__exit__(None, None, None)
            traced_s = time.perf_counter() - t_trace
    common.sync(dev)
    window = time.perf_counter() - t0
    if stretch is not None and not traced_s:
        stretch.__exit__(None, None, None)
        traced_s = time.perf_counter() - t_trace
    peak = common.memory_peak(dev)
    late = 0
    while steps + late < s0 + k_win:
        one_step(steps + late)
        late += 1
    feed.close()
    record = {}
    if ctx.trace:
        n_traced = max(0, min(steps, tr["trace_skip"] + tr["trace_units"])
                       - tr["trace_skip"])
        record = {"trace": stretch.reduce(),
                  "steps_per_s": stats.rate(steps - n_traced,
                                            window - traced_s),
                  "step_flops": step_flops(cfg),
                  "loader_wait_s": spans.seconds["loader_wait"][
                      n_setup:n_setup + steps]}
    del state, trainer, loader, step, feed
    gc.collect()
    common.free(dev)
    shutil.rmtree(root, ignore_errors=True)

    rows = [epoch_order(len(lq_u16), loader_seed, 0)[k * batch:(k + 1) * batch]
            for k in range(tr["checked_steps"])]
    lq_all, gt_all = synth.normalised(lq_u16, gt_u8)
    fed = [(lq_all[r], gt_all[r]) for r in rows]
    refr = reference_record(cfg, states, fed, dev)
    reads = readings(prog, refr)
    spe = len(lq_u16) // batch
    win_fed = []
    for j in win["batches"]:
        r = epoch_order(len(lq_u16), loader_seed, j // spe)[
            (j % spe) * batch:(j % spe + 1) * batch]
        win_fed.append((lq_all[r], gt_all[r]))
    snap = win["before"]
    snap["t"] = {k: int(float(v)) for k, v in snap["t"].items()}
    w_before = {**{"g." + k: snap["g"][k] for k in snap["g"]},
                **{"d." + k: snap["d"][k] for k in snap["d"]},
                **{"ema." + k: v for k, v in snap["ema"].items()}}
    wprog = {"losses": [{k: float(v) for k, v in ls.items()}
                        for ls in win["losses"]],
             "change": norms({k: v - w_before[k]
                              for k, v in win.pop("after").items()})}
    refr_w = reference_record(cfg, states, win_fed, dev, snap=snap)
    reads.update(window_readings(wprog, refr_w))
    correct, checks = common.judge(reads, common.limits(ctx.root,
                                                        ctx.cell["name"]))
    parts = ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                      in zip(marks, marks[1:]))
    notes = [f"steps {steps}, window {window:.3f} s, window check at steps "
             f"{s0}-{s0 + k_win - 1} ({late} after the window)",
             f"set-up: process start to driver {marks[0][1] - ctx.t_start:.2f}"
             f" s, {parts}, rest {t0 - marks[-1][1]:.2f} s",
             f"readings {reads}",
             f"reference losses {refr['losses']}",
             f"program losses {prog['losses']}",
             f"card {common.power_limit(dev)}"]
    return {"correct": correct,
            "attempted": steps + late + n_setup,
            "failed": 0 if correct else tr["checked_steps"] + k_win,
            "e2e": {"setup_s": setup_s,
                    "train_tiles_per_s": stats.rate(batch * steps, window)},
            "record": record, "memory_peak_bytes": peak, "checks": checks,
            "readings": reads, "notes": notes,
            "state": (states, fed, refr, win_fed, snap, refr_w)}


def control(ctx, out) -> dict:
    """The control: the reference under bfloat16 autocast in the program's
    place, read against the float32 reference, over the set-up's steps and
    the window's sample."""
    states, fed, refr, win_fed, snap, refr_w = out["state"]
    ctl = reference_record(ctx.config, states, fed, ctx.device,
                           dtype=torch.bfloat16)
    ctl_w = reference_record(ctx.config, states, win_fed, ctx.device,
                             dtype=torch.bfloat16, snap=snap)
    return {**readings(ctl, refr), **window_readings(ctl_w, refr_w)}


def faults(ctx, out) -> dict:
    """The readings of the training faults, planted in the reference put in
    the program's place, over the set-up's steps and the window's sample:
    ``half_batch`` (each step on the first half of its rows, its losses the
    mean over them) and ``unchanged`` (a step that leaves the state as it
    was: no change, no moment)."""
    states, fed, refr, win_fed, snap, refr_w = out["state"]

    def half(batches):
        return [(lq[:len(lq) // 2], gt[:len(gt) // 2]) for lq, gt in batches]

    rec = reference_record(ctx.config, states, half(fed), ctx.device)
    rec_w = reference_record(ctx.config, states, half(win_fed), ctx.device,
                             snap=snap)
    out = {"half_batch": {**readings(rec, refr),
                          **window_readings(rec_w, refr_w)}}
    still = {"losses": refr["losses"], "grad1": {}, "grad1_t": {},
             "change": {k: 0.0 for k in refr["change"]}}
    still_w = {"losses": refr_w["losses"],
               "change": {k: 0.0 for k in refr_w["change"]}}
    out["unchanged"] = {**readings(still, refr),
                        **window_readings(still_w, refr_w)}
    return out
