"""Height-model training: ``train/trainer.py``'s loop over the port's
objects, at ``TrainConfig``'s defaults (batch 16, float32, ``isaggre`` and
``ishir``, lr 1e-3 with the step decay, weight decay 1e-4, host
augmentation, ``num_workers`` loader processes).

Set-up writes ``tiles`` seeded tiles in the dataset's on-disk form
(``synth/height_tiles.py``: S2, S1, heights, the list and the tables),
builds the trainer's train loader (``trainer.make_loader``: the shuffled,
augmented ``S12GlobeDataset`` over the port's ``DataLoader``, batches
copied to the card), its models (``trainer.build_models``) with the
benchmark's seeded flagship weights loaded (``serve.flagship_weights``,
the frozen RRDBNet and the height model), its ``TrainState`` and
``make_train_step``, then runs the first ``checked_steps`` steps with the
window's call and feed. Those steps are what the check compares: each
step's loss, the first gradient as Adam took it (its first moment after
one step over 1 - beta1) and each tensor's change over the steps, against
``reference/height_train.py`` run from the same weights on the same
batches (the loader's, kept on the card) at the program's own precision:
the TF32 switches the program ran with (PyTorch's defaults: cuDNN's TF32
convolutions on, cuBLAS's float32 matmuls), so the yardstick computes as
the program does and the gaps can be tight. The first batch is also
derived anew by ``reference/height_loader.py`` from the arrays the tiles
were written from (the tiles' reading, augmentation with the dataset's
draws, normalisation and targets) and compared with what the step
received. The same state and loader then run back to back, epoch after
epoch, at each epoch's learning rate, for the window; the rate counts the
tiles of every whole step over the window's time, ended by a synchronise.
Validation and checkpoints stay outside it.

The window's checked sample: a copy of the program's whole train state
(the model's tensors and BatchNorm statistics, the log-vars, Adam's
moments and counts, the step counter that seeds the drop-connect) taken
before a step drawn from the seed, and that step and the next ones' batches,
losses and changes; the reference follows them from the copy.

The model's sizes come from the configuration (``flagship_b4``'s are
``TrainConfig``'s defaults). Traffic keys: ``tiles``, ``batch``,
``num_workers``, ``checked_steps``,
``window_check`` (``steps``, ``from``, ``below``), ``trace_skip`` /
``trace_units`` (the profiled stretch, in steps).
"""
from __future__ import annotations

import gc
import math
import shutil
import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.drivers.serve import flagship_weights
from benchmark.harness import counts, env, stats
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Stretch
from benchmark.reference import flagship
from benchmark.reference import height_loader
from benchmark.reference import height_train as ref
from benchmark.reference.gan import worst_leaf
from benchmark.synth import height_tiles as synth

B1 = 0.9


def train_flops(cfg: dict, batch: int) -> int:
    """Operations of one step on the reference modules at the meta device:
    the frozen RRDBNet's forward, the height model's forward and the
    backward it needs (``FlopCounterMode``)."""
    t = cfg["model"]["tile"]
    with torch.device("meta"):
        hm, sr = flagship.build(cfg)
        hm.train()
        x = torch.empty(batch, cfg["model"]["in_chans"], t, t)

    def step():
        with torch.no_grad():
            fea = sr(x[:, :3], features_only=True)
        outs = hm(x, fea)
        sum(o.sum() for o in outs).backward()

    return counts.step_flops(step)


def norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-12)


def _moved(refr) -> list:
    """The leaves that count: those whose reference gradient in the first
    step is at least a thousandth of the median leaf's."""
    g = refr["grad1"]
    med = float(np.median(list(g.values())))
    return [k for k, v in g.items() if v >= 1e-3 * med]


def readings(prog: dict, refr: dict) -> dict:
    """The numbers compared, from each side's record: ``losses`` (a float a
    step), ``grad1_t`` / ``grad1`` (the first gradient Adam took and its
    norms) and ``change`` (norms of each tensor's change over the steps).

    * ``loss1_gap``: the first step's loss, relative gap; ``loss_gap``: the
      worst step's;
    * ``grad_err``: the relative error of the whole first gradient,
      ``|g_prog - g_ref| / |g_ref|`` over the leaves that count;
    * ``grad_gap``, ``change_gap``: the worst leaf's gap of its norm over
      the larger of its and the median leaf's (``gan.worst_leaf``), over
      the leaves whose reference gradient is at least a thousandth of the
      median leaf's (the others move by round-off alone)."""
    gaps = [_rel(p, r) for p, r in zip(prog["losses"], refr["losses"])]
    gaps += [math.inf] * (len(refr["losses"]) - len(gaps))
    moved = _moved(refr)
    if any(k not in prog["grad1_t"] for k in moved):
        grad_err = math.inf
    else:
        diff = sum(float((prog["grad1_t"][k].double()
                          - refr["grad1_t"][k].double()).pow(2).sum())
                   for k in moved)
        base = sum(float(refr["grad1_t"][k].double().pow(2).sum())
                   for k in moved)
        grad_err = (diff / max(base, 1e-300)) ** 0.5
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "grad_err": grad_err,
            "grad_gap": worst_leaf(prog["grad1"], refr["grad1"], moved),
            "change_gap": worst_leaf(prog["change"], refr["change"], moved)}


def worst_leaves(prog_norms: dict, refr: dict, key: str = "grad1",
                 n: int = 4) -> list:
    """The ``n`` leaves of the largest gaps (as ``grad_gap`` and
    ``change_gap`` read them), with the reference's norm: for the notes."""
    ref_norms, moved = refr[key], _moved(refr)
    med = float(np.median([ref_norms[k] for k in moved]))
    gaps = sorted(((abs(prog_norms.get(k, math.inf) - ref_norms[k])
                    / max(ref_norms[k], med), k) for k in moved),
                  reverse=True)[:n]
    return [(k, round(g, 4), ref_norms[k]) for g, k in gaps]


def window_readings(prog: dict, refr: dict) -> dict:
    """The window's sample, each side from the same state:
    ``window_loss1_gap`` (the first step's loss, computed from that state
    alone: a reading of the precision, as ``loss1_gap``),
    ``window_loss_gap`` (the worst step's loss: the later steps follow
    each side's updates) and ``window_change_gap`` (as ``change_gap``, the
    leaves chosen by the reference's gradient of the sample's first
    step)."""
    moved = _moved(refr)
    pairs = list(zip(prog["losses"], refr["losses"]))
    return {"window_loss1_gap": _rel(*pairs[0]),
            "window_loss_gap": max(_rel(p, r) for p, r in pairs),
            "window_change_gap": worst_leaf(prog["change"], refr["change"],
                                            moved)}


def loader_readings(fed: dict, want: dict) -> dict:
    """The first batch the step received against the reference's
    derivation: ``loader_image_err``, the image's largest absolute gap
    (the image is in [0, 1]); ``loader_target_miss``, the share of target
    elements (heights, classes, weights, at 256^2 and aggregated) that
    differ by more than 1e-5 of the larger of their value and 1. A key the
    batch lacks counts as missed whole."""
    img = fed.get("image")
    err = (math.inf if img is None else
           float((img.detach().cpu().double()
                  - torch.from_numpy(want["image"]).double()).abs().max()))
    miss = total = 0
    for k, r in want.items():
        if k == "image":
            continue
        r = torch.from_numpy(r).double()
        p = fed.get(k)
        total += r.numel()
        if p is None or tuple(p.shape) != tuple(r.shape):
            miss += r.numel()
            continue
        gap = (p.detach().cpu().double() - r).abs()
        miss += int((gap > 1e-5 * r.abs().clamp(min=1)).sum())
    return {"loader_image_err": err, "loader_target_miss": miss / total}


def precision() -> dict:
    """The TF32 switches as they stand (the program's precision)."""
    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


def trained(state) -> dict:
    """Device copies of every trained tensor, ``log_vars`` among them."""
    out = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    out["log_vars"] = state.log_vars.detach().clone()
    return out


def snapshot(state) -> dict:
    """Device copies of the program's train state, in the form
    ``reference.height_train.HeightTrainStep.load_state`` takes."""
    named = dict(state.model.named_parameters())
    named["log_vars"] = state.log_vars
    snap = {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "log_vars": state.log_vars.detach().clone(), "m": {}, "v": {},
            "adam_t": 0, "step": state.step}
    for name, p in named.items():
        st = state.optimizer.state.get(p)
        if st:
            snap["m"][name] = st["exp_avg"].detach().clone()
            snap["v"][name] = st["exp_avg_sq"].detach().clone()
            snap["adam_t"] = int(float(st["step"]))
    return snap


def grad1(state) -> dict:
    """The first gradient Adam took, weight decay included, by name: its
    first moment after one update over 1 - beta1."""
    named = dict(state.model.named_parameters())
    named["log_vars"] = state.log_vars
    return {k: state.optimizer.state[p]["exp_avg"] / (1 - B1)
            for k, p in named.items() if p in state.optimizer.state}


def _batch(b: dict) -> dict:
    """A device copy of the tensors of a loader batch."""
    return {k: v.detach().clone() for k, v in b.items()
            if isinstance(v, torch.Tensor)}


def reference_record(cfg, tcfg, states, batches, lrs, dev, tf32: dict,
                     dtype=torch.float32, snap=None) -> dict:
    """The reference's record over ``batches`` at ``lrs`` from ``states``,
    or from the program's train state ``snap`` (:func:`snapshot`), with
    the TF32 switches ``tf32`` (``{"cudnn": .., "matmul": ..}``)."""
    old = common.tf32(False)
    common.restore_tf32(tf32)
    try:
        rs = ref.HeightTrainStep(cfg, *states, dev, seed=tcfg.seed,
                                 lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                                 dtype=dtype)
        if snap is not None:
            rs.load_state(snap)
        p0 = {k: v.clone() for k, v in rs.params().items()}
        losses, g1 = [], None
        for k, (b, lr) in enumerate(zip(batches, lrs)):
            losses.append(rs.step(b, lr))
            if k == 0:
                g1 = {n: g.clone() for n, g in rs.grads.items()}
        p1 = rs.params()
        change = norms({k: p1[k] - p0[k] for k in p1})
    finally:
        common.restore_tf32(old)
    return {"losses": losses, "grad1": norms(g1), "grad1_t": g1,
            "change": change}


def run(ctx) -> dict:
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import TrainConfig
    from srbh_tpu_torch.train.schedule import step_decay_lr
    from srbh_tpu_torch.train.state import TrainState
    from srbh_tpu_torch.train.steps import make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    prec = precision()
    marks = [("imports", time.perf_counter())]
    root = env.scratch_dir(ctx.cell["name"])
    tiles = synth.make(tr["tiles"], ctx.seed)
    paths = synth.write(root, *tiles)
    hist = np.bincount(tiles[2].reshape(-1), minlength=256)
    marks.append(("tiles", time.perf_counter()))
    m = cfg["model"]
    tcfg = TrainConfig(seed=ctx.seed % (2**31), batch_size=tr["batch"],
                       num_workers=tr["num_workers"],
                       rgbseq=tuple(m["rgb_idx"]),
                       encoder_name=m["encoder"]["name"],
                       super_mid=m["super_mid"], chans_build=m["chans_build"],
                       sr_num_block=m["sr"]["num_block"],
                       sr_num_feat=m["sr"]["num_feat"],
                       sr_num_grow=m["sr"]["num_grow_ch"], **paths)
    states = flagship_weights(cfg, ctx.seed, dev)
    marks.append(("weights", time.perf_counter()))
    model, sr = trainer.build_models(tcfg)
    model.load_state_dict(states[0])
    sr.load_state_dict(states[1])
    model.to(dev)
    loader = trainer.make_loader(tcfg, tcfg.trainlist, aug=True,
                                 isaggre=tcfg.isaggre, ishir=tcfg.ishir,
                                 preweight=tcfg.preweight, device=dev)
    state = TrainState(model, n_log_vars=3, lr=tcfg.lr,
                       weight_decay=tcfg.weight_decay, sr_model=sr)
    dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
    step = make_train_step(model, sr, tcfg.rgbseq, tcfg.isaggre,
                           seed=tcfg.seed, hir=tcfg.hir,
                           class_weight=loader.dataset.heightweight,
                           ishir=tcfg.ishir, dtype=dtype, device=dev)
    marks.append(("trainer", time.perf_counter()))
    spans = Spans() if ctx.trace else None

    def batches():
        epoch = 0
        while True:
            epoch += 1
            lr = step_decay_lr(tcfg.lr, epoch)
            for b in loader:
                yield b, lr

    feed = batches()
    if spans is not None:
        feed = spans.wrap_iter("loader_wait", feed)

    # the checked steps: the window's call and feed, recorded from the
    # state the window then goes on with
    prog, fed, lrs = {"losses": []}, [], []
    for k in range(tr["checked_steps"]):
        b, lr = next(feed)
        fed.append(_batch(b))
        if k == 0:
            # the first batch's tiles, to derive it anew after the run
            first = [synth.index(p) for p in b["path"]]
            tiles = tuple(t[first] for t in tiles)
        lrs.append(lr)
        m = step(state, b, lr)
        prog["losses"].append(float(m["loss"]))
        if k == 0:
            prog["grad1_t"] = {n: g.clone() for n, g in grad1(state).items()}
            prog["grad1"] = norms(prog["grad1_t"])
        common.sync(dev)
        marks.append((f"step{k + 1}", time.perf_counter()))
    after = trained(state)
    before = {**states[0], "log_vars": torch.zeros(3, device=dev)}
    prog["change"] = norms({k: after[k] - before[k].to(dev) for k in after})
    del after
    if ctx.trace:
        with Stretch():
            b, lr = next(feed)
            step(state, b, lr)
    common.sync(dev)
    common.reset_peak(dev)

    # the window's checked sample: steps s0 .. s0 + k_win - 1 of the window
    wc = tr["window_check"]
    s0 = wc["from"] + common.sample_indices(ctx.seed, 4, 1,
                                            wc["below"] - wc["from"])[0]
    k_win, n_setup = wc["steps"], tr["checked_steps"] + int(ctx.trace)
    win = {"losses": [], "batches": [], "lrs": []}

    def one_step(k):
        if k == s0:
            win["before"] = snapshot(state)
        b, lr = next(feed)
        if s0 <= k < s0 + k_win:
            win["batches"].append(_batch(b))
            win["lrs"].append(lr)
        m = step(state, b, lr)
        if s0 <= k < s0 + k_win:
            win["losses"].append(m["loss"].detach())
            if k == s0 + k_win - 1:
                win["after"] = trained(state)

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
                  "step_flops": train_flops(cfg, tcfg.batch_size),
                  "loader_wait_s": spans.seconds["loader_wait"][
                      n_setup:n_setup + steps]}
    del state, model, sr, loader, step, feed
    gc.collect()
    common.free(dev)
    shutil.rmtree(root, ignore_errors=True)

    # the loader's first batch: the first epoch's (epoch 0) draws
    want = height_loader.batch(*tiles, first, tcfg.seed, 0, hist,
                               tcfg.hir)
    refr = reference_record(cfg, tcfg, states, fed, lrs, dev, prec)
    reads = readings(prog, refr)
    reads.update(loader_readings(fed[0], want))
    snap = win["before"]
    w_before = {**{k: snap["model"][k] for k in win["after"]
                   if k != "log_vars"}, "log_vars": snap["log_vars"]}
    wprog = {"losses": [float(v) for v in win["losses"]],
             "change": norms({k: v - w_before[k]
                              for k, v in win.pop("after").items()})}
    refr_w = reference_record(cfg, tcfg, states, win["batches"], win["lrs"],
                              dev, prec, snap=snap)
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
             f"worst leaves: grad {worst_leaves(prog['grad1'], refr)}, "
             f"change {worst_leaves(prog['change'], refr, 'change')}",
             f"reference losses {refr['losses']}",
             f"program losses {prog['losses']}",
             f"card {common.power_limit(dev)}"]
    return {"correct": correct,
            "attempted": steps + late + n_setup,
            "failed": 0 if correct else tr["checked_steps"] + k_win,
            "e2e": {"setup_s": setup_s,
                    "train_tiles_per_s": stats.rate(tcfg.batch_size * steps,
                                                    window)},
            "record": record, "memory_peak_bytes": peak, "checks": checks,
            "readings": reads, "notes": notes,
            "state": (tcfg, states, fed, lrs, refr, win, snap, refr_w, prec,
                      (tiles, first, hist))}


def _loader_part(reads: dict) -> dict:
    return {k: v for k, v in reads.items() if k.startswith("loader_")}


def _step_part(reads: dict) -> dict:
    return {k: v for k, v in reads.items() if not k.startswith("loader_")}


def control(ctx, out) -> dict:
    """The control: the reference under bfloat16 autocast in the program's
    place, read against the yardstick, over the set-up's steps and the
    window's sample (the loader's readings are the program's)."""
    tcfg, states, fed, lrs, refr, win, snap, refr_w, prec, _ = out["state"]
    ctl = reference_record(ctx.config, tcfg, states, fed, lrs, ctx.device,
                           prec, dtype=torch.bfloat16)
    ctl_w = reference_record(ctx.config, tcfg, states, win["batches"],
                             win["lrs"], ctx.device, prec,
                             dtype=torch.bfloat16, snap=snap)
    return {**readings(ctl, refr), **window_readings(ctl_w, refr_w),
            **_loader_part(out["readings"])}


def faults(ctx, out) -> dict:
    """The readings of the faults, each planted in a reference put in the
    program's place, the other part's readings the program's:

    * the step's, over the set-up's steps and the window's sample:
      ``half_batch`` (each step on the first half of its rows) and
      ``unchanged`` (a step that leaves the state as it was);
    * the loader's first batch: ``unrotated_heights`` (the image rotated,
      its heights not) and ``next_epoch`` (the next epoch's draws);
    * beside them, ``tf32_off``: the reference with TF32 off in the
      program's place, a reading of how far the configuration's precision
      moves the step (the same as the yardstick off a card)."""
    tcfg, states, fed, lrs, refr, win, snap, refr_w, prec, loader = \
        out["state"]
    dev = ctx.device
    tiles, first, hist = loader
    step_ok, loader_ok = _step_part(out["readings"]), _loader_part(
        out["readings"])

    def step_fault(batches, wbatches, tf32):
        rec = reference_record(ctx.config, tcfg, states, batches, lrs, dev,
                               tf32)
        rec_w = reference_record(ctx.config, tcfg, states, wbatches,
                                 win["lrs"], dev, tf32, snap=snap)
        return {**readings(rec, refr), **window_readings(rec_w, refr_w),
                **loader_ok}

    def half(batches):
        return [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]

    off = {"cudnn": False, "matmul": False}
    res = {"tf32_off": step_fault(fed, win["batches"], off),
           "half_batch": step_fault(half(fed), half(win["batches"]), prec)}
    still = {"losses": refr["losses"], "grad1": {}, "grad1_t": {},
             "change": {k: 0.0 for k in refr["change"]}}
    still_w = {"losses": refr_w["losses"],
               "change": {k: 0.0 for k in refr_w["change"]}}
    res["unchanged"] = {**readings(still, refr),
                        **window_readings(still_w, refr_w), **loader_ok}
    want = height_loader.batch(*tiles, first, tcfg.seed, 0, hist,
                               tcfg.hir)

    def loader_fault(epoch=0, **kw):
        got = height_loader.batch(*tiles, first, tcfg.seed, epoch,
                                  hist, tcfg.hir, **kw)
        return {**step_ok, **loader_readings(
            {k: torch.from_numpy(v) for k, v in got.items()}, want)}

    res["unrotated_heights"] = loader_fault(rotate_heights=False)
    res["next_epoch"] = loader_fault(epoch=1)
    return res
