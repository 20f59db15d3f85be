"""The port's height train step (``train/steps.py:make_train_step`` over a
``TrainState``) against the benchmark's plain reference
(``benchmark/reference/height_train.py``: the frozen RRDBNet, the height
model in train mode with drop-connect, the three adaptive losses and Adam
with coupled weight decay, in plain torch, importing nothing of the port),
and the step's spans.

Tiny flagship (the benchmark's test configuration ``flagship_tiny``:
``efficientnet-test``, decoder (32, 16, 16, 8, 8), a 2-block RRDBNet),
weights drawn by the benchmark's flagship rules, 32 x 32 tiles, batch 4,
drop-connect on: both sides draw its masks from ``step_seed(seed, step)``
on a CPU generator. Three steps, compared by the gradient-noise rule
(ROADMAP, standing rules), never element by element after Adam alone:

* each step's loss within 1e-5 relative;
* the first gradient Adam took (its first moment over 1 - beta1, weight
  decay included) within ``NOISE`` x its tensor's max |g| per element;
* after step 1, no element whose first gradient stands clear of that noise
  (above twice it, plus 1e-6 x the model's largest gradient) differs by
  more than 1e-4: Adam's first update is +-lr whatever the gradient's
  size, so only an element whose gradient is near 0 may move the other
  way; after step 3 those elements within 2.5e-3, the log-vars within 1e-5.

A batch with taller buildings misses the loss by far more. Drop-connect
(which the tiny encoder's blocks do not reach) is held alone: an identity
block of the reference against the port's, one seed.

The loader's samples (``trainer.make_loader``'s dataset over seeded tiles
in their on-disk form) are held against ``reference/height_loader.py``,
derived from the arrays the tiles were written from; heights left
unrotated and another epoch's draws miss it.
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.drivers.serve import flagship_weights
from benchmark.reference import height_train as ref
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.rrdbnet import RRDBNet
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.steps import make_train_step, step_seed
from srbh_tpu_torch.utils import profiler
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "tests", "data", "flagship_tiny.json")
SEED, TRAIN_SEED = 2**31 + 5150, 4242
LRS = (1e-3, 1e-3, 1e-3)
# float32 noise of a training gradient, per tensor, as a share of the
# tensor's max |g|: the aggregated model's (tests/test_torch_train_step.py)
NOISE = 0.02


def _config():
    with open(TINY) as f:
        return json.load(f)


def _batches(n, b=4, t=32):
    g = torch.Generator().manual_seed(31)
    out = []
    for _ in range(n):
        h = torch.randint(0, 60, (b, 4 * t, 4 * t), generator=g).float()
        h = h * (torch.rand((b, 4 * t, 4 * t), generator=g) > 0.6)
        out.append({
            "image": torch.rand((b, t, t, 8), generator=g),
            "height": h,
            "build": (h / 10).clamp(max=6).long(),
            "weight": 0.5 + torch.rand((b, 4 * t, 4 * t), generator=g),
            "height_aggre": torch.nn.functional.avg_pool2d(h[:, None], 4)[:, 0],
            "weight_aggre": 0.5 + torch.rand((b, t, t), generator=g)})
    return out


def _port(cfg, states):
    m = cfg["model"]
    model = SRRegressClsFeature(
        m["encoder"]["name"], super_mid=m["super_mid"], isaggre=True,
        chans_build=m["chans_build"], sr_chans=m["sr"]["num_feat"],
        decoder_channels=tuple(m["decoder_channels"]))
    sr = RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=m["sr"]["num_feat"],
                 num_block=m["sr"]["num_block"],
                 num_grow_ch=m["sr"]["num_grow_ch"])
    model.load_state_dict(states[0])
    sr.load_state_dict(states[1])
    state = TrainState(model, n_log_vars=3, lr=1e-3, weight_decay=1e-4,
                       sr_model=sr)
    return state, make_train_step(model, sr, seed=TRAIN_SEED, device="cpu")


@pytest.fixture(scope="module")
def runs():
    cfg = _config()
    states = flagship_weights(cfg, SEED, "cpu")
    batches = _batches(3)
    state, step = _port(cfg, states)
    reference = ref.HeightTrainStep(cfg, *states, "cpu", seed=TRAIN_SEED,
                                    lr=1e-3, weight_decay=1e-4)
    got, want = {"loss": []}, {"loss": []}
    for k, (b, lr) in enumerate(zip(batches, LRS)):
        got["loss"].append(float(step(state, b, lr)["loss"]))
        want["loss"].append(reference.step(b, lr))
        if k == 0:
            named = dict(state.model.named_parameters(),
                         log_vars=state.log_vars)
            got["grad1"] = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                            for n, p in named.items()}
            want["grad1"] = dict(reference.grads)
            got["p1"] = {n: p.detach().clone() for n, p in named.items()}
            want["p1"] = {n: p.clone() for n, p in reference.params().items()}
    got["p3"] = dict(state.model.named_parameters(),
                     log_vars=state.log_vars)
    want["p3"] = reference.params()
    return got, want, cfg, states, batches


def test_the_draws_are_the_ports():
    assert ref.step_seed(TRAIN_SEED, 7) == step_seed(TRAIN_SEED, 7)


def test_losses_match(runs):
    got, want, *_ = runs
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_the_first_gradient_matches(runs):
    got, want, *_ = runs
    assert set(got["grad1"]) == set(want["grad1"])
    for n, g in want["grad1"].items():
        err = float((got["grad1"][n] - g).abs().max())
        assert err <= NOISE * float(g.abs().max()) + 1e-12, n


def test_parameters_follow_by_the_noise_rule(runs):
    got, want, *_ = runs
    g1 = want["grad1"]
    floor = 1e-6 * max(float(g.abs().max()) for g in g1.values())
    clear = {n: g.abs() > 2 * NOISE * g.abs().max() + floor
             for n, g in g1.items()}
    for key, thresh in (("p1", 1e-4), ("p3", 2.5e-3)):
        for n, w in want[key].items():
            diff = (got[key][n].detach() - w).abs()
            assert not bool((diff[clear[n]] > thresh).any()), (key, n)
    torch.testing.assert_close(got["p3"]["log_vars"].detach(),
                               want["p3"]["log_vars"], atol=1e-5, rtol=0)
    moved = sum(int(clear[n].sum()) for n in clear)
    assert moved > 0.5 * sum(g.numel() for g in g1.values())


def test_taller_buildings_miss(runs):
    got, _, cfg, states, batches = runs
    reference = ref.HeightTrainStep(cfg, *states, "cpu", seed=TRAIN_SEED,
                                    lr=1e-3, weight_decay=1e-4)
    taller = dict(batches[0])
    taller["height"] = taller["height"] + 5.0
    assert reference.step(taller, LRS[0]) != pytest.approx(got["loss"][0],
                                                           rel=1e-3)


def test_drop_connect_draws_as_the_port():
    """An identity MBConv in training mode at rate 0.3: the reference's
    block with its drop-connect against the port's, one seed each (the tiny
    encoder has no identity block, so the whole step above draws none)."""
    from benchmark.reference import flagship
    from srbh_tpu_torch.models.efficientnet import MBConv

    port = MBConv(16, 16, 6, 3, 1, drop_rate=0.3).train()
    plain = flagship.MBConv(16, 16, 6, 3, 1).train()
    plain.load_state_dict(port.state_dict())
    x = torch.randn((8, 16, 8, 8), generator=torch.Generator().manual_seed(3))
    outs = []
    for block, forward in ((port, lambda b, g: b(x, g)),
                           (plain, lambda b, g: ref._mbconv(b, x, 0.3, g))):
        gen = torch.Generator().manual_seed(step_seed(TRAIN_SEED, 2))
        with torch.no_grad():
            outs.append(forward(block, gen))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=1e-5)
    # some rows dropped: their output is the input alone
    dropped = [(o - x).flatten(1).abs().max(1).values == 0 for o in outs]
    assert torch.equal(dropped[0], dropped[1]) and 0 < int(dropped[0].sum()) < 8


def test_the_step_opens_its_spans(monkeypatch):
    """``train.step`` is the root over ``train.sr_features``,
    ``train.model_pass`` and ``train.adam``, which alone ask for a CUDA
    event pair."""
    cfg = _config()
    state, step = _port(cfg, flagship_weights(cfg, SEED + 1, "cpu"))
    asked = []
    span = profiler.span

    def watched(name, device=False):
        asked.append((name, device))
        return span(name, device)

    monkeypatch.setattr(profiler, "span", watched)
    profiler.clear()
    with profiler.recording():
        step(state, _batches(1)[0], 1e-3)
    spans = profiler.spans()
    profiler.clear()
    tree = [(s["name"], None if s["parent"] is None
             else spans[s["parent"]]["name"]) for s in spans]
    assert tree == [("train.step", None), ("train.sr_features", "train.step"),
                    ("train.model_pass", "train.step"),
                    ("train.adam", "train.step")]
    assert asked == [("train.step", False), ("train.sr_features", True),
                     ("train.model_pass", True), ("train.adam", True)]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Seeded tiles in the dataset's on-disk form, and the trainer's train
    dataset over them (``trainer.make_loader``'s, host augmentation)."""
    from benchmark.synth import height_tiles as synth
    from srbh_tpu_torch.train import trainer
    from srbh_tpu_torch.train.config import TrainConfig

    tiles = synth.make(24, SEED)
    cfg = TrainConfig(seed=TRAIN_SEED, num_workers=0, **synth.write(
        str(tmp_path_factory.mktemp("tiles")), *tiles))
    loader = trainer.make_loader(cfg, cfg.trainlist, aug=True,
                                 isaggre=cfg.isaggre, ishir=cfg.ishir,
                                 preweight=cfg.preweight, device="cpu")
    return tiles, loader.dataset, cfg


def _samples(ds, indices, epoch):
    ds.set_epoch(epoch)
    got = [ds[i] for i in indices]
    return {k: torch.from_numpy(np.stack([g[k] for g in got]))
            for k in got[0] if k != "path"}


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_loader_samples_match_the_plain_reference(written, epoch):
    """The port's dataset (GeoTIFF reads, augmentation, normalisation,
    hierarchy targets) against ``reference/height_loader.py`` derived from
    the arrays the tiles were written from, as the train cell checks its
    first batch: the image to float32 round-off of the rotation, the
    targets but for a rare pixel whose nearest source the port's float32
    coordinates round the other way (cv2's rule, against float64 here)."""
    from benchmark.drivers.height_train import loader_readings
    from benchmark.reference import height_loader

    tiles, ds, cfg = written
    idx = [0, 5, 9, 13, 17, 21, 23, 2]
    hist = np.bincount(tiles[2].reshape(-1), minlength=256)
    want = height_loader.batch(*(t[idx] for t in tiles), idx, TRAIN_SEED,
                               epoch, hist, cfg.hir)
    reads = loader_readings(_samples(ds, idx, epoch), want)
    assert reads["loader_image_err"] < 1e-4
    assert reads["loader_target_miss"] < 1e-4


@pytest.mark.parametrize("fault", ["unrotated_heights", "next_epoch"])
def test_a_loader_fault_misses(written, fault):
    from benchmark.drivers.height_train import loader_readings
    from benchmark.reference import height_loader

    tiles, ds, cfg = written
    idx = list(range(8))
    hist = np.bincount(tiles[2].reshape(-1), minlength=256)
    kw = ({"rotate_heights": False} if fault == "unrotated_heights"
          else {})
    want = height_loader.batch(*(t[idx] for t in tiles), idx, TRAIN_SEED,
                               int(fault == "next_epoch"), hist, cfg.hir,
                               **kw)
    reads = loader_readings(_samples(ds, idx, 0), want)
    assert (reads["loader_image_err"] > 0.01
            or reads["loader_target_miss"] > 0.01), reads
