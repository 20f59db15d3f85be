"""The port's data-parallel training against one process and the JAX package.

Every multi-rank test starts gloo processes (``parallel.mesh.run_ranks``:
one torch thread each, meeting through a file store in ``tmp_path``); the
parent passes the weights and batches as ``torch.save`` files and compares
what the ranks return. This module imports JAX only inside the fixtures
that compute the references, so the ranks (which import it to find their
function) start without it.

* The loader's ``shard_index`` / ``num_shards``: disjoint interleaved
  shards cut to one length; two processes' global sum equals one's
  (``tests/test_multihost.py``'s twin).
* Per-sample draws by global row: drop-connect and ``device_aug`` give a
  rank's rows the draws of those rows in the whole batch.
* The global BatchNorm at 2 ranks against ``nn.BatchNorm2d``, and
  ``replicate``.
* The height step (``make_train_step(group=...)``) under DDP and FSDP2 at
  2 ranks (batch 2, drop-connect off) against one process and JAX's first
  step (its ``value_and_grad`` through Adam's first update), and at 4
  ranks (batch 4; FSDP2, and DDP with ``device_aug``) against one process:
  losses within 2e-5 relative of one process (1e-3 of JAX's, as
  ``tests/test_torch_train_step.py``), parameters by that file's
  gradient-noise rule, BatchNorm running statistics after the first step
  within ``tests/test_fsdp.py``'s bound (rtol 1e-5, atol 1e-6), and FSDP2
  holding 1/n of each parameter whose dim divides.
* FSDP and TP spec coverage at B4's shapes (``tests/test_flagship_
  multichip.py``'s twin, no step).
* The data-parallel GAN step at 2 ranks against one process
  (``tests/test_sr_dp.py``'s twin): losses 1e-5 relative, gradients and
  parameters (see the test), spectral-norm ``u`` and EMA equal on both
  ranks.
* ``trainer.main`` at 2 ranks (auto DP) against one process; the 2-rank
  FSDP2 trainer is in ``tests/test_torch_trainer.py``.
"""
import math
import os

import numpy as np
import pytest
import torch

from srbh_tpu_torch import convert
from srbh_tpu_torch.data.pipeline import DataLoader
from srbh_tpu_torch.models.efficientnet import MBConv
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.parallel import mesh as pmesh
from srbh_tpu_torch.parallel.collectives import rank, world
from srbh_tpu_torch.parallel.data import BatchRows, global_batchnorm
from srbh_tpu_torch.train import steps
from srbh_tpu_torch.train.checkpoint import whole
from srbh_tpu_torch.train.state import TrainState
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


ENC = "efficientnet-test"
DEC = (32, 24, 16, 12, 8)
LRS = (1e-3, 1e-3)
LOSS_RTOL = 2e-5  # against one process: float32 sums in another order
JAX_LOSS_RTOL = 1e-3  # against JAX: tests/test_torch_train_step.py
# the gradient-noise rule of tests/test_torch_train_step.py: the largest
# float32 error of a training gradient as a share of its tensor's max |g|,
# the thresholds after step 1 and later steps, and the share of all
# elements allowed beyond them
F32_GRAD_NOISE = 0.02
THRESH = (1e-4, 2.5e-3)
SHARE = (0.013, 0.003)
BN_RTOL, BN_ATOL = 1e-5, 1e-6  # tests/test_fsdp.py


class FixedFeature(torch.nn.Module):
    """The frozen RRDBNet's stand-in: fixed NHWC features, as NCHW."""

    def __init__(self, fea_nhwc):
        super().__init__()
        self.register_buffer("fea", torch.from_numpy(
            np.ascontiguousarray(fea_nhwc.transpose(0, 3, 1, 2))))

    def forward(self, x, features_only=True):
        return self.fea


def _batch(rng, n):
    return {
        "image": rng.normal(size=(n, 32, 32, 8)).astype(np.float32),
        "height": np.abs(rng.normal(size=(n, 128, 128))).astype(np.float32) * 8,
        "weight": rng.uniform(0.5, 2.0, size=(n, 128, 128)).astype(np.float32),
        "build": rng.integers(0, 7, size=(n, 128, 128)).astype(np.int32),
        "height_aggre": np.abs(rng.normal(size=(n, 32, 32))).astype(np.float32) * 8,
        "weight_aggre": rng.uniform(0.5, 2.0, size=(n, 32, 32)).astype(np.float32),
    }


def _model(sd, rate=0.0):
    m = SRRegressClsFeature(ENC, super_mid=8, isaggre=True, chans_build=7,
                            sr_chans=8, decoder_channels=DEC,
                            drop_connect_rate=rate)
    m.load_state_dict(sd)
    return m


def _run_steps(model, fea, batch, lrs, group=None, device_aug=False):
    """Steps of ``make_train_step`` from ``model``: per step the metrics,
    the parameters and the gradients Adam was handed (whole, the weight
    decay added: it cancels some gradients, whose sign is then noise), and the
    BatchNorm running statistics after the first step (later ones compound
    Adam's sign flips: tests/test_torch_train_step.py)."""
    state = TrainState(model, n_log_vars=3, lr=1e-3)
    kept, apply = {}, state.apply_gradients

    decay = state.optimizer.param_groups[0]["weight_decay"]

    def keep(lr):
        kept["grads"] = whole({n: p.grad + decay * p.detach()
                               for n, p in model.named_parameters()})
        return apply(lr)

    state.apply_gradients = keep
    step = steps.make_train_step(model, FixedFeature(fea), seed=0,
                                 device="cpu", group=group,
                                 device_aug=device_aug)
    out = []
    for lr in lrs:
        m = step(state, batch, lr)
        if not out:
            stats = whole({k: v.clone() for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))})
        params = whole({n: p.detach() for n, p in model.named_parameters()})
        out.append({"loss": m["loss"].item(), "rmse": m["rmse"].item(),
                    "log_vars": m["log_vars"].numpy().copy(),
                    "params": {n: v.numpy().copy() for n, v in params.items()},
                    "grads": {n: g.double().numpy()
                              for n, g in kept["grads"].items()}})
    return out, {k: v.numpy().copy() for k, v in stats.items()}


def _rank_steps(case_path, modes):
    """A rank's run of ``_run_steps`` for each mode (``ddp``, ``fsdp``,
    ``ddp_aug``) on its rows of the case's batch."""
    case = torch.load(case_path, weights_only=False)
    mesh = pmesh.make_mesh()
    group = mesh.get_group(pmesh.DATA_AXIS)
    fea = pmesh.shard_batch(case["fea"], group)
    results = {}
    for mode in modes:
        model = _model(case["sd"], case["rate"])
        aug = mode == "ddp_aug"
        batch = pmesh.shard_batch(case["aug_batch" if aug else "batch"], group)
        shards = {}
        if mode == "fsdp":
            global_batchnorm(model, group)
            pmesh.shard_state_fsdp(model, mesh)
            shards = {n: (p.to_local().numel(), p.numel(),
                          pmesh.fsdp_param_spec(p, world(group)))
                      for n, p in model.named_parameters()}
        out, stats = _run_steps(model, fea, batch, case["lrs"], group, aug)
        results[mode] = {"steps": out, "stats": stats, "shards": shards}
    return results


def _single(case, device_aug=False):
    batch = case["aug_batch" if device_aug else "batch"]
    return _run_steps(_model(case["sd"], case["rate"]), case["fea"], batch,
                      case["lrs"], device_aug=device_aug)


def _check_params(got, want, grads, thresh, share_bound, label):
    """The gradient-noise rule: no element whose reference gradient stands
    clear of float32 noise beyond ``thresh``, and the share of all elements
    beyond it under ``share_bound``."""
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    total = beyond = faults = 0
    for name, w in want.items():
        g = grads[name]
        clear = np.abs(g) > 2 * F32_GRAD_NOISE * np.abs(g).max() + floor
        differ = np.abs(got[name].astype(np.float64) - w) > thresh
        total += w.size
        beyond += int(differ.sum())
        faults += int((differ & clear).sum())
    print(f"{label}: {beyond / total:.4%} of params beyond {thresh:g}")
    assert faults == 0, f"{label}: {faults} clear-gradient elements beyond"
    assert beyond / total < share_bound, f"{label}: {beyond / total:.4%}"


def _check_against_one_process(ranked, single, label):
    steps_single, stats_single = single
    for i, (got, want) in enumerate(zip(ranked["steps"], steps_single)):
        for key in ("loss", "rmse"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL), \
                f"{label} {key} step {i + 1}"
        np.testing.assert_allclose(got["log_vars"], want["log_vars"],
                                   rtol=1e-5, atol=1e-6)
        _check_params(got["params"], want["params"],
                      steps_single[0]["grads"], THRESH[i > 0],
                      SHARE[i > 0], f"{label} step {i + 1}")
    assert set(ranked["stats"]) == set(stats_single)
    for name, st in stats_single.items():
        np.testing.assert_allclose(ranked["stats"][name], st, rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=f"{label} {name}")


def _check_shards(shards, n):
    """FSDP2 holds 1/n of each parameter whose chosen dim divides."""
    split = 0
    for name, (local, full, spec) in shards.items():
        if spec is not None:
            assert local == full // n, (name, local, full)
            split += 1
    assert split >= len(shards) // 2, (split, len(shards))


# ---------------------------------------------------------------- loader


class ArangeDataset:
    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((4,), float(i), np.float32)}


@pytest.mark.parametrize("n,shards,shuffle", [(16, 2, False), (17, 2, True),
                                              (18, 4, True), (16, 1, True)])
def test_loader_shards_are_disjoint_and_interleaved(n, shards, shuffle):
    """Shard ``r`` reads ``idx[r::shards]`` of the epoch's order, cut to
    ``n // shards``; the shards are disjoint and their ``k``-th batches
    together are the single loader's ``k``-th batch."""
    single = DataLoader(ArangeDataset(n), batch_size=4, shuffle=shuffle,
                        num_workers=0, drop_last=True)
    whole_order = [int(v) for b in single for v in b["x"][:, 0]]
    seen = []
    for r in range(shards):
        loader = DataLoader(ArangeDataset(n), batch_size=4 // shards,
                            shuffle=shuffle, num_workers=0, shard_index=r,
                            num_shards=shards, drop_last=True)
        mine = [int(v) for b in loader for v in b["x"][:, 0]]
        assert len(mine) == len(loader) * loader._loader.batch_size
        seen.append(mine)
    flat = [i for s in seen for i in s]
    assert len(flat) == len(set(flat))
    for r, mine in enumerate(seen):
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(1337).shuffle(order)
        assert mine == order[r::shards][:n // shards][:len(mine)].tolist()
    # shard r's k-th batch holds rows r, r + shards, ... of the k-th batch
    interleaved = [seen[r][j] for j in range(len(seen[0]))
                   for r in range(shards)]
    assert interleaved[:len(whole_order)] == whole_order[:len(interleaved)]
    with pytest.raises(ValueError):
        DataLoader(ArangeDataset(n), shard_index=shards, num_shards=shards)


# ------------------------------------------------- draws by global row


def test_drop_connect_draws_follow_the_global_row():
    """An identity MBConv with drop-connect on (BatchNorm on its running
    statistics, so that rows do not meet): the rows of a rank under
    ``BatchRows`` get exactly the single batch's outputs for those rows."""
    torch.manual_seed(0)
    block = MBConv(8, 8, 2, 3, 1, drop_rate=0.5).train()
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    x = torch.randn(8, 8, 6, 6)
    with torch.no_grad():
        want = block(x, torch.Generator().manual_seed(3))
        for r in range(4):
            got = block(x[r::4], BatchRows(torch.Generator().manual_seed(3),
                                           r, 4))
            torch.testing.assert_close(got, want[r::4], rtol=0, atol=0)
    # the drops really vary by row
    assert len({round(float(v), 4) for v in (want - x).flatten(1).abs().sum(1)}) > 1


def test_augment_draws_follow_the_global_row():
    """``device_aug``: a rank's rows are augmented as the whole batch's."""
    from srbh_tpu_torch.ops.hierarchy import DEFAULT_HIR, build_hierarchy_lut

    rng = np.random.default_rng(5)
    b = {"image": torch.from_numpy(rng.uniform(0, 1, (8, 16, 16, 8))
                                   .astype(np.float32)),
         "height": torch.from_numpy(rng.integers(0, 60, (8, 64, 64))
                                    .astype(np.uint8))}
    lut = torch.as_tensor(build_hierarchy_lut(DEFAULT_HIR).astype(np.int64))
    cw = torch.ones(len(DEFAULT_HIR) - 1)
    args = ("cpu", 0, 3, None, lut, cw, True, True)
    want = steps._augment(b, *args)
    for r in range(2):
        got = steps._augment({k: v[r::2] for k, v in b.items()}, *args, (r, 2))
        for k, v in want.items():
            torch.testing.assert_close(got[k], v[r::2], rtol=0, atol=0)


# ------------------------------------------------------ the height step


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """The 2-rank case (batch 2, drop-connect off; seeded weights carried to
    the JAX model by ``convert.height_model_variables``) and JAX's first
    step: its loss and rmse, and its gradient as Adam is handed it (the
    weight decay added) with the parameters and log-vars after Adam's first
    update of it, ``p - lr g / (|g| + eps)`` (``tests/test_torch_train_
    step.py`` holds the two optimizers equal)."""
    import jax
    import jax.numpy as jnp

    from srbh_tpu.losses import adaptive as JL
    from srbh_tpu.models import SRRegressClsFeature as JaxModel
    from srbh_tpu_torch.models.layers import init_weights

    sd = init_weights(SRRegressClsFeature(
        ENC, super_mid=8, isaggre=True, chans_build=7, sr_chans=8,
        decoder_channels=DEC, drop_connect_rate=0.0),
        torch.Generator().manual_seed(1)).state_dict()
    variables = convert.height_model_variables(sd, True, ENC)
    rng = np.random.default_rng(23)
    fea = rng.normal(size=(2, 128, 128, 8)).astype(np.float32)
    batch = _batch(rng, 2)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(encoder_name=ENC, super_mid=8, isaggre=True, chans_build=7,
                  decoder_channels=DEC, drop_connect_rate=0.0)

    def loss_fn(params, log_vars):
        (h, bl, a), _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            bj["image"], jnp.asarray(fea), train=True, mutable=["batch_stats"])
        loss = (JL.mse_adapt_weight(h[..., 0], bj["height"], bj["weight"],
                                    log_vars[0])
                + JL.mse_adapt_weight(a[..., 0], bj["height_aggre"],
                                      bj["weight_aggre"], log_vars[1])
                + JL.ce_dice_adapt_weight(bl, bj["build"], bj["weight"],
                                          log_vars[2]))
        return loss, jnp.sqrt(jnp.mean((h[..., 0] - bj["height"]) ** 2))

    (loss, rmse), (g_p, g_lv) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                                jnp.zeros(3))
    lr, eps = LRS[0], 1e-8

    def named(tree):
        out = convert.height_model_state_dict(
            {"params": jax.device_get(tree),
             "batch_stats": variables["batch_stats"]}, ENC, True)
        return {k: v.numpy().astype(np.float64) for k, v in out.items()
                if k.rsplit(".", 1)[-1] in ("weight", "bias")}

    params = {k: v.numpy().astype(np.float64) for k, v in sd.items()
              if k.rsplit(".", 1)[-1] in ("weight", "bias")}
    grads = {k: g + 1e-4 * params[k] for k, g in named(g_p).items()}
    g_lv = np.asarray(g_lv, np.float64)
    case = {"sd": sd, "fea": fea, "batch": batch, "lrs": LRS[:1], "rate": 0.0}
    path = tmp_path_factory.mktemp("jax_case") / "case.pt"
    torch.save(case, path)
    return {"case": case, "path": str(path), "loss": float(loss),
            "rmse": float(rmse), "grads": grads,
            "log_vars": -lr * g_lv / (np.abs(g_lv) + eps),
            "params": {k: p - lr * grads[k] / (np.abs(grads[k]) + eps)
                       for k, p in params.items()}}


def _bn_case():
    torch.manual_seed(0)
    bn = torch.nn.BatchNorm2d(3, momentum=0.3)
    torch.nn.init.uniform_(bn.weight)
    torch.nn.init.uniform_(bn.bias)
    x = torch.randn(8, 3, 5, 5) * 3 + 2
    return bn, x, torch.randn(8, 3, 5, 5)


def _bn_run(bn, x, g, group=None):
    """Output, input, weight and bias gradients (the two summed over the
    group: DDP averages them) and running statistics of a training
    BatchNorm on ``x``."""
    x = x.clone().requires_grad_(True)
    y = bn(x)
    y.backward(g)
    grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    if group is not None:
        for t in grads:
            torch.distributed.all_reduce(t, group=group)
    return [y.detach(), x.grad, *grads, bn.running_mean.clone(),
            bn.running_var.clone()]


def _rank_two(case_path):
    """The 2-rank work: the loader's shards and their global sum, the global
    BatchNorm, the height step under DDP and FSDP2, and the GAN step."""
    loader = DataLoader(ArangeDataset(), batch_size=4, num_workers=0,
                        shard_index=rank(), num_shards=world())
    seen = [int(v) for b in loader for v in b["x"][:, 0]]
    total = torch.tensor(sum(4.0 * i for i in seen), dtype=torch.float64)
    torch.distributed.all_reduce(total)
    lq, gt = _gan_inputs()
    group = pmesh.make_mesh().get_group(pmesh.DATA_AXIS)
    bn, x, g = _bn_case()
    global_batchnorm(bn, group)
    differs = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(differs.weight, float(rank()))
    return {"loader": (seen, total.item()),
            "replicated": pmesh.replicate(differs, group).weight.sum().item(),
            "bn": _bn_run(bn, pmesh.shard_batch(x, group),
                          pmesh.shard_batch(g, group), group),
            "steps": _rank_steps(case_path, ("ddp", "fsdp")),
            "gan": _gan_run(pmesh.shard_batch(lq, group),
                            pmesh.shard_batch(gt, group), group)}


@pytest.fixture(scope="module")
def two_ranks(jax_case, tmp_path_factory):
    work = tmp_path_factory.mktemp("two_ranks")
    return pmesh.run_ranks(_rank_two, 2, jax_case["path"], workdir=str(work))


def test_two_process_shards_match_one_process(two_ranks):
    expected = float(sum(i * 4.0 for i in range(16)))
    for r, ranked in enumerate(two_ranks):
        seen, total = ranked["loader"]
        assert all(i % 2 == r for i in seen), seen
        assert total == expected
    assert sorted(two_ranks[0]["loader"][0] + two_ranks[1]["loader"][0]) == \
        list(range(16))


def test_replicate_broadcasts_from_the_first_rank(two_ranks):
    assert [r["replicated"] for r in two_ranks] == [0.0, 0.0]


def test_global_batchnorm_matches_batchnorm2d(two_ranks):
    """Each rank's rows of the output and of the input's gradient, the
    weight and bias gradients summed over the ranks, and the running
    statistics, against ``nn.BatchNorm2d`` on the whole batch: float32
    sums in another order (measured: 2.4e-7 and 1.9e-6 at most)."""
    want = _bn_run(*_bn_case())
    for r, ranked in enumerate(two_ranks):
        got = ranked["bn"]
        for i, (a, b) in enumerate(zip(got, want)):
            b = b[r::2] if i < 2 else b
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_two_rank_step_matches_one_process(jax_case, two_ranks, mode):
    single = _single(jax_case["case"])
    for r, ranked in enumerate(two_ranks):
        _check_against_one_process(ranked["steps"][mode], single,
                                   f"{mode} rank {r}")
    if mode == "fsdp":
        _check_shards(two_ranks[0]["steps"][mode]["shards"], 2)


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_two_rank_step_matches_jax(jax_case, two_ranks, mode):
    got = two_ranks[0]["steps"][mode]["steps"][0]
    for key in ("loss", "rmse"):
        assert got[key] == pytest.approx(jax_case[key], rel=JAX_LOSS_RTOL), key
    np.testing.assert_allclose(got["log_vars"], jax_case["log_vars"],
                               rtol=1e-3, atol=1e-6)
    _check_params(got["params"], jax_case["params"], jax_case["grads"],
                  THRESH[0], SHARE[0], f"{mode} vs JAX")


@pytest.fixture(scope="module")
def four_case(tmp_path_factory):
    """Batch 4, two steps, the model's own initial weights; the device-aug
    batch is raw images and heights."""
    from srbh_tpu_torch.models.layers import init_weights

    rng = np.random.default_rng(29)
    model = init_weights(SRRegressClsFeature(
        ENC, super_mid=8, isaggre=True, chans_build=7, sr_chans=8,
        decoder_channels=DEC), torch.Generator().manual_seed(2))
    batch = _batch(rng, 4)
    aug = {"image": rng.uniform(0, 1, (4, 32, 32, 8)).astype(np.float32),
           "height": rng.integers(0, 80, (4, 128, 128)).astype(np.uint8)}
    case = {"sd": model.state_dict(), "fea": rng.normal(
        size=(4, 128, 128, 8)).astype(np.float32), "batch": batch,
        "aug_batch": aug, "lrs": LRS, "rate": 0.2}
    path = tmp_path_factory.mktemp("four_case") / "case.pt"
    torch.save(case, path)
    ranked = pmesh.run_ranks(_rank_steps, 4, str(path), ("fsdp", "ddp_aug"),
                             workdir=str(tmp_path_factory.mktemp("four")))
    return case, ranked


@pytest.mark.parametrize("mode", ["fsdp", "ddp_aug"])
def test_four_rank_steps_match_one_process(four_case, mode):
    case, ranked = four_case
    single = _single(case, device_aug=mode == "ddp_aug")
    for r in (0, 3):
        _check_against_one_process(ranked[r][mode], single, f"{mode} rank {r}")
    if mode == "fsdp":
        _check_shards(ranked[0][mode]["shards"], 4)


# ------------------------------------------------ spec coverage at B4


BIG = 64 * 1024  # bytes: tests/test_flagship_multichip.py's "big kernel"


def _b4_params():
    from srbh_tpu_torch import entry

    with torch.device("meta"):
        model, sr = entry.modules(tiny=False)
    return list(model.named_parameters()) + list(sr.named_parameters())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_spec_shards_every_big_kernel_at_b4(n):
    total = big_total = per_rank = n_big = 0
    for name, p in _b4_params():
        nbytes = p.numel() * 4
        total += nbytes
        if nbytes >= BIG:
            d = pmesh.fsdp_param_spec(p, n)
            assert d is not None, f"{name} {tuple(p.shape)} stays whole"
            n_big += 1
            big_total += nbytes
            per_rank += nbytes // n
    assert n_big > 100, n_big
    assert per_rank <= big_total / n + 1
    assert big_total / total > 0.9, big_total / total


def test_tp_spec_splits_every_big_kernel_at_b4():
    whole_big = [(name, tuple(p.shape)) for name, p in _b4_params()
                 if p.numel() * 4 >= BIG and pmesh.tp_param_spec(p, 8) is None]
    assert not whole_big, whole_big


def test_spec_rules():
    k = torch.zeros(32, 16, 3, 3)
    assert pmesh.fsdp_param_spec(k, 8) == 0
    assert pmesh.fsdp_param_spec(torch.zeros(3, 8, 5), 8) == 1
    # B4's squeeze-excite reduce: the largest divisible dim
    assert pmesh.fsdp_param_spec(torch.zeros(28, 672, 1, 1), 8) == 1
    assert pmesh.fsdp_param_spec(torch.zeros(3, 5), 8) is None
    assert pmesh.fsdp_param_spec(torch.zeros(()), 8) is None
    assert pmesh.fsdp_param_spec(torch.zeros(16), 1) is None
    assert pmesh.tp_param_spec(k, 4) == 0
    assert pmesh.tp_param_spec(torch.zeros(30, 16, 3, 3), 4) == 1
    assert pmesh.tp_param_spec(torch.zeros(30, 15, 3, 3), 4) is None
    assert pmesh.tp_param_spec(torch.zeros(32), 4) == 0
    assert pmesh.tp_param_spec(torch.zeros(30), 4) is None
    assert pmesh.tp_param_spec(k, 1) is None


# -------------------------------------------------------- the GAN step


def _gan_run(lq, gt, group=None):
    from srbh_tpu_torch.train.sr_trainer import RealESRGANTrainer

    tr = RealESRGANTrainer(num_block=1, num_feat=8, num_grow_ch=8,
                           disc_feat=8, perceptual=False)
    state = tr.init(0, (8, 16, 16, 3), device="cpu")
    grads = {}
    for net, opt in (("g", state.opt_g), ("d", state.opt_d)):
        module = state.net_g if net == "g" else state.net_d

        def keep(opt, *args, module=module, net=net, **kwargs):
            grads[net] = {n: p.grad.double().numpy().copy()
                          for n, p in module.named_parameters()}
        opt.register_step_pre_hook(keep)
    m = tr.make_step(group=group)(state, lq, gt)
    return ({k: v.item() for k, v in m.items()},
            {f"{k}.{n}": v.numpy().copy() for k, net in
             (("g", state.net_g), ("ema", state.g_ema), ("d", state.net_d))
             for n, v in net.state_dict().items()}, grads)


def _gan_inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32),
            rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32))


def test_two_rank_gan_step_matches_one_process(two_ranks):
    """Losses within 1e-5 relative of one process; the averaged gradients
    within 1e-4 x their tensor's max |g| + 1e-3 x the network's largest (D's
    one-channel ``conv9.bias`` sums every pixel's gradient with
    cancellation: measured 8.8e-3 of its own size, 1.5e-4 of D's largest;
    every other tensor within 5e-6 of its own); parameters by the noise
    rule (Adam's first update is +-lr whatever the gradient's size: no
    element beyond 1e-6 where the gradient stands clear of 1e-2 x its
    tensor's max); spectral-norm ``u`` / ``v`` and the EMA bit-equal on both
    ranks."""
    want_m, want_p, want_g = _gan_run(*_gan_inputs())
    ranked = [r["gan"] for r in two_ranks]
    for k in ("l_g_pix", "l_g_gan", "l_g_total", "l_d_real", "l_d_fake",
              "out_d_real", "out_d_fake"):
        for m, _, _ in ranked:
            assert m[k] == pytest.approx(want_m[k], rel=1e-5, abs=1e-7), k
    (_, p0, g0), (_, p1, _) = ranked
    for name, v in p0.items():
        if name.endswith(("weight_u", "weight_v")) or name.startswith("ema."):
            assert np.array_equal(v, p1[name]), name
    for net in ("g", "d"):
        scale = max(np.abs(g).max() for g in want_g[net].values())
        for name, g in want_g[net].items():
            top = np.abs(g).max()
            err = np.abs(g0[net][name] - g).max()
            assert err <= 1e-4 * top + 1e-3 * scale, (net, name, err, top)
            clear = np.abs(g) > 1e-2 * top
            differ = np.abs(p0[f"{net}.{name}"] - want_p[f"{net}.{name}"]) > 1e-6
            assert not (differ & clear).any(), (net, name)
    for name, v in want_p.items():
        if name.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(p0[name], v, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


# ------------------------------------------------------------ the trainer


def _trainer_cfg(root, logdir, **kw):
    from srbh_tpu_torch.train.config import TrainConfig

    return TrainConfig(
        datapath=str(root), trainlist="dl_train.csv", vallist="dl_val.csv",
        logdir=os.path.join(str(root), logdir),
        logdirhr=os.path.join(str(root), "no_sr_ckpt"), datastats=str(root),
        preweight=os.path.join(str(root), "bh_stats.txt"), s1dir="s1c",
        s2dir="s2c", bhdir="bhc", maxepoch=1, batch_size=4, num_workers=0,
        encoder_name=ENC, super_mid=8, sr_num_block=1, sr_num_feat=8,
        sr_num_grow=8, tile=32, **kw)


class Scalars:
    """A writer that keeps what ``trainer.main`` writes."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, epoch):
        self.scalars.setdefault(tag, []).append(float(value))

    def close(self):
        pass


def write_tiles(root, n=8):
    """``n`` synthetic 32x32 tiles and the lists and tables the trainer
    reads (tests/test_torch_trainer.py's recipe)."""
    from srbh_tpu_torch.data.tiff import write_tiff

    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(n)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(os.path.join(root, d))
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for name in names:
        write_tiff(os.path.join(root, "s2c", name),
                   rng.integers(0, 5000, (32, 32, 6)).astype(np.uint16), gt)
        write_tiff(os.path.join(root, "s1c", name),
                   rng.uniform(-25, 5, (32, 32, 2)).astype(np.float32), gt)
        write_tiff(os.path.join(root, "bhc", name),
                   rng.integers(0, 100, (128, 128)).astype(np.uint8),
                   (gt[0], 2.5, 0, gt[3], 0, -2.5))
    for split in ("train", "val"):
        with open(os.path.join(root, f"dl_{split}.csv"), "w") as f:
            f.writelines(f"{name},s1c,s2c,bhc\n" for name in names)
    np.savetxt(os.path.join(root, "s2c_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "s1c_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(os.path.join(root, "bh_stats.txt"), hist)


def rank_main(root, logdir, fsdp):
    """``trainer.main`` in a rank: what rank 0's writer got, and the final
    log-vars."""
    from srbh_tpu_torch.train.trainer import main

    record = Scalars()
    state = main(_trainer_cfg(root, logdir), writer=record, device="cpu",
                 fsdp=fsdp)
    return record.scalars, state.log_vars.detach().numpy().copy()


def test_main_data_parallel_matches_one_process(tmp_path):
    """Two ranks (auto DP, batch 2 a rank from interleaved shards) train
    the epoch one process trains: the same train loss and validation RMSE
    within 2e-5 relative, log-vars within 1e-6."""
    from srbh_tpu_torch.train.trainer import main

    write_tiles(tmp_path)
    record = Scalars()
    state = main(_trainer_cfg(tmp_path, "one"), writer=record, device="cpu")
    ranked = pmesh.run_ranks(rank_main, 2, str(tmp_path), "two", False,
                             workdir=str(tmp_path / "ranks"))
    scalars, log_vars = ranked[0]
    assert ranked[1][0] == {}  # only rank 0 writes
    for tag in ("train/loss", "train/rmse", "val/loss", "val/rmse"):
        assert scalars[tag] == pytest.approx(record.scalars[tag],
                                             rel=LOSS_RTOL), tag
    np.testing.assert_allclose(log_vars, state.log_vars.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(ranked[1][1], log_vars)
    assert math.isfinite(scalars["train/loss"][0])


def rank_ragged(root, fsdp):
    """``trainer.main`` in a rank at a batch of 3 over 2 ranks: the error's
    message."""
    from srbh_tpu_torch.train.trainer import main

    cfg = _trainer_cfg(root, "ragged")
    cfg.batch_size = 3
    with pytest.raises(ValueError) as err:
        main(cfg, device="cpu", fsdp=fsdp)
    return str(err.value)


@pytest.mark.parametrize("fsdp", [False, True])
def test_main_refuses_a_batch_the_ranks_do_not_divide(tmp_path, fsdp):
    """Two ranks and a batch of 3: ``main`` raises on every rank rather
    than train a whole copy of the model on each."""
    messages = pmesh.run_ranks(rank_ragged, 2, str(tmp_path), fsdp,
                               workdir=str(tmp_path / "ranks"))
    assert all("divisible by the world size" in m for m in messages), messages


def rank_fsdp(root, logdir, single_checkpoint):
    """``trainer.main(fsdp=True)`` in a rank, then the FSDP2 model's eval
    outputs on a fixed batch, and a single-process checkpoint restored into
    the FSDP2 state and gathered whole again; rank 0 returns them."""
    from srbh_tpu_torch.train.checkpoint import (
        load_checkpoint,
        restore_into_state,
    )
    from srbh_tpu_torch.train.steps import make_predict_step
    from srbh_tpu_torch.train.trainer import main

    state = main(_trainer_cfg(root, logdir, save_opt_state=True), device="cpu",
                 fsdp=True)
    shards = {n: (p.to_local().numel(), p.numel())
              for n, p in state.model.named_parameters()}
    image = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 8)).astype(
        np.float32)
    outs = make_predict_step(state.model, state.sr_model, device="cpu")(image)
    payload = load_checkpoint(single_checkpoint)
    restore_into_state(state, payload)
    back = {"model": whole(state.model.state_dict()),
            "optimizer": whole(state.optimizer.state_dict())}
    if rank() != 0:
        return None
    return ([o.numpy().copy() for o in outs], image, shards, back,
            state.step)
