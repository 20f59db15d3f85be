"""The port's trainer on the CPU at a tiny configuration.

``srbh_tpu_torch.train.trainer.main`` trains 2 epochs of 2 steps on
synthetic tiles (8 tiles of 32x32, batch 4; ``efficientnet-test``,
RRDBNet-1 of width 8) and writes ``checkpoint`` and ``model_best``; a run
stopped after epoch 1 and resumed ends in the same state as the
uninterrupted run, within 1e-6. Checkpoints reload to an identical state,
and a JAX package ``.npz`` checkpoint loads through
``convert.train_state_from_jax``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbh_tpu.models import SRRegressClsFeature as JaxModel
from srbh_tpu.train.convert import save_tree_npz
from srbh_tpu.train.state import TrainState as JaxState
from srbh_tpu_torch import convert
from srbh_tpu_torch.data.tiff import write_tiff
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.train import checkpoint
from srbh_tpu_torch.train.config import TrainConfig, get_args
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.trainer import build_models, main
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_e2e")
    rng = np.random.default_rng(0)
    names = [f"t_{i}.tif" for i in range(8)]
    for d in ("s2c", "s1c", "bhc"):
        os.makedirs(root / d)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    for n in names:
        write_tiff(str(root / "s2c" / n),
                   rng.integers(0, 5000, (32, 32, 6)).astype(np.uint16), gt)
        write_tiff(str(root / "s1c" / n),
                   rng.uniform(-25, 5, (32, 32, 2)).astype(np.float32), gt)
        write_tiff(str(root / "bhc" / n),
                   rng.integers(0, 100, (128, 128)).astype(np.uint8),
                   (gt[0], 2.5, 0, gt[3], 0, -2.5))
    for split in ("train", "val"):
        with open(root / f"dl_{split}.csv", "w") as f:
            f.writelines(f"{n},s1c,s2c,bhc\n" for n in names)
    np.savetxt(root / "s2c_minmax.txt", np.stack([np.zeros(6), np.full(6, 5000.0)]))
    np.savetxt(root / "s1c_minmax.txt", np.stack([np.full(2, -25.0), np.full(2, 5.0)]))
    hist = np.zeros(256)
    hist[:100] = 1000
    np.savetxt(root / "bh_stats.txt", hist)
    return root


def make_cfg(root, logdir, maxepoch, **kw) -> TrainConfig:
    return TrainConfig(
        datapath=str(root), trainlist="dl_train.csv", vallist="dl_val.csv",
        logdir=str(root / logdir), logdirhr=str(root / "no_sr_ckpt"),
        datastats=str(root), preweight=str(root / "bh_stats.txt"),
        s1dir="s1c", s2dir="s2c", bhdir="bhc", maxepoch=maxepoch,
        batch_size=4, num_workers=2, encoder_name="efficientnet-test",
        super_mid=8, sr_num_block=1, sr_num_feat=8, sr_num_grow=8, tile=32,
        **kw)


def _state(state):
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return sd, state.log_vars.detach().clone(), state.step


@pytest.fixture(scope="module")
def runs(data):
    # the optimizer state is saved, so the resumed run continues exactly
    exact = dict(save_opt_state=True)
    whole = _state(main(make_cfg(data, "whole", 2, **exact), device="cpu"))
    first = _state(main(make_cfg(data, "resumed", 1, **exact), device="cpu"))
    resumed = _state(main(make_cfg(data, "resumed", 2, **exact), device="cpu"))
    return whole, first, resumed


def test_main_trains_and_writes_checkpoints(data, runs, capsys):
    whole, first, _ = runs
    assert whole[2] == 4 and first[2] == 2  # 8 tiles / batch 4 per epoch
    for name in ("checkpoint", "model_best"):
        assert os.path.isfile(data / "whole" / name)
    payload = checkpoint.load_checkpoint(str(data / "whole" / "checkpoint"))
    assert payload["epoch"] == 2 and payload["step"] == 4
    assert np.isfinite(payload["best_rmse"])
    changed = [k for k, v in whole[0].items()
               if k.endswith("weight") and not torch.equal(v, first[0][k])]
    assert changed  # epoch 2 trained


def test_resume_ends_where_the_uninterrupted_run_ends(runs):
    (sd_a, lv_a, step_a), _, (sd_b, lv_b, step_b) = runs
    assert step_a == step_b == 4
    assert set(sd_a) == set(sd_b)
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=1e-6, msg=k)
    torch.testing.assert_close(lv_b, lv_a, rtol=0, atol=1e-6)


def test_checkpoint_reloads_to_an_identical_state(data, runs):
    cfg = make_cfg(data, "whole", 2)
    model, _ = build_models(cfg)
    state = TrainState(model)
    checkpoint.restore_into_state(
        state, checkpoint.load_checkpoint(os.path.join(cfg.logdir, "checkpoint")))
    sd, lv, step = _state(state)
    whole = runs[0]
    assert step == whole[2]
    for k, v in whole[0].items():
        assert torch.equal(sd[k], v), k
    assert torch.equal(lv, whole[1])
    assert len(state.optimizer.state) == len(list(model.parameters())) + 1


def test_jax_npz_checkpoint_loads(tmp_path):
    dec = (32, 24, 16, 12, 8)
    jm = JaxModel(encoder_name="efficientnet-test", super_mid=8, isaggre=True,
                  chans_build=7, decoder_channels=dec)
    variables = jax.device_get(dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 8)),
        jnp.zeros((1, 128, 128, 8)))))
    jstate = JaxState.create(variables, n_log_vars=3)
    grads = jax.tree_util.tree_map(jnp.ones_like, jstate.params)
    jstate = jax.jit(JaxState.apply_gradients)(jstate, grads, jnp.ones(3),
                                               jnp.float32(1e-3))
    # the layout of the JAX package's tar-to-npz converter: no optimizer
    path = str(tmp_path / "height.npz")
    save_tree_npz(path, {
        "params": jax.device_get(jstate.params),
        "batch_stats": variables["batch_stats"],
        "log_vars": {"w1": np.float32(0.5), "w2": np.float32(-1.0),
                     "w3": np.float32(2.0)},
        "meta": {"epoch": np.int32(7), "best_acc": np.float32(3.5)}})
    payload = checkpoint.load_checkpoint(path, "efficientnet-test", True)
    assert payload["epoch"] == 7 and payload["best_rmse"] == 3.5
    state = TrainState(SRRegressClsFeature(
        "efficientnet-test", super_mid=8, isaggre=True, chans_build=7,
        sr_chans=8, decoder_channels=dec))
    checkpoint.restore_into_state(state, payload)
    want = convert.height_model_state_dict(
        {"params": jax.device_get(jstate.params),
         "batch_stats": variables["batch_stats"]}, "efficientnet-test", True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert state.log_vars.tolist() == [0.5, -1.0, 2.0]
    assert state.step == 0 and not state.optimizer.state  # Adam starts anew


def test_get_args_takes_the_flags_of_train_py():
    cfg = get_args(argv=["--batch_size", "8", "--bf16", "true", "--hir",
                         "0", "5", "256", "--logdir", "/x"])
    assert (cfg.batch_size, cfg.bf16, cfg.hir, cfg.logdir) == (8, True,
                                                              (0, 5, 256), "/x")
    assert get_args("beijing", []).trainlist == "datalist_beijing_train_0.7.csv"


def test_main_fsdp_needs_a_process_group(data):
    cfg = make_cfg(data, "no_group", 1)
    cfg.fsdp = True
    with pytest.raises(RuntimeError, match="process group"):
        main(cfg, device="cpu")


def test_main_runs_fsdp_on_two_ranks(data, tmp_path):
    """``--fsdp``: two gloo ranks train an epoch under FSDP2 (2 steps of 2
    tiles a rank). Rank 0 writes the checkpoint gathered whole, in the
    single process's form: it loads into the single-process port, whose
    predictions on a fixed batch equal the FSDP2 model's (within 1e-6).
    The other way, a single-process checkpoint restored into the FSDP2
    state gathers back to the same tensors, Adam's moments included."""
    from srbh_tpu_torch.parallel.mesh import run_ranks
    from srbh_tpu_torch.train.steps import make_predict_step
    from test_torch_parallel_train import rank_fsdp

    main(make_cfg(data, "one_for_fsdp", 1, save_opt_state=True), device="cpu")
    single = os.path.join(data, "one_for_fsdp", "checkpoint")
    outs, image, shards, back, step = run_ranks(
        rank_fsdp, 2, str(data), "fsdp", single,
        workdir=str(tmp_path))[0]
    assert step == 2
    assert any(local < full for local, full in shards.values())
    payload = checkpoint.load_checkpoint(os.path.join(data, "fsdp",
                                                      "checkpoint"))
    assert payload["epoch"] == 1 and payload["step"] == 2
    cfg = make_cfg(data, "fsdp", 1)
    model, sr = build_models(cfg)
    model.load_state_dict(payload["model"])
    TrainState(model).optimizer.load_state_dict(payload["optimizer"])
    want = make_predict_step(model, sr, device="cpu")(image)
    for got, w in zip(outs, want):
        torch.testing.assert_close(torch.from_numpy(got), w, rtol=0,
                                   atol=1e-6)
    reference = checkpoint.load_checkpoint(single)
    for k, v in reference["model"].items():
        assert torch.equal(back["model"][k], v), k
    for i, st in reference["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(back["optimizer"]["state"][i][k], v), (i, k)
