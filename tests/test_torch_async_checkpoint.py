"""The port's asynchronous height checkpoints on the CPU.

``save_checkpoint(..., async_save=True)`` against the synchronous save and
against the JAX package's semantics (``srbh_tpu/train/checkpoint.py:57-135``,
``tests/test_train.py::test_async_save_commits_and_serialises``,
``tests/test_review11_fixes.py::test_async_save_errors_propagate``):

* its ``checkpoint``, ``checkpoint{epoch}`` and ``model_best`` are byte for
  byte the synchronous save's;
* it returns before the file is written, and an optimizer step made after it
  returns (parameters and Adam moments updated in place) does not reach the
  file, which holds the state as it was at the call, bit for bit;
* two saves in a row serialise, and the last one's file stands;
* a failed write re-raises as ``RuntimeError("async checkpoint save
  failed")`` at ``wait_for_saves`` or at the next save, once;
* ``trainer.main(async_checkpoint=True)`` leaves the files of the
  synchronous run (tensors equal) and resumes to the same step, its
  parameters within 1e-6 of the uninterrupted run's (the rule of
  ``tests/test_torch_trainer.py``).
"""
import os
import threading

import pytest
import torch
from torch import nn

from srbh_tpu_torch.train import checkpoint
from srbh_tpu_torch.train.state import TrainState
from srbh_tpu_torch.train.trainer import main
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_trainer import data, make_cfg  # noqa: F401 (fixture)

FILES = ("checkpoint", "checkpoint5", "model_best")


def _state(seed=0):
    """A small train state after one Adam step, so it holds moments."""
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.Conv2d(4, 2, 1))
    state = TrainState(model, n_log_vars=3)
    _step(state)
    return state


def _step(state):
    x = torch.randn(2, 3, 8, 8)
    loss = state.model(x).square().mean() + state.log_vars.sum()
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1


def _snapshot(state):
    """What the file must hold: host clones of the state's tensors."""
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "log_vars": state.log_vars.detach().clone(),
            "optimizer": {i: {k: v.clone() for k, v in st.items()}
                          for i, st in state.optimizer.state_dict()["state"].items()}}


def _same(payload, snap):
    assert payload["model"].keys() == snap["model"].keys()
    for k, v in snap["model"].items():
        assert torch.equal(payload["model"][k], v), k
    assert torch.equal(payload["log_vars"], snap["log_vars"])
    for i, st in snap["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(payload["optimizer"]["state"][i][k], v), (i, k)


@pytest.fixture(autouse=True)
def _no_save_in_flight():
    yield
    checkpoint._pending = None


def test_async_save_writes_what_a_sync_save_writes(tmp_path):
    state = _state()
    for name, async_save in (("sync", False), ("async", True)):
        os.makedirs(tmp_path / name)
        checkpoint.save_checkpoint(str(tmp_path / name), state, 5, 1.5,
                                   is_best=True, async_save=async_save)
    checkpoint.wait_for_saves()
    for f in FILES:
        assert (tmp_path / "sync" / f).read_bytes() == (tmp_path / "async" / f).read_bytes(), f


def test_a_step_after_the_call_does_not_reach_the_file(tmp_path, monkeypatch):
    state = _state()
    release = threading.Event()
    save = checkpoint._save
    monkeypatch.setattr(checkpoint, "_save",
                        lambda payload, path: release.wait(30) and save(payload, path))
    snap = _snapshot(state)
    path = checkpoint.save_checkpoint(str(tmp_path), state, 1, 2.0,
                                      async_save=True)
    assert not os.path.exists(path)  # returned before the file is written
    _step(state)  # parameters and moments change in place
    release.set()
    checkpoint.wait_for_saves()
    payload = checkpoint.load_checkpoint(path)
    assert payload["epoch"] == 1 and payload["step"] == 1
    _same(payload, snap)
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, snap["model"][k])]
    assert moved  # the live state went on


def test_two_async_saves_serialise_and_the_last_wins(tmp_path):
    state = _state()
    checkpoint.save_checkpoint(str(tmp_path), state, 1, 9.0, async_save=True)
    first = checkpoint._pending
    _step(state)
    snap = _snapshot(state)
    checkpoint.save_checkpoint(str(tmp_path), state, 2, 8.0, async_save=True)
    assert first.done()  # the second save joined the first
    checkpoint.wait_for_saves()
    payload = checkpoint.load_checkpoint(str(tmp_path / "checkpoint"))
    assert payload["epoch"] == 2 and payload["best_rmse"] == 8.0
    _same(payload, snap)


@pytest.mark.parametrize("where", ["wait_for_saves", "next save"])
def test_a_failed_write_raises_once(tmp_path, monkeypatch, where):
    state = _state()

    def full_disk(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_save", full_disk)
    checkpoint.save_checkpoint(str(tmp_path), state, 1, 1.0, async_save=True)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        if where == "wait_for_saves":
            checkpoint.wait_for_saves()
        else:
            checkpoint.save_checkpoint(str(tmp_path), state, 2, 1.0,
                                       async_save=True)
    assert isinstance(err.value.__cause__, OSError)
    checkpoint.wait_for_saves()  # reported once
    assert not os.path.exists(tmp_path / "checkpoint")


def _files(logdir):
    return {f: torch.load(os.path.join(logdir, f), weights_only=True)
            for f in sorted(os.listdir(logdir)) if f.startswith(("checkpoint", "model_best"))}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_main_with_async_checkpoints_writes_and_resumes_alike(data):  # noqa: F811
    sync = main(make_cfg(data, "sync", 2), device="cpu")
    cfg = make_cfg(data, "async_whole", 2)
    cfg.async_checkpoint = True
    whole = main(cfg, device="cpu")
    assert checkpoint._pending is None  # main joined its last save
    got, want = _files(cfg.logdir), _files(str(data / "sync"))
    assert sorted(got) == sorted(want) and "checkpoint" in got
    for f in want:
        assert _equal(got[f], want[f]), f
    assert whole.step == sync.step == 4

    first = make_cfg(data, "async_resumed", 1)
    first.async_checkpoint = True
    main(first, device="cpu")
    first.maxepoch = 2
    resumed = main(first, device="cpu")
    assert resumed.step == sync.step
    live = sync.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, live[k], rtol=0, atol=1e-6, msg=k)
