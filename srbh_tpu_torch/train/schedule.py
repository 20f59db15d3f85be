"""Learning-rate schedule, counterpart of ``srbh_tpu/train/schedule.py``.

``step_decay_lr`` mirrors train.py:68-81: full LR through epoch 10, x0.1
through epoch 20, x0.01 after, written to BOTH param groups (the
reference's log_var-group exemption never fires; see ``train/state.py``).
"""
from __future__ import annotations


def step_decay_lr(init_lr: float, epoch: int) -> float:
    """Epoch is 1-based, as in the reference loop (train.py:184)."""
    if epoch <= 10:
        return init_lr
    if epoch <= 20:
        return 0.1 * init_lr
    return 0.01 * init_lr
