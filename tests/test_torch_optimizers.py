"""The port's poly-warm-up AdamW against the JAX package's optax one.

The same seeded parameters and the same five gradients (across the end of a
3-step warm-up) go to ``srbh_tpu.train.optimizers.poly_warmup_adamw``
(optax) and to the port's ``torch.optim.AdamW`` + ``LambdaLR``:

* the learning rate of each update against the JAX schedule: within 1e-7
  relative. Both compute it in float32 with the same operations; at power
  1 (the default) they agree bit for bit. At another power the float32
  ``pow`` of XLA and of numpy differ by up to 2 ulps, 2.2e-7 relative
  measured over five powers: that case is held within 2.5e-7.
* the parameters after each of the 5 steps: within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from srbh_tpu.train import optimizers as jopt
from srbh_tpu_torch.train import optimizers
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

KW = dict(base_lr=1e-3, weight_decay=0.05, betas=(0.9, 0.99), warmup_iter=3,
          max_iter=20, warmup_ratio=0.1, power=1.0)
STEPS = 5


@pytest.mark.parametrize("power,tol", [(1.0, 1e-7), (0.9, 2.5e-7)])
def test_schedule_matches_jax(power, tol):
    for warmup, max_iter, ratio in ((3, 20, 0.1), (1500, 80000, 1e-6)):
        want = jopt.poly_warmup_schedule(1e-3, warmup, max_iter, ratio, power)
        got = optimizers.poly_warmup_schedule(1e-3, warmup, max_iter, ratio, power)
        for k in list(range(25)) + [warmup - 1, warmup, max_iter - 1, max_iter + 1]:
            w = float(want(k))
            assert abs(got(k) - w) <= tol * abs(w), (k, got(k), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_five_steps_match_optax(seed):
    rng = np.random.default_rng(seed)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(STEPS)]

    tx = jopt.poly_warmup_adamw(**KW)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt, sched = optimizers.poly_warmup_adamw(list(tparams.values()), **KW)
    schedule = jopt.poly_warmup_schedule(KW["base_lr"], KW["warmup_iter"],
                                         KW["max_iter"], KW["warmup_ratio"],
                                         KW["power"])
    for k, g in enumerate(grads):
        lr = opt.param_groups[0]["lr"]
        assert abs(lr - float(schedule(k))) <= 1e-7 * float(schedule(k))
        updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        sched.step()
        for n, p in tparams.items():
            want = np.asarray(jparams[n])
            got = p.detach().numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (k, n)
