"""The five parallel modes on the RRDBNet trunk, each held to one process.

    python -m srbh_tpu_torch.examples.parallel_modes [--ranks 2] [--cpu]

The port's twin of ``examples/parallel_modes.py``. It starts ``--ranks``
processes that form one process group (``parallel/mesh.py:run_ranks``:
NCCL on as many cards by default, gloo with ``--cpu``), runs a small
RRDBNet's feature pass on one batch in each mode, and prints how far each
lies from the plain forward:

* **DP**: the batch's rows over the ``data`` axis, the weights whole on
  every rank (``shard_batch`` / ``gather_batch``);
* **FSDP**: the same rows, the weights sharded over ``data`` by FSDP2
  (``shard_state_fsdp``) and gathered for each block's compute;
* **TP**: each conv's output channels over the ``model`` axis
  (``parallel/tensor.py``);
* **SP**: the image's rows over ``model``, the convs exchanging halo rows
  (``parallel/spatial.py``);
* **PP**: the RRDB body as pipeline stages over ``model``, with
  microbatches (``parallel/pipeline.py``).

DP and FSDP run on a ``(ranks, 1)`` mesh, TP, SP and PP on ``(1, ranks)``.
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

TOL = 1e-4  # float32 sums in another order


def _rank(num_block: int) -> dict:
    """One rank's work: each mode's max |difference| from the plain
    forward."""
    from srbh_tpu_torch.models.layers import init_weights
    from srbh_tpu_torch.models.rrdbnet import RRDBNet
    from srbh_tpu_torch.parallel import mesh as pmesh
    from srbh_tpu_torch.parallel.collectives import world
    from srbh_tpu_torch.parallel.pipeline import rrdb_pipeline_features
    from srbh_tpu_torch.parallel.spatial import (
        gather_rows,
        spatial_parallel,
        split_rows,
    )
    from srbh_tpu_torch.parallel.tensor import tensor_parallel

    n = world()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
    sr = RRDBNet(num_block=num_block, num_feat=16, num_grow_ch=8)
    init_weights(sr, torch.Generator().manual_seed(0))
    sr = sr.eval().to(dev)
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, (2 * n, 3, 16, 16)).astype(np.float32), device=dev)
    out = {}
    with torch.no_grad():
        ref = sr(x, features_only=True)
        mesh = pmesh.make_mesh()
        data = mesh.get_group(pmesh.DATA_AXIS)
        local = pmesh.shard_batch(x, data)
        out["DP"] = pmesh.gather_batch(sr(local, features_only=True), data)
        fsdp = pmesh.shard_state_fsdp(copy.deepcopy(sr), mesh)
        out["FSDP"] = pmesh.gather_batch(fsdp(local, features_only=True), data)
        mesh_mp = pmesh.make_mesh(n_model=n)
        model = mesh_mp.get_group(pmesh.MODEL_AXIS)
        out["TP"] = tensor_parallel(sr, model)(x, features_only=True)
        band = spatial_parallel(sr, model)(split_rows(x, model),
                                           features_only=True)
        out["SP"] = gather_rows(band, model)
        out["PP"] = rrdb_pipeline_features(sr, x, mesh_mp, num_microbatches=n)
    return {k: (v - ref).abs().max().item() for k, v in out.items()}


def main(ranks: int = 2, device=None) -> dict:
    """Run the modes over ``ranks`` processes: ``ranks`` cards by default
    (fewer raise), gloo on the CPU with ``device="cpu"``. Prints and
    returns each mode's max |difference| from the plain forward; raises if
    one exceeds ``TOL``."""
    from srbh_tpu_torch.parallel.mesh import run_ranks

    if device is None:
        if torch.cuda.device_count() < ranks:
            raise RuntimeError(
                f"parallel_modes over {ranks} ranks needs {ranks} CUDA "
                f"devices and sees {torch.cuda.device_count()}; pass "
                f"device='cpu' to run {ranks} gloo processes on the CPU")
        kind = "cuda"
    else:
        kind = torch.device(device).type
    # PP puts an equal share of the body on every rank
    diffs = run_ranks(_rank, ranks, 2 * ranks, device=kind)[0]
    for mode, err in diffs.items():
        print(f"{mode:4s} max|diff| = {err:.3g}")
    bad = {m: e for m, e in diffs.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"modes off the plain forward: {bad}")
    print(f"all five modes match the plain forward over {ranks} ranks")
    return diffs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m srbh_tpu_torch.examples.parallel_modes")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(args.ranks, device="cpu" if args.cpu else None)
