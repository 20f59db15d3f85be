"""Process groups, the (data, model) mesh, sharding rules and rank launches.

Counterpart of ``srbh_tpu/parallel/mesh.py``. The JAX package places arrays
on a device mesh and lets GSPMD insert the collectives; here every rank is
a process (``torch.distributed``), and the collectives are written out
(``parallel/collectives.py``, ``parallel/data.py``, and the model-parallel
forms in ``parallel/{tensor,spatial,pipeline}.py``).

* :func:`initialize_distributed` joins a process group: NCCL on the card,
  gloo when the caller asks for ``device="cpu"``; torchrun's environment by
  default (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``).
* :func:`make_mesh`: a ``DeviceMesh`` of dims ``("data", "model")`` over
  every rank (the JAX form may take a subset of the devices; a torch mesh
  spans the whole group). The JAX form's topology-aware placement has no
  counterpart: ranks are placed row-major.
* :func:`fsdp_param_spec` and :func:`tp_param_spec`: the JAX rules for torch
  layouts (conv weights OIHW, linear weights (out, in)); each returns the
  dim to shard, or ``None``.
* :func:`shard_batch` / :func:`gather_batch`: a rank's rows of a global
  batch, interleaved (rank ``r`` of ``W`` holds rows ``r, r + W, ...``, as
  the loader's ``idx[r::W]`` shards give it), and the global batch back.
* :func:`replicate` broadcasts from the group's first rank;
  :func:`shard_state_fsdp` is FSDP2's ``fully_shard`` on each block.
* :func:`run_ranks` starts ``n`` processes (gloo on the CPU, NCCL on ``n``
  cards) that meet through a file store, runs a function in each and
  returns what each returned.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.parallel.collectives import rank, world

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device=None) -> torch.device:
    """Join the process group (once; a second call changes nothing) and
    return this rank's device. ``init_method`` ``None`` reads torchrun's
    environment (``env://``), as do ``world_size`` / ``rank`` left ``None``.
    On the card (``device=None``) the backend is NCCL and the rank is bound
    to the card ``LOCAL_RANK`` names; ``device="cpu"`` is gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``DeviceMesh`` of dims ``("data", "model")`` over every rank of
    the process group; ``n_data`` ``None`` takes what ``n_model`` leaves.
    Raises when the sizes do not make up the group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world()
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks do not divide over n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {n} "
                         f"ranks of the process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def tp_param_spec(x, n_model: int) -> Optional[int]:
    """The dim of a parameter that tensor parallelism splits over
    ``n_model`` ranks, or ``None`` (replicated). Conv (OIHW) and linear
    ((out, in)) weights split their output channels (dim 0), or, where those
    do not divide, their input channels (dim 1; the partial sums are then
    all-reduced); vectors split dim 0."""
    if n_model <= 1 or x.ndim == 0:
        return None
    if x.shape[0] % n_model == 0:
        return 0
    if x.ndim >= 2 and x.shape[1] % n_model == 0:
        return 1
    return None


def fsdp_param_spec(x, n_data: int) -> Optional[int]:
    """The dim FSDP shards a parameter and its Adam moments on over
    ``n_data`` ranks, or ``None`` where no dim divides: the output channels
    (dim 0) first, else the largest divisible dim (B4's squeeze-excite
    reduce kernels, (28, 672, 1, 1) at ``n_data=8``, shard their input
    channels)."""
    if n_data <= 1 or x.ndim == 0:
        return None
    if x.shape[0] % n_data == 0:
        return 0
    divisible = [d for d in range(x.ndim) if x.shape[d] % n_data == 0]
    return max(divisible, key=lambda d: x.shape[d]) if divisible else None


def _rows(x, r: int, n: int):
    if len(x) % n:
        raise ValueError(f"batch of {len(x)} does not divide over {n} ranks")
    return x[r::n]


def shard_batch(batch, group=None):
    """This rank's rows of a global batch (a tensor, an array, a list, or a
    dict of them): rows ``r, r + W, ...`` for rank ``r`` of the group's
    ``W``. Raises when the batch does not divide."""
    r, n = rank(group), world(group)
    if isinstance(batch, dict):
        return {k: _rows(v, r, n) for k, v in batch.items()}
    return _rows(batch, r, n)


# dtypes gloo and NCCL carry as they are; the others travel as int32
_CARRIED = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
            torch.int32, torch.int64, torch.uint8, torch.int8, torch.bool)


def gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch on every rank from each rank's :func:`shard_batch`
    rows (equal shapes), in the global order. Not differentiable."""
    n = world(group)
    if n == 1:
        return x
    carried = (x if x.dtype in _CARRIED else x.to(torch.int32)).contiguous()
    parts = [torch.empty_like(carried) for _ in range(n)]
    dist.all_gather(parts, carried, group=group)
    out = torch.stack(parts, 1).reshape((-1,) + tuple(x.shape[1:]))
    return out.to(x.dtype)


def replicate(obj, group=None):
    """Broadcast a tensor, or a module's parameters and buffers, in place
    from the group's first rank; returns ``obj``."""
    if world(group) == 1:
        return obj
    src = dist.get_global_rank(group, 0) if group is not None else 0
    tensors = ([obj] if isinstance(obj, torch.Tensor)
               else [*obj.parameters(), *obj.buffers()])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return obj


def _blocks(module: nn.Module):
    """The modules FSDP2 wraps one by one, deepest first: each item of an
    ``nn.ModuleList`` or ``nn.Sequential`` that holds parameters and modules
    of its own (an MBConv, a decoder block, an RRDB), then each child of
    ``module`` that holds parameters and is no container."""
    found = []
    for name, m in module.named_modules():
        if isinstance(m, (nn.ModuleList, nn.Sequential)):
            for i, item in enumerate(m):
                if next(item.children(), None) is not None and \
                        next(item.parameters(), None) is not None:
                    found.append((f"{name}.{i}", item))
    found.sort(key=lambda nm: -nm[0].count("."))
    taken = {id(m) for _, m in found}
    found += [(n, m) for n, m in module.named_children()
              if id(m) not in taken
              and not isinstance(m, (nn.ModuleList, nn.ModuleDict))
              and next(m.parameters(), None) is not None]
    return [m for _, m in found]


def shard_state_fsdp(module: nn.Module, mesh) -> nn.Module:
    """FSDP2: ``fully_shard`` on each block (:func:`_blocks`), then on
    ``module``, over the mesh's data dim, each parameter split on the dim
    :func:`fsdp_param_spec` names (dim 0, in uneven chunks, where it names
    none: FSDP2 shards every parameter it holds). Its gradients are then
    reduce-scattered and averaged over the data ranks in the backward pass,
    and an optimizer built afterwards keeps its moments in the same shards.
    The module must sit on its device already. Returns ``module``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    data = mesh[DATA_AXIS]
    n = data.size()

    def place(p):
        d = fsdp_param_spec(p, n)
        return Shard(0 if d is None else d)

    for block in _blocks(module):
        fully_shard(block, mesh=data, shard_placement_fn=place)
    fully_shard(module, mesh=data, shard_placement_fn=place)
    return module


def _rank_main(r: int, fn: Callable, n: int, store: str, device: str,
               out_dir: str, args: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(r)
    initialize_distributed(f"file://{store}", n, r, device)
    result = fn(*args)
    torch.save(result, os.path.join(out_dir, f"rank{r}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, *args, device: str = "cpu",
              workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in ``n`` new processes that form one process group
    (gloo with one torch thread each on the CPU, NCCL on cards 0..n-1 for
    ``device="cuda"``), meeting through a file store in ``workdir`` (a new
    temporary directory if ``None``); returns each rank's result, rank 0
    first. ``fn`` must be importable by name (a module-level function). A
    rank that raises ends the others, and this raises with its traceback."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    own = workdir is None
    root = tempfile.mkdtemp(prefix="ranks_") if own else workdir
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "store")
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(_rank_main, args=(fn, n, store, device, root, args),
                       nprocs=n, join=True, start_method="spawn")
    results = [torch.load(os.path.join(root, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)]
    if own:
        shutil.rmtree(root)
    return results

