"""The port's public surface held to the JAX package's.

Both trees are read with ``ast``; neither package is imported. For each
module of ``srbh_tpu/``, its twin under ``srbh_tpu_torch/`` (the same
relative path, but for :data:`RENAMES`) must bind every public top-level
name of the JAX module (a ``def``, a ``class`` or an assignment to a name
without a leading underscore; in the twin an import binds a name too) and
accept every ``add_argument`` flag of it. Each name the port lacks on
purpose stands in :data:`DELIBERATE` with its reason, and an entry whose
name the port has since gained fails as stale.
"""
import ast
from functools import lru_cache
from pathlib import Path

import pytest

from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "srbh_tpu", REPO / "srbh_tpu_torch"

# JAX module -> its twin's path under srbh_tpu_torch/
RENAMES = {
    "ops/pallas/__init__.py": "ops/__init__.py",
    "ops/pallas/window_attention.py": "ops/window_attention.py",
    "train/convert.py": "convert.py",
}
NO_TWIN = {
    "tools/_cache.py": "JAX's persistent compilation cache",
    "tools/_hlo.py": "reads XLA's HLO text; the port lists kernels with "
                     "torch.profiler (tools/_trace.py)",
}

_JAX_DTYPE = "a typing alias of JAX dtypes; the port annotates torch.dtype"
_FLAX_INIT = ("a flax initialiser; the port's modules start from torch's own "
              "init or models/layers.py:init_weights")
_JAX_SHARDING = ("a jax.sharding spec; the port shards with DDP, FSDP2 and "
                 "process groups (parallel/mesh.py, tensor.py, spatial.py)")
_REPEATS = ("a module constant of the JAX tool; the port's tool takes the "
            "repeats as run()'s argument and --repeats")
_CHAIN = ("the length of the relay-proof fori_loop chain; the port times on "
          "the card's clock (tools/timing.py)")
_TORCH_TO_FLAX = ("converts a torch state dict to flax variables; the port's "
                  "modules load the reference's torch state dict as it is, and "
                  "its convert.py goes the other way (JAX npz -> torch)")
_COUNTS = ("the port's converter reads block and layer counts from the npz "
           "(convert.py:_count)")

DELIBERATE = {
    ("models/clip.py", "Dtype"): _JAX_DTYPE,
    ("models/efficientnet.py", "Dtype"): _JAX_DTYPE,
    ("models/layers.py", "Dtype"): _JAX_DTYPE,
    ("models/lpips.py", "Dtype"): _JAX_DTYPE,
    ("models/layers.py", "kaiming_normal_scaled"): _FLAX_INIT,
    ("models/layers.py", "torch_conv_default_init"): _FLAX_INIT,
    ("ops/device_aug.py", "augment_sample"):
        "draws with a JAX key per sample; the port draws a batch's "
        "augmentation at once with draw_augment (one torch.Generator)",
    ("ops/pallas/window_attention.py", "window_attention_pallas"):
        "renamed: the Hopper kernel's wrapper is window_attention",
    ("ops/pallas/window_attention.py", "window_attention_xla"):
        "renamed: the plain version is window_attention_reference",
    ("ops/pallas/window_attention.py", "window_attention_auto"):
        "picks Pallas or XLA by backend; the port's SwinIR picks with "
        "use_kernel, and a CUDA tensor always gets the kernel",
    ("ops/pallas/window_attention.py", "DEFAULT_CHUNK"):
        "the Pallas grid's windows per step; the CUDA kernel's launch shape "
        "is set in csrc/window_attention.cu",
    ("parallel/mesh.py", "batch_sharding"): _JAX_SHARDING,
    ("parallel/mesh.py", "replicated"): _JAX_SHARDING,
    ("parallel/mesh.py", "shard_params_tp"): _JAX_SHARDING,
    ("parallel/mesh.py", "spatial_sharding"): _JAX_SHARDING,
    ("parallel/pipeline.py", "stack_stage_params"):
        "stacks the stages' params for one shard_map; each rank of the "
        "port's pipeline holds its own stage's module",
    ("tools/export_model.py", "make_serving_fn"):
        "a jax.export serving function; the port exports with torch.export "
        "(export_flagship)",
    ("tools/train_bench.py", "build_chained"): _CHAIN,
    ("tools/profile_flagship.py", "CHAIN_ITERS"): _CHAIN,
    ("tools/train_diag.py", "CHAIN"): _CHAIN,
    ("tools/ref_bench.py", "build_reference_pipeline"):
        "builds the JAX tf.data-style threaded pipeline; the port times its "
        "own loader (--repeats)",
    ("tools/ref_bench.py", "--batches"):
        "the JAX pipeline's batch count; the port's tool takes --repeats",
    ("tools/ref_bench.py", "--threads"):
        "the JAX pipeline's thread count; the port's loader forks processes",
    ("tools/conv_microbench.py", "REPEATS"): _REPEATS,
    ("tools/profile_flagship.py", "REPEATS"): _REPEATS,
    ("tools/sr_train_bench.py", "REPEATS"): _REPEATS,
    ("tools/train_bench.py", "REPEATS"): _REPEATS,
    ("tools/train_diag.py", "REPEATS"): _REPEATS,
    ("tools/conv_microbench.py", "B"):
        "the JAX tool's batch constant; the port's takes --batch",
    ("tools/train_diag.py", "run"):
        "the port's entry points are diagnose() and main()",
    ("train/checkpoint.py", "commit_payload"):
        "swaps orbax directories; the port's single-file os.replace is "
        "already atomic",
    ("train/state.py", "torch_adam"):
        "an optax Adam with torch's update; the port uses torch.optim.Adam",
    ("train/state.py", "set_learning_rate"):
        "a method of the port's TrainState (TrainState.set_learning_rate)",
    ("train/trainer.py", "init_models"): "renamed: build_models",
    ("train/trainer.py", "load_sr_params"): "renamed: load_sr_weights",
    ("train/convert.py", "convert_espcn"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_edsr"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_rrdbnet"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_rrdbnet_simple"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_unet_discriminator_sn"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_swinir"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_basic_block"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_hrfuse_residual"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_efficientnet_imagenet"): _TORCH_TO_FLAX,
    ("train/convert.py", "convert_height_model"): _TORCH_TO_FLAX,
    ("train/convert.py", "load_imagenet_encoder"):
        "the port grafts an efficientnet-pytorch state dict with "
        "convert.graft_encoder",
    ("train/convert.py", "graft_encoder_npz"):
        "the port grafts an encoder npz with convert.graft_encoder and "
        "encoder_state_dict_from_npz",
    ("train/convert.py", "load_torch_tar"):
        "the port reads a torch file with torch.load",
    ("train/convert.py", "--num-block"): _COUNTS,
    ("train/convert.py", "--n-resblocks"): _COUNTS,
    ("train/convert.py", "--depths"): _COUNTS,
    ("train/convert.py", "--no-strict"):
        "a partial load of a torch EDSR file; the port's converter reads a "
        "JAX npz and loads torch files with load_state_dict(strict=False)",
    ("train/convert.py", "--in-channels"):
        "widens an ImageNet stem; the port widens it to the model's input "
        "in convert.graft_encoder (widen_stem)",
}


@lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(tree: ast.Module) -> set:
    """Public top-level names a module defines."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _bound(tree: ast.Module) -> set:
    """Every top-level name a module binds, imports included."""
    names = set(_public(tree))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _flags(tree: ast.Module) -> set:
    """The string arguments of every ``add_argument`` call."""
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"
            for a in n.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)}


def _twin(module: str) -> Path:
    return PORT / RENAMES.get(module, module)


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py")
                     if p.relative_to(JAX).as_posix() not in NO_TWIN)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_jax_surface(module):
    twin = _twin(module)
    assert twin.is_file(), f"{module} has no twin at {twin.relative_to(REPO)}"
    jax_tree, port_tree = _tree(JAX / module), _tree(twin)
    wanted = _public(jax_tree) | _flags(jax_tree)
    have = _bound(port_tree) | _flags(port_tree)
    missing = sorted(n for n in wanted - have if (module, n) not in DELIBERATE)
    assert missing == [], (f"{twin.relative_to(REPO)} lacks {missing} of "
                           f"srbh_tpu/{module}: port them, or give each a "
                           "reason in DELIBERATE")


@pytest.mark.parametrize("entry", sorted(DELIBERATE), ids="::".join)
def test_deliberate_entry_is_not_stale(entry):
    module, name = entry
    assert DELIBERATE[entry].strip()
    jax_tree = _tree(JAX / module)
    assert name in _public(jax_tree) | _flags(jax_tree), \
        f"srbh_tpu/{module} no longer has {name}: drop the entry"
    port_tree = _tree(_twin(module))
    assert name not in _bound(port_tree) | _flags(port_tree), \
        f"the port now has {name}: drop its DELIBERATE entry"


@pytest.mark.parametrize("module", sorted(NO_TWIN))
def test_modules_without_a_twin_still_exist(module):
    assert (JAX / module).is_file() and NO_TWIN[module].strip()
    assert not _twin(module).exists()
