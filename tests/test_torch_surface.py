"""The port's public surface held to the JAX package's.

Both trees are read with ``ast``; neither package is imported. For each
module of ``srbh_tpu/``, its twin under ``srbh_tpu_torch/`` (the same
relative path, but for :data:`RENAMES`) must bind every public top-level
name of the JAX module (a ``def``, a ``class`` or an assignment to a name
without a leading underscore; in the twin an import binds a name too) and
accept every ``add_argument`` flag of it. Each name the port lacks on
purpose stands in :data:`DELIBERATE` with its reason, and an entry whose
name the port has since gained fails as stale.

The same holds one level down, for each public function and class of a JAX
module whose twin binds the same name: the twin must take every parameter
of the JAX function; a flax module's or a dataclass's fields must be
parameters of the twin's ``__init__`` (or its fields); and a plain class's
public methods must be the twin's methods (a twin class's bases in its own
module count). A parameter the port renamed stands in :data:`PARAM_RENAMES`
with the twin's name; one the port lacks on purpose stands in
:data:`DELIBERATE_PARAMS` with its reason. Either entry fails as stale when
the JAX package drops the parameter or the port gains it.
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


# ------------------------------------------------------------ parameters

_FUNCTIONAL = ("a variables tree of flax's functional apply; the port's "
               "modules hold their parameters and buffers")
_STATE = ("a field or constructor of the immutable flax train state; the "
          "port's state is a mutable object holding its modules and "
          "torch.optim optimizers")
_COMPUTE_DTYPE = ("the flax module's compute dtype; the port's module "
                  "computes in its parameters' dtype (.to(dtype)) or under "
                  "torch.autocast")
_JAX_KEY = ("a JAX PRNG key; the port draws from a torch.Generator "
            "(generator=) or takes the drawn values")
_JAX_EXPORT = ("jax.export's artifact and platforms; the port exports a "
               "torch.export ExportedProgram")
_TOOL_MAIN = ("a keyword argument of the JAX tool's main(); the port's "
              "main(argv) takes it as a flag, which test_port_has_the_jax_"
              "surface holds")
_PACKED = ("the packed (space-to-depth) form as a field; the port's packed "
           "forms are methods and functions of ops/s2d.py on the literal "
           "module's parameters (forward_packed, packed_output=)")
_MESH = ("a jax.sharding.Mesh; the port's function takes the torch process "
         "group of the data axis (group=)")
_FLAX_NAME = "a flax submodule's name; torch names a child by its attribute"
_PALLAS_TRAIN = ("the JAX blocks decide the shift from static_size; the "
                 "port's from img_size")

# (JAX module, function or class, parameter) -> the twin's parameter name
PARAM_RENAMES = {
    ("models/layers.py", "tconv", "features"): "out_ch",
    ("models/layers.py", "tconv", "use_bias"): "bias",
    ("models/layers.py", "ConvBNAct", "features"): "out_ch",
    ("models/layers.py", "TorchBatchNorm", "epsilon"): "eps",
    ("models/swinir.py", "WindowAttention", "use_pallas"): "use_kernel",
    ("models/swinir.py", "SwinTransformerBlock", "use_pallas"): "use_kernel",
    ("models/swinir.py", "SwinTransformerBlock", "static_size"): "img_size",
    ("models/swinir.py", "RSTB", "use_pallas"): "use_kernel",
    ("models/swinir.py", "RSTB", "static_size"): "img_size",
    ("models/swinir.py", "SwinIR", "use_pallas"): "use_kernel",
    ("ops/device_aug.py", "flip", "arr"): "x",
    ("ops/device_aug.py", "flip", "d"): "code",
    ("ops/device_aug.py", "grid_shuffle_2x2", "arr"): "x",
    ("ops/device_aug.py", "rotate_mask_nearest", "angle_deg"): "angle",
    ("ops/device_aug.py", "rotate_image_lowres", "img_lr"): "img",
    ("ops/device_aug.py", "rotate_image_lowres", "angle_deg"): "angle",
    ("ops/quant.py", "quantize_weight", "axis"): "dim",
    ("ops/quant.py", "int8_conv", "kernel"): "weight",
    ("parallel/mesh.py", "initialize_distributed", "coordinator"):
        "init_method",
    ("parallel/mesh.py", "initialize_distributed", "num_processes"):
        "world_size",
    ("parallel/mesh.py", "initialize_distributed", "process_id"): "rank",
    ("parallel/mesh.py", "replicate", "tree"): "obj",
    ("parallel/mesh.py", "shard_state_fsdp", "tree"): "module",
    ("tools/export_model.py", "export_flagship", "sr_model"): "sr",
    ("train/sr_trainer.py", "adapt_weights_to_1ch", "params"): "state_dict",
}

_DTYPE_OWNERS = {
    "models/clip.py": ("ResidualAttentionBlock", "CLIPVisionTransformer",
                       "MAPVisionTransformer"),
    "models/discriminators.py": ("UNetDiscriminatorSN",
                                 "VGGStyleDiscriminator"),
    "models/edsr.py": ("ResBlock", "EDSR"),
    "models/efficientnet.py": ("MBConv", "EfficientNetEncoder"),
    "models/espcn.py": ("ESPCN",),
    "models/height_model.py": ("SRRegressClsFeature", "SRRegressClsNosuper",
                               "SRRegressClsFeatureGeo",
                               "SRRegressClsFeatureRefine"),
    "models/hrfuse.py": ("HRFeature", "HRFuseResidual", "HRFuse", "HRFuseX2",
                         "HRUpsample", "GeoNet", "RefineResidual"),
    "models/layers.py": ("tconv", "TorchBatchNorm", "ConvBNAct", "BasicBlock",
                         "PixelShuffleUpsampler"),
    "models/lpips.py": ("AlexNetFeatures", "LPIPS"),
    "models/rrdbnet.py": ("ResidualDenseBlock", "RRDB", "RRDBNet",
                          "RRDBNetSimple"),
    "models/sr_regress.py": ("SRRegress", "SRRegressClsEDSR",
                             "SRRegressClsDecision"),
    "models/swinir.py": ("WindowAttention", "Mlp", "SwinTransformerBlock",
                         "RSTB", "SwinIR"),
    "models/unet_decoder.py": ("DecoderBlock", "UnetDecoder"),
    "models/vgg.py": ("VGG19Features",),
    "ops/s2d.py": ("conv3x3_packed", "conv1x1_packed"),
    "tools/swinir_harness.py": ("define_model",),
    "train/trainer.py": ("build_models",),
}

# (JAX module, function or class, parameter or "method()") -> why the twin
# lacks it
DELIBERATE_PARAMS = {
    **{(m, owner, "dtype"): _COMPUTE_DTYPE
       for m, owners in _DTYPE_OWNERS.items() for owner in owners},
    ("data/augment.py", "grid_shuffle_2x2", "rng"):
        "the port's grid_shuffle_2x2(arr, order) applies a drawn order to "
        "one array; augment_pair draws rng.permutation(4) once and applies "
        "it to the image and the mask (the same draws)",
    ("data/augment.py", "grid_shuffle_2x2", "img"):
        "the port's grid_shuffle_2x2 takes one array (arr) and the order",
    ("data/augment.py", "grid_shuffle_2x2", "mask"):
        "the port's grid_shuffle_2x2 takes one array (arr) and the order",
    ("data/pipeline.py", "DataLoader", "sharding"): _JAX_SHARDING,
    ("losses/sr.py", "g_path_regularize", "key"): _JAX_KEY,
    ("losses/sr.py", "gradient_penalty_loss", "key"): _JAX_KEY,
    ("ops/device_aug.py", "augment_batch", "key"): _JAX_KEY,
    ("metrics/learned.py", "calculate_clipscore", "variables"): _FUNCTIONAL,
    ("metrics/learned.py", "calculate_clipscore_pt", "variables"):
        _FUNCTIONAL,
    ("metrics/learned.py", "calculate_lpips", "variables"): _FUNCTIONAL,
    ("metrics/learned.py", "calculate_lpips_pt", "variables"): _FUNCTIONAL,
    ("models/dual_head.py", "dual_head_apply", "params"): _FUNCTIONAL,
    ("models/dual_head.py", "dual_head_apply", "batch_stats"): _FUNCTIONAL,
    ("parallel/pipeline.py", "rrdb_pipeline_features", "variables"):
        _FUNCTIONAL,
    ("predict/predictor.py", "predict_city", "variables"): _FUNCTIONAL,
    ("predict/predictor.py", "predict_city", "sr_params"): _FUNCTIONAL,
    ("predict/predictor.py", "predict_cities", "variables"): _FUNCTIONAL,
    ("predict/predictor.py", "predict_cities", "sr_params"): _FUNCTIONAL,
    ("tools/export_model.py", "export_flagship", "variables"): _FUNCTIONAL,
    ("tools/export_model.py", "export_flagship", "sr_params"): _FUNCTIONAL,
    ("tools/swinir_harness.py", "run_folder", "variables"): _FUNCTIONAL,
    ("tools/export_model.py", "export_flagship", "platforms"): _JAX_EXPORT,
    ("tools/export_model.py", "load_exported", "data"): _JAX_EXPORT,
    ("models/hrfuse.py", "HRFeature", "packed"): _PACKED,
    ("models/hrfuse.py", "HRFuseResidual", "packed"): _PACKED,
    ("models/layers.py", "BasicBlock", "packed"): _PACKED,
    ("models/layers.py", "BasicBlock", "kin_perm"): _PACKED,
    ("models/layers.py", "PixelShuffleUpsampler", "packed_output"):
        "a forward argument of the port's upsampler (forward(x, "
        "packed_output=True)); the packed form is ops/s2d.py's",
    ("models/layers.py", "tconv", "kernel_init"): _FLAX_INIT,
    ("models/layers.py", "tconv", "name"): _FLAX_NAME,
    ("models/layers.py", "TorchBatchNorm", "use_running_average"):
        "flax's train / eval switch as a field; the port's BatchNorm2d "
        "follows the module's train() / eval() mode",
    ("models/rrdbnet.py", "ResidualDenseBlock", "growth_init"): _FLAX_INIT,
    ("models/rrdbnet.py", "RRDB", "growth_init"): _FLAX_INIT,
    ("parallel/mesh.py", "make_mesh", "devices"):
        "a list of JAX devices; a torch DeviceMesh spans the process "
        "group's ranks, one card each",
    ("parallel/mesh.py", "shard_batch", "mesh"): _MESH,
    ("parallel/mesh.py", "replicate", "mesh"): _MESH,
    ("tools/conv_microbench.py", "main", "only"): _TOOL_MAIN,
    ("tools/loader_bench.py", "main", "n_tiles"): _TOOL_MAIN,
    ("tools/loader_bench.py", "main", "epochs"): _TOOL_MAIN,
    ("tools/profile_flagship.py", "main", "batch"): _TOOL_MAIN,
    ("tools/profile_flagship.py", "main", "only"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "batch"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "chain"): _CHAIN,
    ("tools/sr_train_bench.py", "main", "num_block"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "num_feat"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "num_grow_ch"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "lq_size"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "perceptual"): _TOOL_MAIN,
    ("tools/sr_train_bench.py", "main", "disc_feat"): _TOOL_MAIN,
    ("tools/train_bench.py", "main", "batch"): _TOOL_MAIN,
    ("tools/train_bench.py", "main", "chain"): _CHAIN,
    ("tools/swinir_harness.py", "define_model", "training_patch_size"):
        "the JAX preset ignores it (img_size stays 64 in every preset)",
    ("tools/swinir_harness.py", "run_folder", "large_model"):
        "the port's run_folder takes the built model; define_model's "
        "large_model picks the preset",
    ("tools/swinir_harness.py", "run_folder", "shape_bucket"):
        "pads inputs to a few shapes so that XLA compiles few programs; "
        "eager PyTorch compiles none",
    ("train/sr_trainer.py", "GANTrainState", "step"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "g_params"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "d_vars"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "g_opt"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "d_opt"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "g_tx"): _STATE,
    ("train/sr_trainer.py", "GANTrainState", "d_tx"): _STATE,
    ("train/state.py", "TrainState", "step"): _STATE,
    ("train/state.py", "TrainState", "params"): _STATE,
    ("train/state.py", "TrainState", "batch_stats"): _STATE,
    ("train/state.py", "TrainState", "opt_state"): _STATE,
    ("train/state.py", "TrainState", "tx"): _STATE,
    ("train/state.py", "TrainState", "create()"): _STATE,
    ("train/trainer.py", "main", "data_parallel"):
        "the port trains data-parallel whenever its process group has more "
        "than one rank (or with fsdp); it has no single-process "
        "multi-device mode",
    ("utils/profiler.py", "StepTimer", "sync"):
        "a callable that blocks on JAX's async dispatch; the port's timer "
        "synchronises the device it is given",
}


def _args(fn) -> list:
    """A function's parameter names, ``self`` and ``cls`` left out."""
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _top(tree: ast.Module):
    """(top-level functions, top-level classes) by name."""
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    return fns, classes


def _bases(cls: ast.ClassDef, classes: dict) -> list:
    """``cls`` and its bases defined in the same module, base first."""
    out = []
    for b in cls.bases:
        if isinstance(b, ast.Name) and b.id in classes:
            out += _bases(classes[b.id], classes)
    return out + [cls]


def _has_fields(cls: ast.ClassDef, classes: dict) -> bool:
    """A flax module, a flax struct or a dataclass."""
    for c in _bases(cls, classes):
        if any("dataclass" in ast.unparse(d) for d in c.decorator_list) or \
                any(ast.unparse(b).endswith(("nn.Module", "PyTreeNode"))
                    for b in c.bases):
            return True
    return False


def _fields(cls: ast.ClassDef, classes: dict) -> list:
    return [n.target.id for c in _bases(cls, classes) for n in c.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and "ClassVar" not in ast.unparse(n.annotation)]


def _methods(cls: ast.ClassDef, classes: dict) -> dict:
    """Methods and class-level names, a same-module base's included."""
    out = {}
    for c in _bases(cls, classes):
        for n in c.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[n.name] = n
            elif isinstance(n, ast.Assign):
                out.update((t.id, None) for t in n.targets
                           if isinstance(t, ast.Name))
    return out


def _jax_members(module: str) -> dict:
    """``{(function or class, parameter or "method()")}`` of a JAX module's
    public functions and classes that its twin binds by name, each with the
    set of names the twin offers for it."""
    jfns, jclasses = _top(_tree(JAX / module))
    tfns, tclasses = _top(_tree(_twin(module)))

    def offered(name):
        if name in tfns:
            return set(_args(tfns[name])), set()
        cls = tclasses[name]
        methods = _methods(cls, tclasses)
        init = methods.get("__init__")
        return (set(_args(init) if init else ()) | set(_fields(cls, tclasses)),
                set(methods))

    out = {}
    for name, fn in jfns.items():
        if not name.startswith("_") and (name in tfns or name in tclasses):
            params, _ = offered(name)
            out.update(((name, p), params) for p in _args(fn))
    for name, cls in jclasses.items():
        if name.startswith("_") or not (name in tfns or name in tclasses):
            continue
        params, methods = offered(name)
        if _has_fields(cls, jclasses):
            wanted = _fields(cls, jclasses)
        else:
            init = _methods(cls, jclasses).get("__init__")
            wanted = _args(init) if init else []
        out.update(((name, p), params) for p in wanted)
        out.update(((name, m + "()"), {k + "()" for k in methods})
                   for m in _methods(cls, jclasses)
                   if not m.startswith("_") and m != "setup")
    return out


def _missing(module: str, owner: str, member: str, offered: set) -> bool:
    """Whether the twin lacks ``member`` under its own or its renamed name."""
    return PARAM_RENAMES.get((module, owner, member), member) not in offered


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_jax_parameters(module):
    members = _jax_members(module)
    missing = sorted("{}({})".format(*k) for k, have in members.items()
                     if _missing(module, *k, have)
                     and (module, *k) not in DELIBERATE_PARAMS)
    assert missing == [], (f"{_twin(module).relative_to(REPO)} lacks "
                           f"{missing} of srbh_tpu/{module}: port them, or "
                           "list each in PARAM_RENAMES or, with a reason, in "
                           "DELIBERATE_PARAMS")


@pytest.mark.parametrize("entry", sorted(DELIBERATE_PARAMS), ids="::".join)
def test_deliberate_param_entry_is_not_stale(entry):
    module, owner, member = entry
    assert DELIBERATE_PARAMS[entry].strip()
    assert entry[:3] not in PARAM_RENAMES
    members = _jax_members(module)
    assert (owner, member) in members, \
        f"srbh_tpu/{module}:{owner} no longer has {member}: drop the entry"
    assert _missing(module, owner, member, members[owner, member]), \
        f"the port's {owner} now has {member}: drop its DELIBERATE_PARAMS entry"


@pytest.mark.parametrize("entry", sorted(PARAM_RENAMES), ids="::".join)
def test_param_rename_is_not_stale(entry):
    module, owner, member = entry
    members = _jax_members(module)
    assert (owner, member) in members, \
        f"srbh_tpu/{module}:{owner} no longer has {member}: drop the entry"
    offered = members[owner, member]
    assert member not in offered, f"the port's {owner} now takes {member}"
    assert PARAM_RENAMES[entry] in offered, \
        f"the port's {owner} has no {PARAM_RENAMES[entry]}"
