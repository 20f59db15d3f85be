"""The run's environment: cache directories inside the checkout, the card,
and the check that no JAX module was loaded."""
from __future__ import annotations

import os
import sys

# top-level module names the benchmark's process may never hold; compared
# whole, so ``srbh_tpu_torch`` (the port) does not match ``srbh_tpu``
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "srbh_tpu")

# the program's build and kernel caches, at fixed paths inside the checkout
# (``build/`` is ignored by git), so that only a cell's first run there
# builds and compiles
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": "build/bench_cache/triton"}


def checkout_root() -> str:
    """The directory that holds ``BENCHMARK.json`` and ``benchmark/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def set_cache_dirs(root: str) -> dict:
    """Point the program's compile caches into the checkout; returns them.
    ``USE_FLAX=0`` keeps libraries that would load JAX by themselves from
    doing so."""
    dirs = {}
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(root, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
        dirs[var] = path
    os.environ["USE_FLAX"] = "0"
    return dirs


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def scratch_dir(name: str) -> str:
    """A new directory of this process under the run's ``TMPDIR`` for
    synthetic data and outputs; the caller deletes it."""
    import tempfile
    return tempfile.mkdtemp(prefix=f"srbh_bench_{name}_")
