"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared by
whole top-level name; the references and the synthetic inputs import
nothing of the port either."""
from __future__ import annotations

import ast
import os

import pytest

from benchmark.harness import env

from conftest import REPO

BENCH = os.path.join(REPO, "benchmark")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_no_jax_anywhere_in_the_benchmark():
    bad = [(p, m) for p in _files() for m in _imports(p)
           if m.split(".")[0] in env.FORBIDDEN_MODULES]
    assert not bad


@pytest.mark.parametrize("sub", ["reference", "synth"])
def test_references_and_inputs_stand_apart_from_the_port(sub):
    bad = [(p, m) for p in _files(sub) for m in _imports(p)
           if m.split(".")[0] in ("srbh_tpu_torch",) + env.FORBIDDEN_MODULES]
    assert not bad


def test_forbidden_names_compare_whole():
    assert env.forbidden_loaded(["srbh_tpu_torch", "srbh_tpu_torch.models",
                                 "jaxtyping", "flax_like", "numpy"]) == []
    assert env.forbidden_loaded(["jax.numpy", "srbh_tpu.ops", "flax",
                                 "jaxlib"]) == ["flax", "jax.numpy", "jaxlib",
                                                "srbh_tpu.ops"]
