"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``portbench/`` (top-level module names compared whole:
the port's name begins with the JAX package's), and nothing of the port
in the reference."""

import ast
import os

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "objectdetection_3d_tpu"}
PORT = "objectdetection_3d_tpu_torch"
BENCH = os.path.join(REPO, "portbench")


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """Top-level names of every module ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_takes_nothing_of_the_port(path):
    assert PORT not in set(_imports(path))


def test_names_are_compared_whole():
    assert "objectdetection_3d_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax_utils".split(".")[0] not in FORBIDDEN


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench.harness import main

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert main.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert "objectdetection_3d_tpu" not in main.forbidden_modules()
