"""The port stands alone: no module of it, not ``chip_smoke.py`` and not
``tests/rank_cases.py`` (what the port's ranks run in the tests and in
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, nor
``tests/make_jax_flagship_reference.py`` (phase 22 reads its file with
numpy); its configs are faithful copies of the JAX package's."""

import ast
import pathlib

import pytest

import __graft_entry__
from objectdetection_3d_tpu.config import DEFAULT_TPU_CFG
from objectdetection_3d_tpu_torch import configs
from tiny import tiny_model_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "objectdetection_3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "objectdetection_3d_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN   # objectdetection_3d_tpu_torch is its own top


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "rank_cases.py"]
    return [f for f in files if "__pycache__" not in f.parts]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the data-preparation and augmentation modules, walked like the rest
DATA_PATH_MODULES = (
    "augment/device_ops.py", "augment/gt_database.py",
    "dataset/rdb_tools.py", "models/preprocess_tools.py",
    "models/xgb_infer.py", "ops/sampling.py", "tools/__init__.py",
    "tools/build_gt_database.py", "tools/prepare_data.py")


@pytest.mark.parametrize("module", DATA_PATH_MODULES)
def test_data_path_modules_are_walked(module):
    assert PORT / module in _sources()


# the serving path: the export, its operators and its command
SERVING_MODULES = ("serving.py", "ops/custom_ops.py",
                   "tools/export_model.py")


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_are_walked(module):
    assert PORT / module in _sources()


# the host C++ passes' loader, the parallel paths and their ranks' cases
PARALLEL_MODULES = tuple(
    f"objectdetection_3d_tpu_torch/{m}" for m in (
        "native/__init__.py", "shared_lib.py", "parallel/__init__.py",
        "parallel/collectives.py", "parallel/data_parallel.py",
        "parallel/launch.py")) + ("tests/rank_cases.py",)


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_native_and_parallel_modules_are_walked(module):
    assert ROOT / module in _sources()


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_the_jax_reference_script(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] == "make_jax_flagship_reference"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# chip_smoke.py's phases that hold the port against the JAX package's
# reference file (22) and against the float64 instrument (19c)
@pytest.mark.parametrize("name", ["full_width_phase", "c16_phase"])
def test_reference_phases_are_walked(name):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assert name in {n.name for n in tree.body
                    if isinstance(n, ast.FunctionDef)}
    assert ROOT / "chip_smoke.py" in _sources()


def test_rule_tells_the_port_from_the_jax_package():
    assert _forbidden("objectdetection_3d_tpu.ops.boxes")
    assert _forbidden("jax.numpy")
    assert not _forbidden("objectdetection_3d_tpu_torch.ops.boxes")
    assert len(_sources()) >= 15


def test_configs_are_copies_of_the_jax_packages():
    assert configs.flagship_cfg() == __graft_entry__._flagship_cfg()
    override = {"compute_dtype": "float32"}
    assert (configs.flagship_cfg(override)
            == __graft_entry__._flagship_cfg(override))
    assert configs.tiny_cfg() == __graft_entry__._tiny_cfg()
    assert configs.tiny_model_cfg() == tiny_model_cfg()
    assert configs.DEFAULT_TPU_CFG == DEFAULT_TPU_CFG
