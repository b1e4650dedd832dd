"""Serving: the port's predict exported by ``torch.export``, saved,
reloaded without the model's code and called, on the CPU at the tiny
width (float32).

* The round trip equals the live predict at B = 2 (as JAX
  ``tests/test_serving.py``), under the default and each knob set that
  routes the tiny config's one encoder stage through a kernel's operator
  (K8, K10, K9): boxes and scores within 1e-6, labels and ``valid``
  exact.
* The artifact is self-contained: a fresh process that only loads it
  holds none of the port's models, config or pipeline, nor JAX.
* From the same weights, the port's artifact and the JAX package's CPU
  artifact agree within predict's parity tolerances (PERF.md §2): boxes
  1e-4, scores 1e-5, labels and ``valid`` exact (rows with ``valid``
  False are padding and not compared, as in ``test_torch_port_model``).
* ``torch.library.opcheck`` holds each ``od3d`` operator (schema, fake
  implementation, autograd registration, tracing) at tiny shapes.
* The exported predict calls K11's operator for each eval stage norm
  that K8 does not run.
* ``tools.export_model`` from a ``.pth``, with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu import serving as jax_serving
from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu_torch import configs, serving
from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.network import init_parameters
from objectdetection_3d_tpu_torch.models.weights import from_jax_variables
from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io
from objectdetection_3d_tpu_torch.tools import export_model
from test_pipeline import make_cfg
from test_torch_port_model import _random_variables
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# knob set -> the od3d operator it must put into the program
KNOBS = {
    "default": ({}, None),
    "fused_stages": ({"fused_stages": True}, "fused_stage"),
    "pallas_subm_conv+zfold_pallas": (
        {"pallas_subm_conv": True, "zfold_convs": True,
         "zfold_pallas": True}, "subm_conv3d"),
    "zfold_pallas": ({"zfold_convs": True, "zfold_pallas": True},
                     "conv2d_3x3"),
}


@pytest.fixture(scope="module")
def variables():
    jm = JaxPointPillars(**tiny_model_cfg())
    return jm, _random_variables(jm.init_variables(jax.random.PRNGKey(0)))


def _model(variables, knobs):
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], **knobs)
    model = PointPillars(cfg, device="cpu")
    from_jax_variables(model.net, variables)
    return model


@pytest.fixture(scope="module")
def artifacts(variables, tmp_path_factory):
    """{knob set: (model, artifact dir, program)}, exported at B = 2."""
    out = {}
    for name, (knobs, _) in KNOBS.items():
        model = _model(variables[1], knobs)
        program, manifest = serving.export_predict(model, batch_size=2)
        path = str(tmp_path_factory.mktemp(name.replace("+", "_")))
        serving.save_exported(program, manifest, path)
        out[name] = (model, path, program)
    return out


def _assert_same(got, want, tol=1e-6):
    assert set(got) == set(want) == {"bbox", "label", "score", "valid"}
    for k in ("label", "valid"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("bbox", "score"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("knobs", KNOBS)
def test_roundtrip_matches_live_predict(artifacts, knobs):
    model, path, program = artifacts[knobs]
    targets = {str(n.target) for n in program.graph.nodes}
    op = KNOBS[knobs][1]
    for name in ("postsort_scan", "scatter_to_grid", op):
        if name:
            assert f"od3d.{name}.default" in targets, name
    assert "while_loop" in targets
    assert not any("nonzero" in t for t in targets)

    serve, manifest = serving.load_serving(path)
    assert manifest["batch_size"] == 2
    assert manifest["device"] == "cpu"
    assert manifest["inputs"]["points"] == [[2, 2048, 4], "float32"]
    assert manifest["outputs"]["bbox"] == [[2, 32, 9], "float32"]
    for seed in (5, 6):
        batch = tiny_batch(batch_size=2, seed=seed)
        want = {k: v.numpy() for k, v in model.predict(batch).items()}
        got = {k: v.numpy() for k, v in serve(batch).items()}
        assert want["valid"].any()
        _assert_same(got, want)


@pytest.mark.parametrize("knobs", KNOBS)
def test_exported_eval_norms_call_k11(artifacts, knobs):
    """The tiny encoder's one stage: its two norms through
    ``od3d.masked_affine_relu``, unless K8 runs the stage whole."""
    _, _, program = artifacts[knobs]
    calls = [n for n in program.graph.nodes
             if str(n.target) == "od3d.masked_affine_relu.default"]
    assert len(calls) == (0 if knobs == "fused_stages" else 2)


def test_exported_is_self_contained(artifacts):
    """A process that loads the artifact and calls it on empty clouds:
    no valid box, and none of the model's modules imported."""
    _, path, _ = artifacts["default"]
    script = f"""
import json, sys
import torch
from objectdetection_3d_tpu_torch.serving import load_serving
serve, manifest = load_serving({path!r})
b, p, c = manifest["inputs"]["points"][0]
out = serve({{"points": torch.zeros((b, p, c)),
             "num_points": torch.zeros((b,), dtype=torch.int32)}})
print(json.dumps({{"valid": bool(out["valid"].any()),
                  "modules": sorted(sys.modules)}}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["valid"] is False
    mods = result["modules"]
    for banned in ("objectdetection_3d_tpu_torch.models",
                   "objectdetection_3d_tpu_torch.config",
                   "objectdetection_3d_tpu_torch.pipeline"):
        assert not [m for m in mods if m == banned
                    or m.startswith(banned + ".")], banned
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "objectdetection_3d_tpu")]


def test_port_artifact_matches_the_jax_artifact(variables, artifacts,
                                                 tmp_path):
    jm, jvars = variables
    payload, manifest = jax_serving.export_predict(
        jm, jvars, batch_size=2, platforms=["cpu"])
    jax_serving.save_exported(payload, manifest, str(tmp_path))
    jax_serve, _ = jax_serving.load_serving(str(tmp_path))
    serve, _ = serving.load_serving(artifacts["default"][1])
    raw = tiny_batch(batch_size=2, seed=5)
    want = jax_serve({"points": jnp.asarray(raw["points"]),
                      "num_points": jnp.asarray(raw["num_points"])})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in serve(raw).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].any()
    v = want["valid"]
    np.testing.assert_array_equal(got["label"][v], want["label"][v])
    np.testing.assert_allclose(got["bbox"][v], want["bbox"][v], atol=1e-4)
    np.testing.assert_allclose(got["score"][v], want["score"][v], atol=1e-5)


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rand(*shape, grad=False):
        return torch.randn(shape, generator=g).requires_grad_(grad)

    cells = torch.sort(torch.randint(0, 40, (2, 64), generator=g,
                                     dtype=torch.int32), dim=1).values
    cells[1, 50:] = 40                          # out-of-range points
    ids = torch.stack([torch.randperm(32, generator=g)[:10].sort().values
                       for _ in range(2)]).to(torch.int32)
    ids[0, 8:] = 32                             # padding rows
    return {
        "postsort_scan": (cells, 40),
        "scatter_to_grid": (rand(2, 10, 4, grad=True), ids, [2, 4, 4]),
        "subm_conv3d": (rand(1, 3, 8, 8, 4), rand(3, 3, 3, 4, 5)),
        "conv2d_3x3": (rand(2, 5, 6, 3, grad=True),
                       rand(3, 3, 3, 4, grad=True)),
        "conv2d_3x3_dx": (rand(2, 5, 6, 4), rand(3, 3, 3, 4)),
        "fused_stage": (rand(1, 5, 8, 8, 4),
                        (torch.rand((1, 5, 8, 8), generator=g) < 0.5).float(),
                        rand(3, 3, 3, 4, 6), rand(3, 6, 6),
                        *(rand(6) for _ in range(4))),
        "masked_affine_relu": (
            rand(2, 5, 8, 8, 20),
            (torch.rand((2, 5, 8, 8), generator=g) < 0.5).float(),
            rand(20), rand(20)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.od3d, name).default,
                          _op_cases()[name])


def test_load_serving_refuses_a_cuda_artifact_without_a_card(tmp_path,
                                                             monkeypatch):
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"device": "cuda", "device_name": "NVIDIA H100"}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_serving(str(tmp_path))


def _random_pth(cfg, path):
    """Random weights for the model of ``cfg``, on the CPU, with a head
    that scores some anchors above score_thr, saved as a ``.pth`` at
    ``path``; returns the model."""
    _, _, cfg_model = Config.initialize_params(Config(cfg.dump()))
    model = PointPillars(cfg_model, device="cpu")
    init_parameters(model.net, torch.Generator().manual_seed(7))
    with torch.no_grad():
        model.net.bbox_head.conv_cls.bias.fill_(0.0)
    ckpt_io.save_ckpt(str(path), 0, model.net)
    return model


def _served_equals_live(out, model):
    serve, manifest = serving.load_serving(out)
    assert manifest["inputs"]["points"] == [[2, 1024, 4], "float32"]
    batch = tiny_batch(batch_size=2, seed=3, max_points=1024)
    want = {k: v.numpy() for k, v in model.predict(batch).items()}
    assert want["valid"].any()
    _assert_same({k: v.numpy() for k, v in serve(batch).items()}, want)


def test_export_cli_from_a_pth(tmp_path):
    cfg = make_cfg(tmp_path)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg.dump()))
    pth = tmp_path / "ckpt_00000.pth"
    model = _random_pth(cfg, pth)
    out = str(tmp_path / "served")
    assert export_model.main([str(cfg_path), out, "--batch", "2",
                              "--device", "cpu", "--ckpt", str(pth)]) == 0
    _served_equals_live(out, model)


def test_export_loads_the_run_entry_test_would(tmp_path):
    """Without a checkpoint path, ``export`` loads the run's best
    checkpoint, as ``entry test`` does; ``device`` overrides the
    config's (here the card's)."""
    version = "2026-01-01-00-00-00"
    cfg = make_cfg(tmp_path, inference_mode=True, resume_from=version)
    cfg.global_args["device"] = "cuda"
    ckpt_dir = tmp_path / "output" / version / "logs" / "checkpoint"
    ckpt_dir.mkdir(parents=True)
    model = _random_pth(cfg, ckpt_dir / "ckpt_best.pth")
    out = str(tmp_path / "served")
    manifest = export_model.export(cfg, out, batch_size=2, device="cpu")
    assert manifest["device"] == "cpu"
    _served_equals_live(out, model)


def test_export_without_a_checkpoint_needs_inference_mode(tmp_path):
    with pytest.raises(ValueError, match="inference_mode: true"):
        export_model.export(make_cfg(tmp_path), str(tmp_path / "served"),
                            device="cpu")
    assert not (tmp_path / "output").exists()
