"""The port's offline data preparation against the JAX package's, on the
CPU.

* ``CustomVoxelizer``, ``estimate_normals`` and ``Featurizer(backend=
  "numpy")``: bit-equal; ``backend="native"`` gives the (N, C + 36)
  array (held to the numpy path in ``test_torch_port_native.py``).
* ``NumpyBooster`` on the hand-built JSON models of
  ``tests/test_xgb_infer.py``: bit-equal, missing values included.
* The ``MLP`` within 1e-5 of the flax MLP from the same variables; the
  variables round-trip through ``models/weights.py``.
* ``ForegroundFilter`` (``device="cpu"``): probabilities within 1e-5 of
  the JAX package's filter from the ``.pkl`` that
  ``tests/test_layers_extra.py`` writes, and from a synthetic
  reference-layout ``mlp.pth`` (both importers give the same tree); the
  port's filter reads the trailing ``input_channels`` columns of wider
  features, where the JAX package's raises (C11); the xgboost path
  through ``NumpyBooster`` equal.
* The rdb npy/JSON helpers round-trip and equal the JAX package's; RDBX
  reads raise ``ImportError`` without the vendor library.
* ``prepare_cloud`` on tiny clouds equal to the JAX package's (density
  downsampling; the featurizer and MLP-filter chain);
  ``python -m objectdetection_3d_tpu_torch.tools.prepare_data`` with
  ``--device cpu``; ``configs.preprocess_cfg`` is ``config.yaml``'s.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from objectdetection_3d_tpu.dataset import rdb_tools as jax_rdb
from objectdetection_3d_tpu.models import preprocess_tools as jax_pre
from objectdetection_3d_tpu.models.layers import MLP as JaxMLP
from objectdetection_3d_tpu.models.torch_import import (
    mlp_variables_from_torch as jax_mlp_from_torch,
)
from objectdetection_3d_tpu.models.xgb_infer import (
    NumpyBooster as JaxNumpyBooster,
)
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.dataset import rdb_tools
from objectdetection_3d_tpu_torch.models import preprocess_tools as pre
from objectdetection_3d_tpu_torch.models.layers import MLP
from objectdetection_3d_tpu_torch.models.torch_import import (
    load_reference_mlp,
    mlp_variables_from_torch,
)
from objectdetection_3d_tpu_torch.models.weights import (
    from_jax_variables,
    to_jax_variables,
)
from objectdetection_3d_tpu_torch.models.xgb_infer import NumpyBooster
from objectdetection_3d_tpu_torch.scene import reference_mlp_state_dict
from objectdetection_3d_tpu_torch.tools.prepare_data import prepare_cloud
from test_xgb_infer import _T0, _T1, _model_json

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from prepare_data import prepare_cloud as jax_prepare_cloud  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURIZER = {"normal_rad": 0.5, "normal_max_nn": 10, "fpfh_rad": 0.5,
              "fpfh_max_nn": 10}


def _dense_cloud(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = rng.uniform(0, 3, (n, 3))
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.mark.parametrize("n,size", [(1000, 0.03), (20_000, 0.2),
                                    (4000, 0.5)])
def test_custom_voxelizer_is_bit_equal(n, size):
    pts = _dense_cloud(n, seed=n)
    cfg = dict(voxel_size=[size] * 3, max_voxel_points=15,
               reflectance_sampling=True)
    got = pre.CustomVoxelizer(**cfg).voxelize(pts)
    want = jax_pre.CustomVoxelizer(**cfg).voxelize(pts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_numpy_featurizer_is_bit_equal():
    pts = _dense_cloud(400, seed=3).astype(np.float64)
    np.testing.assert_array_equal(
        pre.estimate_normals(pts[:, :3], 0.4, 20),
        jax_pre.estimate_normals(pts[:, :3], 0.4, 20))
    got = pre.Featurizer(backend="numpy", **FEATURIZER).generate_features(pts)
    want = jax_pre.Featurizer(backend="numpy",
                              **FEATURIZER).generate_features(pts)
    assert got.shape == (400, 4 + 3 + 33)
    np.testing.assert_array_equal(got, want)
    native = pre.Featurizer(backend="native",
                            **FEATURIZER).generate_features(pts)
    assert native.shape == (400, 4 + 36)
    np.testing.assert_array_equal(native[:, :4], pts)
    with pytest.raises(TypeError):
        pre.Featurizer(normal_rad=1, normal_max_nn=10, fpfh_rad=0.5,
                       fpfh_max_nn=10)


@pytest.mark.parametrize("objective,base", [("binary:logistic", "5E-1"),
                                            ("binary:logistic", "0.75"),
                                            ("reg:squarederror", "1.5")])
def test_numpy_booster_is_bit_equal(tmp_path, objective, base):
    path = tmp_path / "model.json"
    path.write_text(json.dumps(_model_json([_T0, _T1], objective=objective,
                                           base_score=base)))
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 3, (64, 3))
    x[rng.uniform(size=(64, 3)) < 0.25] = np.nan
    got = NumpyBooster.load_model(str(path))
    want = JaxNumpyBooster.load_model(str(path))
    np.testing.assert_array_equal(got.predict(x), want.predict(x))
    np.testing.assert_array_equal(got.predict(x, output_margin=True),
                                  want.predict(x, output_margin=True))
    with pytest.raises(ValueError):
        got.predict(x[0])


def _flax_variables(in_ch=37, seed=0):
    """The flax MLP's variables with random batch statistics, as numpy."""
    mlp = JaxMLP(input_channels=in_ch)
    variables = mlp.init(jax.random.PRNGKey(seed),
                         np.zeros((2, in_ch), np.float32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    for name, stats in variables["batch_stats"].items():
        stats["mean"] = rng.normal(0, 0.3, stats["mean"].shape).astype(
            np.float32)
        stats["var"] = rng.uniform(0.5, 2, stats["var"].shape).astype(
            np.float32)
    return mlp, variables


def test_mlp_matches_flax():
    mlp, variables = _flax_variables()
    x = np.random.default_rng(1).normal(0, 1, (64, 37)).astype(np.float32)
    want = np.asarray(mlp.apply(variables, x, train=False))
    port = MLP(input_channels=37)
    from_jax_variables(port, variables)
    port.eval()
    got = port(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    back = to_jax_variables(port)
    for coll in ("params", "batch_stats"):
        for name, leaves in variables[coll].items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(back[coll][name][leaf], arr)
    with pytest.raises(ValueError):   # another width
        from_jax_variables(MLP(input_channels=40), variables)


def _filters(folder, filter_type="mlp", in_ch=37, thr=0.5):
    cfg = {"path": str(folder) + "/", "filter_type": filter_type,
           "mlp": {"trunk_confidence": thr, "input_channels": in_ch},
           "xgboost": {"trunk_confidence": thr}}
    return pre.ForegroundFilter(cfg, device="cpu"), \
        jax_pre.ForegroundFilter(cfg)


def _jax_probabilities(jf, feats):
    return np.asarray(jf.mlp.apply(jf.variables, feats, train=False))[:, 0]


def test_foreground_filter_from_the_flax_pkl(tmp_path):
    _, variables = _flax_variables(seed=2)
    with open(tmp_path / "mlp.pkl", "wb") as f:
        pickle.dump(variables, f)
    ours, theirs = _filters(tmp_path)
    feats = np.random.default_rng(1).normal(0, 1, (256, 37)).astype(
        np.float32)
    got = ours.probabilities(feats)
    want = _jax_probabilities(theirs, feats)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mask, jmask = ours.evaluate(feats), theirs.evaluate(feats)
    assert mask.dtype == np.uint8 and mask.shape == (256,)
    far = np.abs(want - 0.5) > 1e-5
    np.testing.assert_array_equal(mask[far], jmask[far])
    assert ours.mlp.dense_0.weight.device.type == "cpu"
    with pytest.raises(ValueError):
        _filters(tmp_path, thr=1.5)


def test_foreground_filter_from_a_reference_pth(tmp_path):
    sd = reference_mlp_state_dict(37, seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "mlp.pth")
    tree = mlp_variables_from_torch(str(tmp_path / "mlp.pth"))
    want_tree = jax_mlp_from_torch(str(tmp_path / "mlp.pth"))
    for coll in ("params", "batch_stats"):
        for name, leaves in want_tree[coll].items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(tree[coll][name][leaf], arr)
    ours, theirs = _filters(tmp_path)
    feats = np.random.default_rng(5).normal(0, 1, (256, 37)).astype(
        np.float32)
    np.testing.assert_allclose(ours.probabilities(feats),
                               _jax_probabilities(theirs, feats), atol=1e-5,
                               rtol=0)
    # C11: the port's filter reads the trailing 37 of an (x, y, z,
    # reflectance) cloud's 40 feature columns; the JAX package's raises
    wide = np.concatenate([np.ones((256, 3), np.float32), feats], axis=1)
    np.testing.assert_array_equal(ours.probabilities(wide),
                                  ours.probabilities(feats))
    from flax.errors import ScopeParamShapeError

    with pytest.raises(ScopeParamShapeError):
        theirs.evaluate(wide)
    mlp = MLP(37)
    load_reference_mlp(mlp, sd)
    assert torch.equal(mlp.out.weight, torch.from_numpy(sd["hidden6.weight"]))
    del sd["bn3.running_var"]
    with pytest.raises(KeyError, match="bn3"):
        load_reference_mlp(MLP(37), sd)
    with pytest.raises(FileNotFoundError):
        _filters(tmp_path / "nowhere")


def test_foreground_filter_xgboost_path(tmp_path):
    (tmp_path / "xgboost.json").write_text(json.dumps(_model_json(
        [_T0, _T1])))
    ours, theirs = _filters(tmp_path, filter_type="xgboost")
    x = np.random.default_rng(2).uniform(-2, 3, (64, 3))
    np.testing.assert_array_equal(ours.evaluate(x), theirs.evaluate(x))
    assert 0 < ours.evaluate(x).sum() < 64


def test_rdb_helpers_round_trip_and_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    boxes = rng.uniform(-50, 50, (5, 9))
    dicts = rdb_tools.npy_to_bbx_dicts(boxes)
    assert dicts == jax_rdb.npy_to_bbx_dicts(boxes)
    path = tmp_path / "bbx.json"
    path.write_text(json.dumps(dicts))
    back = rdb_tools.bbx_dicts_to_npy(json.loads(path.read_text()))
    np.testing.assert_array_equal(back, boxes)
    np.testing.assert_array_equal(
        back, jax_rdb.bbx_dicts_to_npy(json.loads(path.read_text())))
    assert rdb_tools.bbx_dicts_to_npy([]).shape == (0, 9)
    fake = tmp_path / "scan.rdbx"
    fake.write_bytes(b"")
    with pytest.raises(ImportError, match="riegl.rdb"):
        rdb_tools.RDB_import(str(fake), ["riegl.xyz"], "",
                             1000).get_features()
    with pytest.raises(ImportError, match="riegl.rdb"):
        rdb_tools.BBX_HANDLER(str(fake)).collect_bbx_data()


def _write_mlp_pkl(folder, in_ch=40):
    _, variables = _flax_variables(in_ch=in_ch, seed=6)
    folder.mkdir()
    with open(folder / "mlp.pkl", "wb") as f:
        pickle.dump(variables, f)
    return str(folder) + "/"


def test_prepare_cloud_matches_jax(tmp_path):
    quiet = dict(log=lambda *a: None)
    vox = {"voxelization": {"voxel_size": [0.5, 0.5, 0.5],
                            "max_voxel_points": 15,
                            "reflectance_sampling": True}}
    pts = _dense_cloud()
    got = prepare_cloud(pts, vox, device="cpu", **quiet)
    np.testing.assert_array_equal(got, jax_prepare_cloud(pts, vox, **quiet))
    assert got.shape[1] == 4 and 0 < len(got) < len(pts)

    chain = {"featurizer": dict(FEATURIZER, backend="numpy"),
             "filter": {"path": _write_mlp_pkl(tmp_path / "models"),
                        "filter_type": "mlp",
                        "mlp": {"input_channels": 40,
                                # the FPFH columns saturate these weights
                                "trunk_confidence": 0.998}}}
    pts = _dense_cloud(600, seed=1)
    got = prepare_cloud(pts, chain, device="cpu", **quiet)
    want = jax_prepare_cloud(pts, chain, **quiet)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(pts)


def test_prepare_data_module_runs_on_the_cpu(tmp_path):
    pts = _dense_cloud()
    np.save(tmp_path / "raw.npy", pts)
    np.save(tmp_path / "raw_bbx.npy", np.zeros((2, 9), np.float32))
    cfg = {"model": {"preprocess": {"voxelization": {
        "voxel_size": [0.5, 0.5, 0.5], "max_voxel_points": 15,
        "reflectance_sampling": True}}}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    r = subprocess.run(
        [sys.executable, "-m", "objectdetection_3d_tpu_torch.tools."
         "prepare_data", str(tmp_path / "cfg.yaml"), str(tmp_path / "raw.npy"),
         str(tmp_path / "out.npy"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    out = np.load(tmp_path / "out.npy")
    np.testing.assert_array_equal(out, jax_prepare_cloud(
        pts, cfg["model"]["preprocess"], log=lambda *a: None))
    assert (tmp_path / "out_bbx.npy").exists()


def test_preprocess_cfg_is_the_config_yaml_section():
    with open(os.path.join(ROOT, "config.yaml")) as f:
        want = yaml.safe_load(f)["model"]["preprocess"]
    assert configs.preprocess_cfg() == want
