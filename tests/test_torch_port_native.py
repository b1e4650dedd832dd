"""The port's host C++ passes (``objectdetection_3d_tpu_torch/native``)
against the JAX package's numpy paths, on the CPU.

The JAX package's own ``native`` library is never loaded here: only its
numpy functions (``global_outlier_check``, ``estimate_normals``,
``compute_fpfh``, ``Featurizer(backend="numpy")``) serve as the oracle.

* ``preprocess_cloud``: the four cases of ``tests/test_native.py``
  (parity at atol 1e-5, order, the ``max_points`` cap, the empty result),
  and ``PointPillars._preprocess_points`` against its numpy version.
* ``featurize_cloud`` at ``tests/test_native_featurize.py``'s
  tolerances: normals |dot| > 0.999 on >= 98% of the >= 4-point
  neighbourhoods; FPFH from shared normals at rtol 2e-4, atol 2e-3;
  ``Featurizer(backend="native")`` end to end; isolated points give zero
  histograms.
* ``Featurizer("auto")`` takes the native library when open3d does not
  import.
* The build: two processes building into one empty directory at once
  both load a whole library, and an edited source gets another name.

No test here times anything.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.augment.numpy_ops import global_outlier_check
from objectdetection_3d_tpu.models.preprocess_tools import (
    Featurizer as JaxFeaturizer,
)
from objectdetection_3d_tpu.models.preprocess_tools import (
    _knn_radius,
    compute_fpfh,
    estimate_normals,
)
from objectdetection_3d_tpu_torch import configs, native, shared_lib
from objectdetection_3d_tpu_torch.models import preprocess_tools as pre
from objectdetection_3d_tpu_torch.models.detector import PointPillars

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def numpy_reference(points, input_features, pcr):
    filtered = global_outlier_check(points)
    mn, mx = np.array(pcr[:3]), np.array(pcr[3:])
    filtered = filtered[np.all(
        (filtered[:, :3] >= mn) & (filtered[:, :3] < mx), axis=-1)]
    return filtered[:, input_features]


# ---------------------------------------------------------------------------
# preprocess_cloud
# ---------------------------------------------------------------------------
def test_preprocess_parity_with_numpy():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 10, (50_000, 5)).astype(np.float32)
    pts[:20, :3] = 1e4   # far outliers
    pcr = (0.0, 0.0, 0.0, 8.0, 8.0, 8.0)
    got = native.preprocess_cloud(pts, [0, 1, 2, 3], pcr)
    want = numpy_reference(pts, [0, 1, 2, 3], pcr)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_preprocess_keeps_the_order():
    pts = np.array([[1, 1, 1, 9], [2, 2, 2, 8], [3, 3, 3, 7]], np.float32)
    out = native.preprocess_cloud(pts, [0, 1, 2, 3], (0, 0, 0, 8, 8, 8))
    np.testing.assert_allclose(out[:, 3], [9, 8, 7])


def test_preprocess_max_points_cap():
    pts = np.random.default_rng(1).uniform(0, 4, (1000, 4)).astype(
        np.float32)
    out = native.preprocess_cloud(pts, [0, 1, 2, 3], (0, 0, 0, 8, 8, 8),
                                  max_points=100)
    assert out.shape == (100, 4)
    np.testing.assert_array_equal(
        out, numpy_reference(pts, [0, 1, 2, 3], (0, 0, 0, 8, 8, 8))[:100])


def test_preprocess_empty_result():
    pts = np.full((100, 4), 50.0, np.float32)   # all out of range
    out = native.preprocess_cloud(pts, [0, 1, 2, 3], (0, 0, 0, 8, 8, 8))
    assert out.shape == (0, 4)


def test_model_preprocess_points_takes_the_native_pass(monkeypatch):
    model = PointPillars(configs.tiny_model_cfg(), device="cpu")
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 9, (5000, 5)).astype(np.float32)
    pts[:5, :3] = 500.0
    calls = []
    real = native.preprocess_cloud

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "preprocess_cloud", counted)
    got = model._preprocess_points(pts)
    assert calls == [1]
    want = model._preprocess_points_numpy(pts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, numpy_reference(pts, model.input_features,
                             model.point_cloud_range))
    # the empty cloud takes the numpy version
    empty = model._preprocess_points(np.zeros((0, 5), np.float32))
    assert calls == [1] and empty.shape == (0, len(model.input_features))


# ---------------------------------------------------------------------------
# featurize_cloud
# ---------------------------------------------------------------------------
def _cloud(n=400, seed=0):
    """A plane, a cylinder and scattered noise (``tests/
    test_native_featurize.py``'s cloud)."""
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(0, 4, n // 2), rng.uniform(0, 4, n // 2),
                      0.02 * rng.standard_normal(n // 2)], -1)
    ang = rng.uniform(0, 2 * np.pi, n // 4)
    cyl = np.stack([2 + 0.5 * np.cos(ang), 2 + 0.5 * np.sin(ang),
                    rng.uniform(0, 2, n // 4)], -1)
    cyl += 0.01 * rng.standard_normal(cyl.shape)
    noise = rng.uniform([0, 0, 0], [4, 4, 2], (n - n // 2 - n // 4, 3))
    return np.concatenate([plane, cyl, noise]).astype(np.float64)


def test_normals_match_numpy():
    pts = _cloud()
    ref = estimate_normals(pts, radius=0.5, max_nn=16)
    normals, _ = native.featurize_cloud(pts, 0.5, 16, 0.8, 24)
    # a neighbourhood of < 4 points has no well-defined normal
    _, valid = _knn_radius(pts, 0.5, 16)
    ok = valid.sum(axis=1) >= 4
    assert ok.sum() > 200
    dots = np.abs(np.einsum("nk,nk->n", ref, normals))[ok]
    assert (dots > 0.999).mean() >= 0.98, np.sort(dots)[:5]


def test_fpfh_matches_numpy_with_shared_normals():
    pts = _cloud(seed=1)
    normals = estimate_normals(pts, radius=0.5, max_nn=16)
    ref = compute_fpfh(pts, normals, radius=0.8, max_nn=24)
    got_normals, fpfh = native.featurize_cloud(pts, 0.5, 16, 0.8, 24,
                                               normals=normals)
    np.testing.assert_array_equal(got_normals, normals)
    np.testing.assert_allclose(fpfh, ref, rtol=2e-4, atol=2e-3)


def test_native_featurizer_end_to_end_against_jax_numpy():
    pts = np.concatenate(
        [_cloud(seed=2), np.random.default_rng(3).uniform(0, 1, (400, 1))],
        axis=1)
    kw = dict(normal_rad=0.5, normal_max_nn=16, fpfh_rad=0.8,
              fpfh_max_nn=24)
    got = pre.Featurizer(backend="native", **kw).generate_features(pts)
    want = JaxFeaturizer(backend="numpy", **kw).generate_features(pts)
    assert got.shape == want.shape == (400, 4 + 36)
    np.testing.assert_array_equal(got[:, :4], pts)
    # normals up to PCA's sign where they are well defined; a point's
    # FPFH reads its neighbours' SPFH, which read their neighbours'
    # normals: compare where the 2-hop neighbourhood agrees
    agree = np.einsum("nk,nk->n", got[:, 4:7], want[:, 4:7]) > 0.999
    assert agree.mean() > 0.9
    idx, valid = _knn_radius(pts[:, :3], 0.8, 24)
    hop1 = np.all(np.where(valid, agree[idx], True), axis=1) & agree
    hood = np.all(np.where(valid, hop1[idx], True), axis=1) & hop1
    assert hood.sum() > 100
    np.testing.assert_allclose(got[hood][:, 7:], want[hood][:, 7:],
                               rtol=0.05, atol=1.5)


def test_isolated_points_give_zero_histograms():
    pts = np.array([[0.0, 0.0, 0.0], [100.0, 100.0, 100.0],
                    [200.0, 0.0, 50.0]])
    normals, fpfh = native.featurize_cloud(pts, 0.5, 16, 0.8, 24)
    assert np.all(np.isfinite(normals))
    np.testing.assert_array_equal(fpfh, 0.0)


def test_auto_takes_native_without_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)   # import fails
    calls = []
    real = native.featurize_cloud

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "featurize_cloud", counted)
    pts = _cloud(seed=4)
    kw = dict(normal_rad=0.5, normal_max_nn=16, fpfh_rad=0.8,
              fpfh_max_nn=24)
    got = pre.Featurizer(backend="auto", **kw).generate_features(pts)
    assert calls == [1]
    np.testing.assert_array_equal(
        got, pre.Featurizer(backend="native", **kw).generate_features(pts))
    with pytest.raises(ImportError):
        pre.Featurizer(backend="open3d", **kw).generate_features(pts)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
_BUILD_AND_RUN = """
import sys
import numpy as np
from pathlib import Path
from objectdetection_3d_tpu_torch import native, shared_lib
shared_lib.BUILD_DIR = Path(sys.argv[1])
normals, fpfh = native.featurize_cloud(
    np.random.default_rng(0).uniform(0, 2, (300, 3)), 0.5, 16, 0.8, 24)
assert np.isfinite(fpfh).all() and fpfh.shape == (300, 33)
print(native.native_library_path("featurize").name)
"""


def test_two_processes_building_at_once_both_load_a_whole_library(
        tmp_path):
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN,
                               str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(names)


def test_an_edited_source_gets_another_library(tmp_path, monkeypatch):
    before = native.native_library_path("featurize")
    edited = tmp_path / "featurize.cpp"
    edited.write_text(native.source_path("featurize").read_text()
                      + "\n// edited\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    after = native.native_library_path("featurize")
    assert after != before
    assert after.parent == before.parent == shared_lib.BUILD_DIR
    assert native.native_library_path("featurize") == after
