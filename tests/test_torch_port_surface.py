"""The last public names of the JAX package that the port lacked, each
against its JAX counterpart on seeded float32 inputs (1e-5), and the
warning for the JAX package's kernel switches (ROADMAP C15).

* ``ops/boxes.py``: ``get_min_bbox``, ``box_planes``;
* ``ops/iou3d.py``: ``intersection_volume_3d``,
  ``intersection_volume_3d_aligned``, ``iou3d_upper_bound``;
* ``models/layers.py``: ``get_paddings_indicator`` (and its numpy
  form);
* ``utils.py``: ``convert_framework_name`` (the port's framework is
  torch where the JAX package's is jax);
* ``ops/__init__.py``: the JAX package's re-exports, ``voxelize``
  against the JAX ``voxelize`` exactly.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import objectdetection_3d_tpu.ops as jax_ops
import objectdetection_3d_tpu_torch.ops as port_ops
from objectdetection_3d_tpu import utils as jax_utils
from objectdetection_3d_tpu.models import layers as jax_layers
from objectdetection_3d_tpu.ops import boxes as jax_boxes
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch import utils as port_utils
from objectdetection_3d_tpu_torch.models import detector
from objectdetection_3d_tpu_torch.models import layers as port_layers
from objectdetection_3d_tpu_torch.ops import boxes as port_boxes

# the modules: the packages' ``iou3d`` is the function
jax_iou3d = importlib.import_module("objectdetection_3d_tpu.ops.iou3d")
port_iou3d = importlib.import_module("objectdetection_3d_tpu_torch.ops.iou3d")

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(rng, n, spread=3.0):
    """(n, 9) rotated boxes near one another: bottom centres, sizes,
    angles in radians."""
    return np.concatenate([rng.uniform(-spread, spread, (n, 3)),
                           rng.uniform(0.5, 3.0, (n, 3)),
                           rng.uniform(-0.4, 0.4, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_get_min_bbox_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(4):
        pts = rng.normal(0, 1, (200, 3)).astype(np.float32)
        pts[:, :2] = pts[:, :2] @ rng.normal(0, 1, (2, 2)).astype(
            np.float32) + seed
        _close(port_boxes.get_min_bbox(torch.from_numpy(pts)),
               jax_boxes.get_min_bbox(jnp.asarray(pts)), rtol=1e-5,
               atol=1e-4)


def test_box_planes_match_jax():
    b = _boxes(np.random.default_rng(1), 16)
    got = port_boxes.box_planes(torch.from_numpy(b))
    want = jax_boxes.box_planes(jnp.asarray(b))
    for g, w in zip(got, want):
        _close(g, w)


def test_intersection_volumes_and_upper_bound_match_jax():
    rng = np.random.default_rng(2)
    b1, b2 = _boxes(rng, 12), _boxes(rng, 9)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    want = np.asarray(jax_iou3d.intersection_volume_3d(jnp.asarray(b1),
                                                       jnp.asarray(b2)))
    assert (want > 1e-3).sum() > 5       # the boxes do overlap
    _close(port_iou3d.intersection_volume_3d(t1, t2), want)
    _close(port_iou3d.intersection_volume_3d_aligned(t1[:9], t2),
           jax_iou3d.intersection_volume_3d_aligned(jnp.asarray(b1[:9]),
                                                    jnp.asarray(b2)))
    bound = port_iou3d.iou3d_upper_bound(t1, t2)
    _close(bound, jax_iou3d.iou3d_upper_bound(jnp.asarray(b1),
                                              jnp.asarray(b2)))
    assert bool((bound + 1e-6 >= port_iou3d.iou3d(t1, t2)).all())


@pytest.mark.parametrize("axis", [0, 1])
def test_get_paddings_indicator_matches_jax(axis):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, (4, 5)).astype(np.int32)
    got = port_layers.get_paddings_indicator(torch.from_numpy(counts), 8,
                                             axis=axis)
    want = jax_layers.get_paddings_indicator(jnp.asarray(counts), 8,
                                             axis=axis)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_layers.get_paddings_indicator_np(counts[0], 8),
        jax_layers.get_paddings_indicator_np(counts[0], 8))


@pytest.mark.parametrize("name", ["jax", "torch", "PyTorch", "tf", "mxnet"])
def test_convert_framework_name_accepts_the_jax_names(name):
    try:
        want = jax_utils.convert_framework_name(name)
    except KeyError:
        with pytest.raises(KeyError):
            port_utils.convert_framework_name(name)
        return
    assert want == "jax"
    assert port_utils.convert_framework_name(name) == "torch"


def test_ops_reexports_the_jax_names():
    jax_names = {n for n in dir(jax_ops) if not n.startswith("_")
                 and callable(getattr(jax_ops, n))}
    assert jax_names <= set(dir(port_ops))


def test_voxelize_matches_jax():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(0, 4, (300, 3)),
                          rng.uniform(0, 1, (300, 1))], 1).astype(np.float32)
    kw = dict(voxel_size=(0.5, 0.5, 1.0),
              point_cloud_range=(0.0, 0.0, 0.0, 4.0, 4.0, 4.0),
              max_points_per_voxel=4, max_voxels=64)
    got = port_ops.voxelize(torch.from_numpy(pts), 250, **kw)
    want = jax_ops.voxelize(jnp.asarray(pts), 250, **kw)
    for k in ("voxels", "coords", "num_points_per_voxel", "num_voxels",
              "voxel_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("switch, value", [
    ("pallas_voxel_scan", False), ("pallas_grid_scatter", False),
    ("assign_geometry", "xla"), ("assign_prefilter_block", 64)])
def test_kernel_switches_warn_once_naming_c15(switch, value, caplog,
                                              monkeypatch):
    monkeypatch.setattr(detector, "_switches_warned", set())
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], **{switch: value})
    with caplog.at_level(logging.WARNING, logger=detector.__name__):
        detector.PointPillars(cfg, device="cpu")
        detector.PointPillars(cfg, device="cpu")
    warned = [r.getMessage() for r in caplog.records
              if "C15" in r.getMessage()]
    assert len(warned) == 1 and switch in warned[0]


def test_default_kernel_switches_do_not_warn(caplog, monkeypatch):
    monkeypatch.setattr(detector, "_switches_warned", set())
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], pallas_voxel_scan=True,
                      assign_geometry="auto")
    with caplog.at_level(logging.WARNING, logger=detector.__name__):
        detector.PointPillars(cfg, device="cpu")
    assert not [r for r in caplog.records if "C15" in r.getMessage()]
