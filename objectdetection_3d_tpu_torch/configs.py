"""The port's own copies of the model configurations.

``flagship_cfg`` is the full reference architecture (400x400x100 grid,
392-channel pseudo-image, 12 anchors per cell) with the static budgets of
the JAX package's driver entry (``__graft_entry__._flagship_cfg``);
``tiny_cfg`` and ``tiny_model_cfg`` are the small configurations the JAX
package's multi-chip dry run and model tests use.  ``DEFAULT_TPU_CFG``
holds the defaults of the ``tpu`` section that the detector reads.
``preprocess_cfg`` is the repository ``config.yaml``'s ``model.preprocess``
section, for runs that have no YAML reader.

The model's ``device`` key is not read by ``PointPillars``, which takes
an explicit ``device=`` argument; the pipeline maps the config's device
through ``utils.convert_device_name``.
"""

import copy
import re

DEFAULT_TPU_CFG = {
    # padded per-cloud point budget fed to the voxelizer
    "max_points_static": 200_000,
    # padded occupied-voxel budget
    "max_voxels_static": 120_000,
    # padded ground-truth boxes per cloud
    "max_gt_static": 128,
    # anchors examined exactly per GT during target assignment
    "assign_candidates_per_gt": 512,
    # boxes surviving NMS kept in the static output buffer
    "max_detections": 256,
    # conv/matmul compute dtype ("float32" or "bfloat16")
    "compute_dtype": "float32",
    # gather-based vertical encoder (models/sparse_middle.py) and its
    # active sites per stage (0 = max_voxels_static)
    "sparse_middle": False,
    "sparse_budget": 0,
    "remat": True,
    "microbatch": 0,
}

_LOSS = dict(focal=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
             smooth_l1=dict(beta=0.11, loss_weight=2.0),
             cross_entropy=dict(loss_weight=0.2))


def flagship_cfg(tpu_overrides=None):
    """The full reference architecture with the benchmark's budgets
    (100k-point clouds, at most ~100k occupied voxels)."""
    tpu = {
        "max_points_static": 131_072,
        "max_voxels_static": 102_400,
        "max_gt_static": 128,
        "assign_candidates_per_gt": 512,
        "max_detections": 256,
        "compute_dtype": "bfloat16",
        "zfold_convs": True,
        "remat": True,
    }
    tpu.update(tpu_overrides or {})
    return dict(
        name="PointPillars",
        device="tpu",
        classes=["Tree"],
        input_features=[0, 1, 2, 3],
        point_cloud_range=[0.0, 0.0, 0.0, 40.0, 40.0, 30.0],
        voxelize=dict(max_voxel_points=50, voxel_size=[0.1, 0.1, 0.3],
                      max_voxels=7_500_000),
        voxel_encoder=dict(in_channels=4, feat_channels=[20],
                           voxel_size=[0.1, 0.1, 0.3]),
        vertical_encoder=dict(in_channels=20,
                              out_channels=[20, 32, 64, 128, 196]),
        backbone=dict(in_channels=392, out_channels=[196, 128, 128],
                      layer_nums=[1, 1, 1], layer_strides=[2, 2, 2]),
        neck=dict(),
        head=dict(in_channels=128, nms_pre=500, nms_thresh=1e-5,
                  score_thr=0.3,
                  ranges=[[0.0, 0.0, 0.0, 40.0, 40.0, 30.0]],
                  sizes=[[0.75, 0.75, 12], [1.3, 1.3, 17], [1.0, 1.75, 20]],
                  rotations=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.57],
                             [0.3142, 0.0, 0.0], [-0.3142, 0.0, 0.0]],
                  iou_thr=[[0.08, 0.2]]),
        loss=copy.deepcopy(_LOSS),
        augment=dict(PointShuffle=True),
        tpu=tpu,
        seed=0,
    )


def tiny_cfg():
    """Small grid (16x16x4, 2 anchors per cell) with the full program
    structure."""
    return dict(
        name="PointPillars",
        device="tpu",
        classes=["Tree"],
        input_features=[0, 1, 2, 3],
        point_cloud_range=[0.0, 0.0, 0.0, 8.0, 8.0, 4.0],
        voxelize=dict(max_voxel_points=8, voxel_size=[0.5, 0.5, 1.0],
                      max_voxels=4096),
        voxel_encoder=dict(in_channels=4, feat_channels=[16],
                           voxel_size=[0.5, 0.5, 1.0]),
        vertical_encoder=dict(in_channels=16, out_channels=[16]),
        backbone=dict(in_channels=16, out_channels=[16, 16],
                      layer_nums=[1, 1], layer_strides=[1, 1]),
        neck=dict(),
        head=dict(in_channels=16, nms_pre=64, nms_thresh=1e-5,
                  score_thr=0.3,
                  ranges=[[0.0, 0.0, 0.0, 8.0, 8.0, 4.0]],
                  sizes=[[0.8, 0.8, 2.5]],
                  rotations=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.57]],
                  iou_thr=[[0.08, 0.2]]),
        loss=copy.deepcopy(_LOSS),
        augment=dict(),
        tpu=dict(max_points_static=1024, max_voxels_static=256,
                 max_gt_static=8, assign_candidates_per_gt=64,
                 max_detections=16, compute_dtype="float32"),
        seed=0,
    )


def tiny_model_cfg():
    """A miniature model: 16x16x4 grid, 4 anchors per cell."""
    return dict(
        name="PointPillars",
        device="cpu",
        classes=["Tree"],
        input_features=[0, 1, 2, 3],
        point_cloud_range=[0.0, 0.0, 0.0, 8.0, 8.0, 4.0],
        voxelize=dict(max_voxel_points=8,
                      voxel_size=[0.5, 0.5, 1.0],
                      max_voxels=256),
        voxel_encoder=dict(in_channels=4, feat_channels=[16],
                           voxel_size=[0.5, 0.5, 1.0]),
        vertical_encoder=dict(in_channels=16, out_channels=[16]),
        backbone=dict(in_channels=16, out_channels=[16, 16],
                      layer_nums=[1, 1], layer_strides=[1, 1]),
        neck=dict(),
        head=dict(in_channels=16, nms_pre=64, nms_thresh=1e-5,
                  score_thr=0.3,
                  ranges=[[0.0, 0.0, 0.0, 8.0, 8.0, 4.0]],
                  sizes=[[0.6, 0.6, 2.0], [1.0, 1.0, 3.0]],
                  rotations=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.57]],
                  iou_thr=[[0.08, 0.2]],
                  box_params_num=9, nms_dim=3),
        loss=copy.deepcopy(_LOSS),
        augment=dict(PointShuffle=True),
        tpu=dict(max_points_static=2048, max_voxels_static=256,
                 max_gt_static=8, assign_candidates_per_gt=64,
                 max_detections=32, compute_dtype="float32"),
        seed=0,
    )


def preprocess_cfg(filter_path="./models/"):
    """``config.yaml``'s ``model.preprocess`` (the offline chain of
    ``tools.prepare_data``), with the filter's checkpoint folder
    ``filter_path``."""
    return dict(
        voxelization=dict(voxel_size=[0.03, 0.03, 0.03],
                          max_voxel_points=15, reflectance_sampling=True),
        featurizer=dict(normal_rad=0.1, normal_max_nn=50, fpfh_rad=0.1,
                        fpfh_max_nn=50),
        filter=dict(path=filter_path, filter_type="mlp",
                    mlp=dict(device="tpu",
                             classes={0: "background", 1: "foreground"},
                             input_channels=37, trunk_confidence=0.5),
                    xgboost=dict(trunk_confidence=0.75)),
    )


def parse_tpu_overrides(items):
    """``["key=value", ...]`` -> a ``tpu`` override dict for
    :func:`flagship_cfg`; ``true``/``false`` become booleans and integers
    ints (``decompose_convs=2``), anything else stays a string."""
    out = {}
    for item in items:
        key, sep, val = item.partition("=")
        if not sep or not key:
            raise ValueError(f"expected key=value, got {item!r}")
        low = val.lower()
        if low in ("true", "false"):
            out[key] = low == "true"
        elif re.fullmatch(r"-?\d+", val):
            out[key] = int(val)
        else:
            out[key] = val
    return out
