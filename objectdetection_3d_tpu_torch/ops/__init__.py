"""Tensor ops of the port: box geometry, voxelization, the CUDA kernels
and NMS, with the JAX package's ``ops`` re-exports.  Importing the
package registers predict's kernels as the ``torch.ops.od3d`` custom
operators (``custom_ops``), which their wrappers call."""

from objectdetection_3d_tpu_torch.ops import custom_ops  # noqa: F401
from objectdetection_3d_tpu_torch.ops.boxes import (  # noqa: F401
    box_collision_test,
    box_corners_3d,
    corners_2d_envelope,
    get_min_bbox,
    iou_aabb_2d,
    limit_period,
    points_in_boxes,
    rotated_corners_2d_envelope,
    rotation_matrices,
)
from objectdetection_3d_tpu_torch.ops.iou3d import (  # noqa: F401
    iou3d,
    iou3d_aligned,
)
from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms  # noqa: F401
from objectdetection_3d_tpu_torch.ops.voxelize import (  # noqa: F401
    Voxelizer,
    voxelize,
)
