"""9-parameter rotated box geometry on tensors.

Box convention (as in the JAX package's ``ops/boxes.py``):
``(x, y, z, dx, dy, dz, rx, ry, rz)`` where ``z`` is the **bottom** of the
box, rotation is ``Rz @ Ry @ Rx`` about the bottom center ``(x, y, z)``,
and angles are radians.  Only what decode and NMS use is ported here.
"""

import math

import torch

# Corner layout: p0=(-,-,z) p1=(+,-,z) p2=(+,+,z) p3=(-,+,z) bottom,
# p4..p7 the same xy at z+dz (top).
_CORNER_SIGNS = (
    (-1.0, -1.0, 0.0),
    (1.0, -1.0, 0.0),
    (1.0, 1.0, 0.0),
    (-1.0, 1.0, 0.0),
    (-1.0, -1.0, 1.0),
    (1.0, -1.0, 1.0),
    (1.0, 1.0, 1.0),
    (-1.0, 1.0, 1.0),
)


def rotation_matrices(rx, ry, rz):
    """Rz @ Ry @ Rx rotation matrices for batched angles.

    Args:
        rx, ry, rz: tensors of shape (...,).
    Returns:
        (..., 3, 3) rotation matrices.
    """
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rot_x = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    rot_y = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    rot_z = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return (rot_z @ rot_y) @ rot_x


def box_corners_3d(boxes):
    """9-param boxes -> (..., 8, 3) rotated corners about the bottom
    center, ``(corner - c) @ R^T + c``."""
    center = boxes[..., :3]
    dims = boxes[..., 3:6]
    half = torch.cat([dims[..., :2] * 0.5, dims[..., 2:3]], dim=-1)
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype,
                         device=boxes.device)
    local = signs * half[..., None, :]
    rot = rotation_matrices(boxes[..., 6], boxes[..., 7], boxes[..., 8])
    rotated = local @ rot.transpose(-1, -2)
    return rotated + center[..., None, :]


def rotated_corners_2d_envelope(boxes):
    """(..., 4) axis-aligned (xmin, ymin, xmax, ymax) envelope of the
    rotated corners."""
    corners = box_corners_3d(boxes)
    mn = corners[..., :2].amin(dim=-2)
    mx = corners[..., :2].amax(dim=-2)
    return torch.cat([mn, mx], dim=-1)


def iou_aabb_2d(bboxes1, bboxes2, eps=1e-6):
    """Pairwise IoU of (N, 4) and (K, 4) axis-aligned boxes given as
    (x1, y1, x2, y2); returns (N, K)."""
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (
        bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (
        bboxes2[..., 3] - bboxes2[..., 1])

    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:4],
                       bboxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., None] + area2[..., None, :] - overlap
    return overlap / union.clamp(min=eps)


def limit_period(val, offset=0.5, period=math.pi):
    """Wrap into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def box_axes(boxes):
    """Unit axes (columns of R) and mid-center of each box.

    Returns:
        axes: (..., 3, 3) where axes[..., :, i] is the i-th box axis.
        mid:  (..., 3) volumetric center (bottom center + az*dz/2).
    """
    rot = rotation_matrices(boxes[..., 6], boxes[..., 7], boxes[..., 8])
    mid = boxes[..., :3] + rot[..., :, 2] * boxes[..., 5:6] * 0.5
    return rot, mid
