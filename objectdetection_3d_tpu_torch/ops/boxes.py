"""9-parameter rotated box geometry on tensors.

Box convention (as in the JAX package's ``ops/boxes.py``):
``(x, y, z, dx, dy, dz, rx, ry, rz)`` where ``z`` is the **bottom** of the
box, rotation is ``Rz @ Ry @ Rx`` about the bottom center ``(x, y, z)``,
and angles are radians.  What decode, NMS and the metrics use is ported
here, with the point and collision tests of GT sampling
(``ops/sampling.py``) and the host-side validators that
``run_inference(validate=True)`` and
``MetricEvaluator.evaluate(validate=True)`` run on user boxes.
"""

import math

import numpy as np
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


def corners_2d_envelope(boxes):
    """Unrotated 2D envelope, keeping rz: (..., 5) as (xmin, ymin, xmax,
    ymax, rz)."""
    x, y = boxes[..., 0], boxes[..., 1]
    hx, hy = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    return torch.stack([x - hx, y - hy, x + hx, y + hy, boxes[..., 8]],
                       dim=-1)


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


def box_planes(boxes):
    """Half-space form of (..., 9) boxes: a point x is inside iff
    ``n_i . x <= d_i`` for the six outward planes.

    Returns:
        normals (..., 6, 3) (the three axes, then their negatives) and
        offsets (..., 6).
    """
    rot, mid = box_axes(boxes)
    axes = rot.transpose(-1, -2)
    half = boxes[..., 3:6] * 0.5
    normals = torch.cat([axes, -axes], dim=-2)
    offsets = (torch.einsum("...ik,...k->...i", normals, mid)
               + torch.cat([half, half], dim=-1))
    return normals, offsets


def get_min_bbox(points):
    """PCA minimum vertical bounding box of a (P, >= 3) point set:
    ``(x, y, z_mid, w, l, h, yaw)`` from ``eigh`` of the 2x2 xy
    covariance (the JAX package's; the reference's ``torch.eig`` is
    gone)."""
    z = points[:, 2]
    h_min, h_max = z.min(), z.max()
    xy = points[:, :2]
    centered = xy - xy.mean(dim=0)
    cov = centered.T @ centered / (xy.shape[0] - 1)
    tvect = torch.linalg.eigh(cov)[1].T
    pts_rot = xy @ torch.linalg.inv(tvect)
    mn, mx = pts_rot.min(dim=0).values, pts_rot.max(dim=0).values
    diff = mx - mn
    center = (mn + diff * 0.5) @ tvect
    yaw = torch.atan2(tvect[0, 1], tvect[0, 0])
    return torch.stack([center[0], center[1], (h_min + h_max) * 0.5,
                        diff[0], diff[1], h_max - h_min, yaw])


# point-box pairs per chunk of points_in_boxes: its (chunk, N, 3)
# temporaries stay near 200 MB in float32 (1.95 M points x 100 boxes in one
# piece would take 2.3 GB each)
POINTS_IN_BOXES_PAIRS = 2 ** 24


def points_in_boxes(points, boxes, eps=0.0):
    """Mask of points inside rotated boxes: a point p is inside box b iff
    ``|axis_i . (p - mid)| * 2 < dim_i + eps`` on all three axes.

    Args:
        points: (P, >=3) tensor.
        boxes: (N, 9) tensor on the same device.
    Returns:
        (P, N) bool mask, computed in chunks of points of at most
        ``POINTS_IN_BOXES_PAIRS`` point-box pairs.
    """
    rot, mid = box_axes(boxes)
    limit = boxes[None, :, 3:6] + eps
    step = max(POINTS_IN_BOXES_PAIRS // max(boxes.shape[0], 1), 1)
    out = []
    for start in range(0, points.shape[0], step):
        d = points[start:start + step, None, :3] - mid[None]   # (p, N, 3)
        # axis coordinates, summed in the order of a 3-term dot product
        proj = (d[..., 0:1] * rot[None, :, 0] + d[..., 1:2] * rot[None, :, 1]
                + d[..., 2:3] * rot[None, :, 2])
        out.append((proj.abs() * 2 < limit).all(dim=-1))
    if not out:
        return torch.zeros((0, boxes.shape[0]), dtype=torch.bool,
                           device=boxes.device)
    return torch.cat(out)


def box_collision_test(boxes, qboxes):
    """(N, K) bool: the BEV envelopes of the rotated corners of ``boxes``
    and ``qboxes`` overlap."""
    a = rotated_corners_2d_envelope(boxes)
    b = rotated_corners_2d_envelope(qboxes)
    return iou_aabb_2d(a, b) > 0


# ---------------------------------------------------------------------------
# Host-side validators (numpy, raising)
# ---------------------------------------------------------------------------
# The IoU on the card is padding-safe (degenerate boxes get 0), so these
# run only at the host boundary, on user-supplied boxes.

# Quad faces of the coplanarity check, as corner indices.
_VALIDATE_PLANES = np.array(
    [[0, 1, 2, 3], [3, 2, 6, 7], [0, 1, 5, 4],
     [0, 3, 7, 4], [1, 2, 6, 5], [4, 5, 6, 7]])

# Triangle faces of the zero-area check.
_VALIDATE_TRIANGLES = np.array(
    [[0, 1, 2], [0, 3, 2], [4, 5, 6], [4, 6, 7], [1, 5, 6], [1, 6, 2],
     [0, 4, 7], [0, 7, 3], [3, 2, 6], [3, 6, 7], [0, 1, 5], [0, 4, 5]])


def _unit(v, eps=1e-12):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def check_coplanar(corners, eps=1e-4):
    """Raise ``ValueError`` when any box's quad faces are non-planar.

    Args:
        corners: (B, 8, 3) numpy corner sets.
    """
    corners = np.asarray(corners, np.float64)
    v0, v1, v2, v3 = np.moveaxis(
        corners[:, _VALIDATE_PLANES], 2, 0)  # each (B, 6, 3)
    normal = _unit(np.cross(_unit(v1 - v0), _unit(v2 - v0)))
    dev = np.einsum("bpk,bpk->bp", v3 - v0, normal)
    # NaN corners compare False -> flagged
    coplanar = np.all(np.abs(dev) < eps, axis=1)
    if not coplanar.all():
        raise ValueError(
            "Plane vertices are not coplanar. This applies for bboxes in "
            "positions: {}".format(np.flatnonzero(~coplanar)))


def check_nonzero(corners, eps=1e-4):
    """Raise ``ValueError`` when any box has a (near-)zero-area face.

    Args:
        corners: (B, 8, 3) numpy corner sets.
    """
    corners = np.asarray(corners, np.float64)
    v0, v1, v2 = np.moveaxis(corners[:, _VALIDATE_TRIANGLES], 2, 0)
    areas = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) / 2
    nonzero = ~np.any(~(areas >= eps), axis=1)  # NaN areas -> flagged
    if not nonzero.all():
        raise ValueError(
            "Planes have zero areas. This applies for bboxes in "
            "positions: {}".format(np.flatnonzero(~nonzero)))


def validate_boxes(boxes, eps=1e-4):
    """Validate host-side 9-param boxes: finite values, coplanar faces and
    nonzero face areas, raising ``ValueError`` otherwise.

    Args:
        boxes: (B, 9) numpy array (any input convertible to it).
    """
    boxes = np.asarray(boxes, np.float64).reshape(-1, 9)
    if boxes.size == 0:
        return
    if not np.isfinite(boxes).all():
        raise ValueError(
            "Boxes contain non-finite values. This applies for bboxes in "
            "positions: {}".format(
                np.flatnonzero(~np.isfinite(boxes).all(axis=1))))
    # here, not at the top: the augment package imports this module
    from objectdetection_3d_tpu_torch.augment.numpy_ops import (
        bbox2corners3D_np,
    )

    corners = np.stack([bbox2corners3D_np(b) for b in boxes])
    check_coplanar(corners, eps)
    check_nonzero(corners, eps)
