"""Rotated 3D box overlap.

Only the separating-axis intersection test is ported in this slice: it is
what NMS runs at the flagship ``nms_thresh`` of 1e-5.  The exact
Sutherland-Hodgman volume clipper (``iou3d`` in the JAX package) comes with
the training slice.
"""

import torch

from objectdetection_3d_tpu_torch.ops.boxes import box_axes


def obb_intersect(boxes1, boxes2, margin=0.0):
    """Exact pairwise intersection TEST of rotated 3D boxes (SAT).

    Two convex boxes are disjoint iff one of 15 candidate axes separates
    them (3 face normals each + 9 edge cross products).

    Args:
        boxes1: (N, 9), boxes2: (K, 9).
        margin: positive shrinks boxes (stricter), negative expands.
    Returns:
        (N, K) bool intersection matrix.
    """
    rot1, mid1 = box_axes(boxes1)      # (N, 3, 3) columns = axes
    rot2, mid2 = box_axes(boxes2)
    half1 = boxes1[:, 3:6] * 0.5       # (N, 3)
    half2 = boxes2[:, 3:6] * 0.5
    n, k = boxes1.shape[0], boxes2.shape[0]

    ax1 = rot1.transpose(-1, -2)       # (N, 3 axes, 3)
    ax2 = rot2.transpose(-1, -2)       # (K, 3 axes, 3)

    # 15 candidate axes per pair: (N, K, 15, 3)
    a1 = ax1[:, None, :, :].expand(n, k, 3, 3)
    a2 = ax2[None, :, :, :].expand(n, k, 3, 3)
    cross = torch.linalg.cross(a1[:, :, :, None, :].expand(n, k, 3, 3, 3),
                               a2[:, :, None, :, :].expand(n, k, 3, 3, 3),
                               dim=-1)
    cross = cross.reshape(n, k, 9, 3)
    axes = torch.cat([a1, a2, cross], dim=2)
    # degenerate cross products (parallel edges) project everything to 0;
    # normalize defensively and mask them out of the separation test
    norm = torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    ok_axis = norm[..., 0] > 1e-6
    axes = axes / norm.clamp(min=1e-6)

    d = mid2[None, :, :] - mid1[:, None, :]          # (N, K, 3)
    dist = torch.einsum("nkai,nki->nka", axes, d).abs()
    # projection radii: r = sum_b half_b * |axis . box_axis_b|
    proj1 = torch.einsum("nkai,nbi->nkab", axes, ax1).abs()
    r1 = torch.einsum("nkab,nb->nka", proj1, half1)
    proj2 = torch.einsum("nkai,kbi->nkab", axes, ax2).abs()
    r2 = torch.einsum("nkab,kb->nka", proj2, half2)

    separated = ok_axis & (dist > r1 + r2 + margin)
    return ~separated.any(dim=-1)
