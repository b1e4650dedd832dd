"""Ground-truth sampling and point-labeling support ops.

Port of the JAX package's ``ops/sampling.py``: box faces and surface
normals, semantic point labels inside boxes, the removal of the points
inside boxes, and collision-filtered sampling from the GT database (the
machinery of the ``ObjectSample`` augmentation).  The box tests are torch
and run on the ``device`` the caller names; the host-facing functions take
and return numpy arrays.  Random draws come from the numpy ``Generator``
the caller passes (the loader's per-item RNG), as in the JAX package, so
the same generator state samples the same entries.
"""

import copy
import random

import numpy as np
import torch

from objectdetection_3d_tpu_torch.ops.boxes import (
    box_collision_test,
    box_corners_3d,
    points_in_boxes,
)
from objectdetection_3d_tpu_torch.ops.iou3d import FACES_OUTWARD


def corner2faces3d(corners):
    """(N, 8, 3) corners -> (N, 6, 4, 3) quad faces, outward winding."""
    return corners[:, torch.as_tensor(FACES_OUTWARD, device=corners.device)]


def surface_normals(corners):
    """Normal vectors (N, 6, 3) and plane offsets (N, 6) of the box
    faces."""
    faces = corner2faces3d(corners)
    surf_vec = faces[:, :, :2, :] - faces[:, :, 1:3, :]
    normal_vec = torch.cross(surf_vec[:, :, 0, :], surf_vec[:, :, 1, :],
                             dim=-1)
    direction = torch.einsum("aij,aij->ai", normal_vec, faces[:, :, 0, :])
    return normal_vec, -direction


def get_semantic_label(points, boxes, ground_level, effective_trunk):
    """(P,) int32 labels of (P, >=3) ``points`` against (N, 9) ``boxes``
    (tensors on one device): trunk 1, ground 0, noise -1.

    A point inside a box is a trunk point unless it lies below
    ``box_bottom + ground_level`` (ground) or above
    ``box_bottom + effective_trunk * dz`` (noise).
    """
    inside = points_in_boxes(points, boxes)          # (P, N)
    z = points[:, 2:3]
    bottom = boxes[None, :, 2]
    dz = boxes[None, :, 5]
    ground = z < bottom + ground_level
    noisy = z > bottom + effective_trunk * dz
    trunk = inside & ~ground & ~noisy
    noise = inside & noisy
    label = torch.zeros((points.shape[0],), dtype=torch.int32,
                        device=points.device)
    label = torch.where(trunk.any(dim=1), 1, label)
    label = torch.where(noise.any(dim=1), -1, label)
    return label.to(torch.int32)


def remove_points_in_boxes(points, boxes, device="cpu"):
    """The rows of the numpy ``points`` outside every (N, 9) box."""
    points = np.asarray(points)
    mask = points_in_boxes(
        torch.as_tensor(np.asarray(points[:, :3], np.float32), device=device),
        torch.as_tensor(np.asarray(boxes, np.float32), device=device))
    return points[~mask.any(dim=1).cpu().numpy()]


def random_sample(files, num, rng=None):
    """Up to ``num`` entries of ``files``: ``rng.choice`` without
    replacement from a numpy ``Generator`` (reproducible per item), or
    ``random.sample`` when ``rng`` is None."""
    if len(files) <= num:
        return files
    if rng is not None:
        idx = rng.choice(len(files), size=num, replace=False)
        return [files[i] for i in idx]
    return random.sample(files, num)


def sample_class(num, gt_boxes, db_boxes, rng=None, device="cpu"):
    """Collision-filtered sampling of database objects into a scene:
    ``num`` entries drawn from ``db_boxes``, and those whose BEV envelope
    overlaps a ground-truth box or an earlier kept sample rejected."""
    if num == 0:
        return []
    sampled = copy.deepcopy(random_sample(db_boxes, num, rng=rng))

    num_gt = len(gt_boxes)
    boxes = [np.asarray(b, np.float32) for b in gt_boxes]
    boxes += [np.asarray(s["bbox"], np.float32) for s in sampled]
    bboxes = torch.as_tensor(
        np.stack(boxes) if boxes else np.zeros((0, 9), np.float32),
        device=device)
    coll = box_collision_test(bboxes, bboxes).cpu().numpy()
    np.fill_diagonal(coll, False)

    valid_samples = []
    for i in range(num_gt, num_gt + len(sampled)):
        if coll[i].any():
            coll[i] = False
            coll[:, i] = False
        else:
            valid_samples.append(sampled[i - num_gt])
    return valid_samples


def filter_by_min_points(bboxes, min_points_dict):
    """The GT dicts with more interior points than their label's minimum
    (labels without a minimum are all kept)."""
    filtered_boxes = []
    for box in bboxes:
        if box["label"] in min_points_dict:
            if (box["points_inside_box"].shape[0]
                    > min_points_dict[box["label"]]):
                filtered_boxes.append(box)
        else:
            filtered_boxes.append(box)
    return filtered_boxes


def get_boxes_normals(boxes):
    """(N, 9) boxes -> (N, 15): the dims and the three unit axis
    vectors."""
    corners = box_corners_3d(boxes)
    norm_x = (corners[:, 1] - corners[:, 0]) / boxes[:, 3:4]
    norm_y = (corners[:, 3] - corners[:, 0]) / boxes[:, 4:5]
    norm_z = (corners[:, 4] - corners[:, 0]) / boxes[:, 5:6]
    normals = torch.cat([norm_x, norm_y, norm_z], dim=-1)
    return torch.cat([boxes[:, :6], normals], dim=-1)
