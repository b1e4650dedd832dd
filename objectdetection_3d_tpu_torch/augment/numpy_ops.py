"""Host-side numpy point-cloud ops used by preprocessing and augmentation.

The port's copy of the JAX package's ``augment/numpy_ops.py``: the same
functions, the same numpy calls, so the same seed gives the same arrays.
"""

import numpy as np


def global_outlier_check(point_cloud):
    """Drop points whose distance from the centroid exceeds mean + 5
    sigma."""
    xyz = point_cloud[:, :3]
    norm = np.sqrt(np.sum((xyz - xyz.mean(axis=0)) ** 2, axis=1))
    return point_cloud[norm < norm.mean() + 5 * norm.std(), :]


def recenter(points):
    """Shift xyz to the centroid; returns (points, shift)."""
    shift = points[:, :3].mean(0)
    points = points.copy()
    points[:, :3] -= shift
    return points, shift


def normalize(points, method):
    """Normalize spatial (or all) feature columns to [0, 1]-ish range."""
    points = points.copy()
    if method == "spatial":
        points[:, :3] -= points[:, :3].mean(0)
        points[:, :3] /= points[:, :3].max(0) - points[:, :3].min(0)
    elif method == "all":
        points[:, :-1] -= points[:, :-1].mean(0)
        points[:, :-1] /= points[:, :-1].max(0) - points[:, :-1].min(0)
    else:
        raise ValueError(f"Unsupported method : {method}")
    return points


def vertical_cropper(points, vertical_range):
    """Crop to a vertical band above the cloud minimum."""
    z0 = points[:, 2].min()
    lo, hi = vertical_range
    sel = (points[:, 2] > z0 + lo) & (points[:, 2] < z0 + hi)
    return points[sel, :]


def point_shuffle(points, rng):
    idx = rng.permutation(points.shape[0])
    return points[idx]


def rotation_matrix_zyx(rx, ry, rz):
    """Yaw @ pitch @ roll composition used by the host rotate op."""
    roll = np.array([[1, 0, 0],
                     [0, np.cos(rx), -np.sin(rx)],
                     [0, np.sin(rx), np.cos(rx)]])
    pitch = np.array([[np.cos(ry), 0, np.sin(ry)],
                      [0, 1, 0],
                      [-np.sin(ry), 0, np.cos(ry)]])
    yaw = np.array([[np.cos(rz), -np.sin(rz), 0],
                    [np.sin(rz), np.cos(rz), 0],
                    [0, 0, 1]])
    return roll, pitch, yaw


def rotate(points, rot_limits, method, rng):
    """Random rotation within per-axis degree limits."""
    rotations = [
        np.deg2rad(rng.uniform(rot_limits[0], rot_limits[3])),
        np.deg2rad(rng.uniform(rot_limits[1], rot_limits[4])),
        np.deg2rad(rng.uniform(rot_limits[2], rot_limits[5])),
    ]
    roll, pitch, yaw = rotation_matrix_zyx(*rotations)
    points = points.copy()
    if method == "vertical":
        points[:, :3] = points[:, :3] @ yaw
    elif method == "all":
        points[:, :3] = points[:, :3] @ roll @ pitch @ yaw
    else:
        raise ValueError(f"Unsupported method : {method}")
    return points


def scale(points, scale_limits, anisotropic, rng):
    """Random (an)isotropic scaling of xyz."""
    if anisotropic:
        factor = rng.uniform(scale_limits[0], scale_limits[1],
                             points.shape[0])[:, None]
    else:
        factor = rng.uniform(scale_limits[0], scale_limits[1])
    points = points.copy()
    points[:, :3] = points[:, :3] * factor
    return points


def random_noise_addition(points, deviation_limits, rng):
    """Add Gaussian xyz noise with a random std from the given range."""
    std = rng.uniform(deviation_limits[0], deviation_limits[1])
    points = points.copy()
    points[:, :3] += rng.normal(0, std, size=(points.shape[0], 3))
    return points


def size_downsampler(points, max_points, rng):
    """Random subsample to at most ``max_points``."""
    idx = rng.permutation(points.shape[0])
    return points[idx[:max_points], :]


def create_3D_rotations(axis, angle):
    """Rotation matrices from axes and angles (quaternion identity).

    Args:
        axis: (N, 3) unit axes, angle: (N,) radians.
    Returns:
        (N, 3, 3).
    """
    t1 = np.cos(angle)
    t2 = 1 - t1
    t3 = axis[:, 0] * axis[:, 0]
    t6 = t2 * axis[:, 0]
    t7 = t6 * axis[:, 1]
    t8 = np.sin(angle)
    t9 = t8 * axis[:, 2]
    t11 = t6 * axis[:, 2]
    t12 = t8 * axis[:, 1]
    t15 = axis[:, 1] * axis[:, 1]
    t19 = t2 * axis[:, 1] * axis[:, 2]
    t20 = t8 * axis[:, 0]
    t24 = axis[:, 2] * axis[:, 2]
    r = np.stack([
        t1 + t2 * t3, t7 - t9, t11 + t12,
        t7 + t9, t1 + t2 * t15, t19 - t20,
        t11 - t12, t19 + t20, t1 + t2 * t24,
    ], axis=1)
    return r.reshape(-1, 3, 3)


def bbox2corners3D_np(box):
    """Single 9-param box -> 8 corners (numpy, for ObjectRangeFilter)."""
    x, y, z, dx, dy, dz, rx, ry, rz = box[:9]
    signs = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=np.float64)
    local = signs * np.array([dx / 2, dy / 2, dz])
    roll, pitch, yaw = rotation_matrix_zyx(rx, ry, rz)
    rot = yaw @ pitch @ roll
    return local @ rot.T + np.array([x, y, z])
