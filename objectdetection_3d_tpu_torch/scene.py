"""Synthetic forest scenes for driving the port on a card, and the card's
name and power limit.

``chip_smoke.py``, ``profile_predict`` and ``profile_train`` build their
clouds and ground-truth boxes here, so all three run the same inputs;
``chip_smoke.py`` and ``variant_times`` build the aligned clipper's box
pairs here too.
"""

import subprocess

import numpy as np

N_POINTS = 100_000
MAX_GT = 128


def card_line():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tree_scene(seed, extent=40.0, n_trees=12, n_points=N_POINTS):
    """A 40x40 m forest plot: trunk columns over uniform clutter.

    Returns exactly ``n_points`` points of (x, y, z, reflectance) and each
    trunk's box (cx, cy, z0, 2r, 2r, height, 0, 0, 0): z at the box
    bottom, angles in radians.
    """
    rng = np.random.default_rng(seed)
    pts, boxes = [], []
    for _ in range(n_trees):
        cx, cy = rng.uniform(2.0, extent - 2.0, 2)
        z0 = rng.uniform(0.2, 1.0)
        height = rng.uniform(10.0, 14.0)
        radius = rng.uniform(0.25, 0.45)
        k = int(rng.integers(2500, 4000))
        ang = rng.uniform(0, 2 * np.pi, k)
        rad = radius * np.sqrt(rng.uniform(0, 1, k))
        z = z0 + height * rng.uniform(0, 1, k) ** 0.7
        trunk = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang), z],
                         -1)
        refl = rng.uniform(0.3, 1.0, (k, 1))
        pts.append(np.concatenate([trunk, refl], -1))
        boxes.append([cx, cy, z0, 2 * radius, 2 * radius, height, 0, 0, 0])
    n_noise = n_points - sum(len(p) for p in pts)
    noise = np.concatenate(
        [rng.uniform([0, 0, 0], [extent, extent, 25], (n_noise, 3)),
         rng.uniform(0, 0.3, (n_noise, 1))], -1)
    pts.append(noise)
    cloud = np.concatenate(pts).astype(np.float32)
    return (cloud[rng.permutation(len(cloud))],
            np.asarray(boxes, np.float32))


def make_batch(scene, max_points, max_gt=MAX_GT):
    """A B=1 batch: the padded cloud and its boxes padded to ``max_gt``
    under ``gt_mask``."""
    cloud, boxes = scene
    points = np.zeros((1, max_points, 4), np.float32)
    points[0, :len(cloud)] = cloud
    bboxes = np.zeros((1, max_gt, 9), np.float32)
    bboxes[0, :len(boxes)] = boxes
    gt_mask = np.zeros((1, max_gt), bool)
    gt_mask[0, :len(boxes)] = True
    return {"points": points,
            "num_points": np.array([len(cloud)], np.int32),
            "bboxes": bboxes, "labels": np.zeros((1, max_gt), np.int32),
            "gt_mask": gt_mask}


def jittered(boxes, rng):
    """Copies of (N, 9) float32 ``boxes``, each shifted by up to +-0.4 of
    its own size on each axis and turned by up to +-0.3 rad about each
    axis (positions drawn first, then angles): most copies overlap their
    box."""
    out = np.array(boxes, np.float32)
    n = len(out)
    out[:, :3] += rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32) * \
        out[:, 3:6]
    out[:, 6:9] += rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    return out


def aligned_pair_inputs(anchors, gt_boxes):
    """The aligned clipper's two inputs over the model's (N, 9) anchors:
    ``drive``, each anchor against a random one of ``gt_boxes`` (numpy
    ``default_rng(0)``), as the JAX package's ``tools/profile_assign.py``
    pairs them; ``dense``, each anchor against its ``jittered`` copy
    (``default_rng(1)``).

    Returns:
        {name: (boxes1, boxes2)}, (N, 9) float32 numpy arrays.
    """
    anchors = np.asarray(anchors, np.float32)
    gt_boxes = np.asarray(gt_boxes, np.float32)
    ridx = np.random.default_rng(0).integers(0, len(gt_boxes),
                                             len(anchors))
    return {"drive": (gt_boxes[ridx], anchors),
            "dense": (anchors, jittered(anchors, np.random.default_rng(1)))}
