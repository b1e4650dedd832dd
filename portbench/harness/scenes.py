"""Synthetic forest scenes, the benchmark's inputs: frozen copies of the
port's ``scene.py`` generators (``tree_scene``, ``large_tree_scene``), so
that a change to the program cannot change what the benchmark feeds it.

A traffic file names a generator (one of these, or a file of its own
under ``portbench/scenes/``) and its parameters; :func:`make_pool` draws
a cell's pool of inputs from ``--seed``.
"""

import numpy as np


def _trunks(rng, extent, n_trees):
    """``n_trees`` trunk columns: their points and boxes (cx, cy, z0, 2r,
    2r, height, 0, 0, 0), z at the box bottom."""
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
    return pts, boxes


def _clutter(rng, extent, n):
    return np.concatenate(
        [rng.uniform([0, 0, 0], [extent, extent, 25], (n, 3)),
         rng.uniform(0, 0.3, (n, 1))], -1)


def tree_scene(rng, extent=40.0, n_trees=12, n_points=100_000):
    """An ``extent`` x ``extent`` m plot: trunk columns over uniform
    clutter, exactly ``n_points`` (x, y, z, reflectance) rows in random
    order, and each trunk's box."""
    pts, boxes = _trunks(rng, extent, n_trees)
    pts.append(_clutter(rng, extent, n_points - sum(len(p) for p in pts)))
    cloud = np.concatenate(pts).astype(np.float32)
    return (cloud[rng.permutation(len(cloud))],
            np.asarray(boxes, np.float32).reshape(-1, 9))


def large_tree_scene(rng, extent=160.0, n_trees=80, n_clutter=1_700_000):
    """A plot larger than the model's window: ``n_trees`` trunk columns
    (trunks first) over ``n_clutter`` clutter points, and the trunks'
    boxes."""
    pts, boxes = _trunks(rng, extent, n_trees)
    pts.append(_clutter(rng, extent, n_clutter))
    return (np.concatenate(pts).astype(np.float32),
            np.asarray(boxes, np.float32).reshape(-1, 9))


GENERATORS = {"tree_scene": tree_scene, "large_tree_scene": large_tree_scene}


def generator(name, root):
    """The scene generator ``name``: one of :data:`GENERATORS`, else the
    ``scene`` function of ``portbench/scenes/<name>.py`` under ``root``.
    A generator takes a ``numpy.random.Generator`` and the traffic's
    ``params`` and returns a (N, 4) float32 cloud and its (G, 9) float32
    boxes; every seed gives the same sizes."""
    if name in GENERATORS:
        return GENERATORS[name]
    from portbench.harness import plugins

    return plugins.load(root, "scenes", name).scene


def make_pool(traffic, seed, root):
    """The cell's inputs: ``traffic["pool"]`` scenes of
    ``traffic["generator"]`` with ``traffic["params"]``, each drawn from
    its own stream of ``seed``.  Every seed gives the same sizes."""
    gen = generator(traffic["generator"], root)
    streams = np.random.SeedSequence(int(seed)).spawn(int(traffic["pool"]))
    return [gen(np.random.default_rng(s), **traffic["params"])
            for s in streams]


def padded_batch(cloud, boxes, max_points, max_gt):
    """A B = 1 batch of host arrays: the cloud padded to ``max_points``
    rows, its boxes padded to ``max_gt`` under ``gt_mask``."""
    points = np.zeros((1, max_points, cloud.shape[1]), np.float32)
    points[0, :len(cloud)] = cloud
    bboxes = np.zeros((1, max_gt, 9), np.float32)
    bboxes[0, :len(boxes)] = boxes
    gt_mask = np.zeros((1, max_gt), bool)
    gt_mask[0, :len(boxes)] = True
    return {"points": points,
            "num_points": np.array([len(cloud)], np.int32),
            "bboxes": bboxes, "labels": np.zeros((1, max_gt), np.int32),
            "gt_mask": gt_mask}
