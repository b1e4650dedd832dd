"""Synthetic forest scenes for driving the port on a card, and the card's
name and power limit.

``chip_smoke.py``, ``profile_predict`` and ``profile_train`` build their
clouds and ground-truth boxes here, so all three run the same inputs;
``chip_smoke.py`` and ``variant_times`` build the aligned clipper's box
pairs here too, and ``chip_smoke.py`` its plot-scale scene, its scenes of
leaning trunks and its synthetic reference state dicts (the detector's
and the foreground filter MLP's).
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


def _rotation_zyx(rx, ry, rz):
    """Rz @ Ry @ Rx, float64 (the box convention of ``ops/boxes.py``)."""
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rot_z @ rot_y @ rot_x


def tilted_tree_scene(seed, extent=40.0, n_trees=12, n_points=N_POINTS,
                      max_tilt=0.15):
    """A 40x40 m plot of leaning trunks over uniform clutter: as
    :func:`tree_scene`, but each trunk leans by rx and ry drawn from
    U(-max_tilt, max_tilt) rad about its bottom centre, and its yaw rz
    from U(-pi, pi).

    Returns exactly ``n_points`` points of (x, y, z, reflectance) and each
    trunk's box (cx, cy, z0, 2r, 2r, height, rx, ry, rz), z at the box
    bottom, angles in radians; every trunk point lies inside its box.
    """
    rng = np.random.default_rng(seed)
    pts, boxes = [], []
    for _ in range(n_trees):
        cx, cy = rng.uniform(2.0, extent - 2.0, 2)
        z0 = rng.uniform(0.2, 1.0)
        height = rng.uniform(10.0, 14.0)
        radius = rng.uniform(0.25, 0.45)
        rx, ry = rng.uniform(-max_tilt, max_tilt, 2)
        rz = rng.uniform(-np.pi, np.pi)
        k = int(rng.integers(2500, 4000))
        ang = rng.uniform(0, 2 * np.pi, k)
        # 0.98: keep each point off the box faces by float rounding
        rad = 0.98 * radius * np.sqrt(rng.uniform(0, 1, k))
        z = height * (0.005 + 0.99 * rng.uniform(0, 1, k) ** 0.7)
        local = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1)
        trunk = local @ _rotation_zyx(rx, ry, rz).T + [cx, cy, z0]
        refl = rng.uniform(0.3, 1.0, (k, 1))
        pts.append(np.concatenate([trunk, refl], -1))
        boxes.append([cx, cy, z0, 2 * radius, 2 * radius, height, rx, ry,
                      rz])
    n_noise = n_points - sum(len(p) for p in pts)
    noise = np.concatenate(
        [rng.uniform([0, 0, 0], [extent, extent, 25], (n_noise, 3)),
         rng.uniform(0, 0.3, (n_noise, 1))], -1)
    pts.append(noise)
    cloud = np.concatenate(pts).astype(np.float32)
    return (cloud[rng.permutation(len(cloud))],
            np.asarray(boxes, np.float32))


def large_tree_scene(extent=160.0, n_trees=80, n_noise=1_700_000, seed=0):
    """A plot larger than the model's window: ``n_trees`` trunk columns
    over ``n_noise`` clutter points on an ``extent`` x ``extent`` m square,
    (N, 4) float32 (x, y, z, reflectance), trunks first.

    The same array, bit for bit, as the JAX package's benchmark scene
    (``bench.py::_tree_scene``); the defaults are its 160 x 160 m,
    1,953,668-point scene, 25 tiles of the flagship's 40 x 40 m window at
    5 m overlap.
    """
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n_trees):
        cx, cy = rng.uniform(2.0, extent - 2.0, 2)
        z0 = rng.uniform(0.2, 1.0)
        height = rng.uniform(10.0, 14.0)
        radius = rng.uniform(0.25, 0.45)
        k = int(rng.integers(2500, 4000))
        ang = rng.uniform(0, 2 * np.pi, k)
        rad = radius * np.sqrt(rng.uniform(0, 1, k))
        z = z0 + height * rng.uniform(0, 1, k) ** 0.7
        trunk = np.stack([cx + rad * np.cos(ang),
                          cy + rad * np.sin(ang), z], -1)
        refl = rng.uniform(0.3, 1.0, (k, 1))
        pts.append(np.concatenate([trunk, refl], -1))
    noise = np.concatenate(
        [rng.uniform([0, 0, 0], [extent, extent, 25], (n_noise, 3)),
         rng.uniform(0, 0.3, (n_noise, 1))], -1)
    pts.append(noise)
    return np.concatenate(pts).astype(np.float32)


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


def reference_state_dict(net, seed=0):
    """A synthetic state dict of the reference detector, in its own names
    and layouts (spconv KRSC convs, three direction convs), at the widths
    of the port's ``PointPillarsNet`` ``net``: what
    ``models/torch_import.load_reference_pth`` reads.  Weights are drawn
    from ``default_rng(seed)`` at a 1 / fan-in variance; batch norms get
    random affines and running statistics.
    """
    rng = np.random.default_rng(seed)
    shape = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    sd = {}

    def conv(name, dims, fan_in):
        sd[name] = rng.normal(0, np.sqrt(1.0 / fan_in),
                              dims).astype(np.float32)

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.uniform(0.5, 1.5, c)
        sd[prefix + ".bias"] = rng.normal(0, 0.1, c)
        sd[prefix + ".running_mean"] = rng.normal(0, 0.3, c)
        sd[prefix + ".running_var"] = rng.uniform(0.5, 2.0, c)

    i = 0
    while f"voxel_encoder.pfn_{i}.linear.weight" in shape:
        out, cin = shape[f"voxel_encoder.pfn_{i}.linear.weight"]
        conv(f"voxel_encoder.pfn_layers.{i}.linear.weight", (out, cin), cin)
        bn(f"voxel_encoder.pfn_layers.{i}.norm", out)
        i += 1
    i = 0
    mid = "pseudoimage_generator.middle_conv"
    while f"pseudoimage_generator.subm_{i}_kernel" in shape:
        out, cin = shape[f"pseudoimage_generator.subm_{i}_kernel"][:2]
        conv(f"{mid}.{6 * i}.weight", (out, 3, 3, 3, cin), 27 * cin)
        bn(f"{mid}.{6 * i + 1}", out)
        out, cin = shape[f"pseudoimage_generator.down_{i}_kernel"][:2]
        conv(f"{mid}.{6 * i + 3}.weight", (out, 3, 1, 1, cin), 3 * cin)
        bn(f"{mid}.{6 * i + 4}", out)
        i += 1
    k = 0
    while f"sparse_rpn.conv_{k}.weight" in shape:
        out, cin = shape[f"sparse_rpn.conv_{k}.weight"][:2]
        conv(f"sparse_rpn.blocks.{3 * k}.weight", (out, 3, 3, cin), 9 * cin)
        bn(f"sparse_rpn.blocks.{3 * k + 1}", out)
        k += 1
    for name in ("conv_cls", "conv_reg"):
        out, cin = shape[f"bbox_head.{name}.weight"][:2]
        conv(f"bbox_head.{name}.weight", (out, cin, 1, 1), cin)
        sd[f"bbox_head.{name}.bias"] = rng.normal(0, 0.1, out)
    out, cin = shape["bbox_head.conv_dir.weight"][:2]
    for ax in "xyz":
        conv(f"bbox_head.conv_dir_cls_{ax}.weight", (out // 3, cin, 1, 1),
             cin)
        sd[f"bbox_head.conv_dir_cls_{ax}.bias"] = rng.normal(0, 0.1,
                                                             out // 3)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def reference_mlp_state_dict(input_channels=37, seed=0,
                             hidden=(100, 500, 250, 100, 25)):
    """A synthetic state dict of the reference's foreground-filter MLP
    (``hidden1``-``hidden6`` Linear layers, ``bn1``-``bn5`` batch norms)
    in its own names and layouts: what
    ``models/torch_import.load_reference_mlp`` reads.  Weights from
    ``default_rng(seed)`` at a 1 / fan-in variance; batch norms get random
    affines and running statistics."""
    rng = np.random.default_rng(seed)
    sd = {}
    widths = (int(input_channels),) + tuple(hidden) + (1,)
    for i in range(len(widths) - 1):
        cin, out = widths[i], widths[i + 1]
        sd[f"hidden{i + 1}.weight"] = rng.normal(0, np.sqrt(1.0 / cin),
                                                 (out, cin))
        sd[f"hidden{i + 1}.bias"] = rng.normal(0, 0.1, out)
        if i < len(hidden):
            sd[f"bn{i + 1}.weight"] = rng.uniform(0.5, 1.5, out)
            sd[f"bn{i + 1}.bias"] = rng.normal(0, 0.1, out)
            sd[f"bn{i + 1}.running_mean"] = rng.normal(0, 0.3, out)
            sd[f"bn{i + 1}.running_var"] = rng.uniform(0.5, 2.0, out)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}
