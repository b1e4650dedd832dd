"""Host-side train-time augmentation.

The port's copy of the JAX package's ``augment/augmentation.py``: a table
of pure transforms, each taking (rng, array, cfg), which the augmentor
composes in a fixed order (recenter, normalize, rotate, scale,
ObjectSample, ObjectRangeFilter, PointShuffle).  The same seed gives the
same arrays as the JAX package.  ``ObjectSample`` pastes objects of a GT
database (``augment/gt_database.py``); its box tests run on the device the
augmentor is given.
"""

import threading
import warnings

import numpy as np
import torch

from objectdetection_3d_tpu_torch.augment import numpy_ops as npo
from objectdetection_3d_tpu_torch.augment.gt_database import load_gt_database
from objectdetection_3d_tpu_torch.ops import sampling

#: every method name the config may give; anything else warns
KNOWN_METHODS = (
    "recenter", "normalize", "rotate", "scale", "noise", "PointShuffle",
    "ObjectRangeFilter", "ObjectSample",
)

# --------------------------------------------------------------------------
# primitive transforms (pure: rng in, arrays out)
# --------------------------------------------------------------------------
def recenter(rng, pc, cfg):
    """Shift the configured dims ('dim', default xyz) to zero mean."""
    if not cfg:
        return pc
    dims = cfg.get("dim", [0, 1, 2]) if isinstance(cfg, dict) else [0, 1, 2]
    out = pc.copy()
    out[:, dims] -= pc.mean(0)[dims]
    return out


def normalize(rng, pc, feat, cfg):
    """Points to zero-mean/unit-extent; features by bias/scale."""
    pcfg = cfg.get("points")
    if pcfg is not None:
        if pcfg.get("method", "linear") != "linear":
            raise ValueError(f"Unsupported method : {pcfg.get('method')}")
        pc = pc - pc.mean(0)
        pc = pc / (pc.max(0) - pc.min(0)).max()
    fcfg = cfg.get("feat")
    if fcfg is not None and feat is not None:
        if fcfg.get("method", "linear") != "linear":
            raise ValueError(f"Unsupported method : {fcfg.get('method')}")
        feat = (feat - fcfg.get("bias", 0)) / fcfg.get("scale", 1)
    return pc, feat


def _yaw_matrix(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _uniform_so3_matrix(rng):
    """Random axis from spherical angles + random rotation angle."""
    theta = rng.random() * 2 * np.pi
    phi = (rng.random() - 0.5) * np.pi
    axis = np.array([np.cos(theta) * np.cos(phi),
                     np.sin(theta) * np.cos(phi),
                     np.sin(phi)])
    alpha = rng.random() * 2 * np.pi
    return npo.create_3D_rotations(axis.reshape(1, -1),
                                   np.reshape(alpha, (1,)))[0]


def rotate(rng, pc, cfg):
    """'vertical' = random yaw, 'all' = uniform SO(3)."""
    if np.abs(pc[:, :2].mean()) > 1e-2:
        warnings.warn("It is recommended to recenter the pointcloud before "
                      "calling rotate.")
    method = cfg.get("method", "vertical")
    if method == "vertical":
        mat = _yaw_matrix(rng.random() * 2 * np.pi)
    elif method == "all":
        mat = _uniform_so3_matrix(rng)
    else:
        raise ValueError(f"Unsupported method : {method}")
    return pc @ mat.astype(np.float32)


def scale(rng, pc, cfg):
    """Uniform random scale in [min_s, max_s); per-column if anisotropic."""
    lo, hi = cfg.get("min_s", 1.0), cfg.get("max_s", 1.0)
    draw = rng.random(pc.shape[1]) if cfg.get("scale_anisotropic") \
        else rng.random()
    return pc * (draw * (hi - lo) + lo)


def noise(rng, pc, cfg):
    std = cfg.get("noise_std", 0.001)
    return pc + (rng.standard_normal(pc.shape) * std).astype(np.float32)


def box_in_range(corners, pcd_range):
    """True iff all 8 corners lie strictly inside the xyz range."""
    lo_ok = (corners.min(0) > pcd_range[:3]).all()
    hi_ok = (corners.max(0) < pcd_range[3:]).all()
    return bool(lo_ok and hi_ok)


# --------------------------------------------------------------------------
# augmentors
# --------------------------------------------------------------------------
class Augmentation:
    """RNG owner exposing the primitive transforms as bound methods."""

    def __init__(self, cfg, seed=None):
        self.cfg = cfg or {}
        self.rng = np.random.default_rng(seed)

    def recenter(self, data, cfg):
        return recenter(self.rng, data, cfg)

    def normalize(self, pc, feat, cfg):
        return normalize(self.rng, pc, feat, cfg)

    def rotate(self, pc, cfg):
        return rotate(self.rng, pc, cfg)

    def scale(self, pc, cfg):
        return scale(self.rng, pc, cfg)

    def noise(self, pc, cfg):
        return noise(self.rng, pc, cfg)

    def augment(self, data):
        raise NotImplementedError("Please use ObjdetAugmentation.")


class ObjdetAugmentation(Augmentation):
    """Detection augmentor: applies the configured transforms in a fixed
    order (recenter, normalize, rotate, scale, ObjectSample,
    ObjectRangeFilter, PointShuffle).

    ``device``: where ``ObjectSample``'s point and collision tests run.
    One augmentor serves all the loader's threads: the GT database loads
    once, under a lock, and the per-item RNG is passed down, never stored.
    """

    def __init__(self, cfg, seed=None, device="cpu"):
        super().__init__(cfg, seed=seed)
        self.device = torch.device(device)
        self._db_lock = threading.Lock()
        self._gt_db = None
        for name in (cfg or {}):
            if name not in KNOWN_METHODS:
                warnings.warn(f"Augmentation method : {name} does not "
                              "exist. Please verify!")

    def PointShuffle(self, data, rng=None):
        data["point"] = npo.point_shuffle(
            data["point"], rng if rng is not None else self.rng)
        return data

    def _database(self, path):
        if self._gt_db is None:
            with self._db_lock:
                if self._gt_db is None:
                    self._gt_db = load_gt_database(path)
        return self._gt_db

    def ObjectSample(self, data, cfg, rng=None):
        """Paste collision-checked GT-database objects into the scene.

        ``cfg`` keys:

        * ``db_path``: GT database pickle (``augment.gt_database`` /
          ``python -m objectdetection_3d_tpu_torch.tools.build_gt_database``).
        * ``sample_dict``: {class_label: target object count per scene};
          up to ``target - current`` objects are added.
        * ``min_points_dict`` (optional): {label: min interior points}
          filter on database candidates.
        * ``remove_points`` (default True): drop scene points falling
          inside a pasted box before pasting its crop.
        """
        rng = rng if rng is not None else self.rng
        db = self._database(cfg["db_path"])

        points = np.asarray(data["point"], np.float32)
        boxes = np.asarray(data["bboxes"], np.float32).reshape(-1, 9)
        labels = np.asarray(data["labels"]).reshape(-1)

        min_pts = dict(cfg.get("min_points_dict", {}) or {})
        new_entries = []
        scene_boxes = [b for b in boxes]
        for label, target in dict(cfg["sample_dict"]).items():
            have = int((labels == label).sum()) + sum(
                1 for e in new_entries if e["label"] == label)
            want = int(target) - have
            candidates = db.get(label, [])
            if min_pts:
                candidates = sampling.filter_by_min_points(candidates,
                                                           min_pts)
            if want <= 0 or not candidates:
                continue
            picked = sampling.sample_class(want, scene_boxes, candidates,
                                           rng=rng, device=self.device)
            new_entries.extend(picked)
            scene_boxes.extend(np.asarray(e["bbox"], np.float32)
                               for e in picked)

        if not new_entries:
            return data

        new_boxes = np.stack([e["bbox"] for e in new_entries]).astype(
            np.float32)
        if cfg.get("remove_points", True):
            points = sampling.remove_points_in_boxes(points, new_boxes,
                                                     device=self.device)
        crops = [np.asarray(e["points_inside_box"],
                            np.float32)[:, :points.shape[1]]
                 for e in new_entries]
        data["point"] = np.concatenate([points] + crops, axis=0)
        data["bboxes"] = np.concatenate([boxes, new_boxes], axis=0)
        data["labels"] = np.concatenate(
            [labels, np.array([e["label"] for e in new_entries],
                              labels.dtype if labels.size else np.int64)])
        return data

    @staticmethod
    def in_range(pcd_range, corners):
        return box_in_range(corners, np.asarray(pcd_range))

    def ObjectRangeFilter(self, data, pcd_range):
        """Drop GT boxes whose rotated corners leave the scene range."""
        pcd_range = np.asarray(pcd_range)
        kept = [b for b in data["bboxes"]
                if box_in_range(npo.bbox2corners3D_np(b), pcd_range)]
        boxes = (np.array(kept).reshape(-1, 9) if kept
                 else np.zeros((0, 9), np.float32))
        return {"point": data["point"], "labels": data["labels"],
                "bboxes": boxes}

    def augment(self, data, attr, seed=None):
        cfg = self.cfg
        if cfg is None:
            return data
        # Per-item RNG flows down as a local — NEVER assigned to self.rng:
        # a single augmentor is shared by all DataLoader worker threads,
        # and mutating shared state would race, breaking the loader's
        # worker-count-invariant determinism.
        rng = np.random.default_rng(seed) if seed is not None else self.rng

        if cfg.get("recenter"):
            data["point"] = recenter(rng, data["point"], cfg["recenter"])
        if "normalize" in cfg:
            data["point"], _ = normalize(rng, data["point"], None,
                                         cfg["normalize"])
        if "rotate" in cfg:
            data["point"] = rotate(rng, data["point"], cfg["rotate"])
        if "scale" in cfg:
            data["point"] = scale(rng, data["point"], cfg["scale"])
        if cfg.get("ObjectSample", False):
            data = self.ObjectSample(data, cfg["ObjectSample"], rng=rng)
        if cfg.get("ObjectRangeFilter", False):
            data = self.ObjectRangeFilter(
                data, cfg["ObjectRangeFilter"]["point_cloud_range"])
        if cfg.get("PointShuffle", False):
            data = self.PointShuffle(data, rng=rng)
        return data
