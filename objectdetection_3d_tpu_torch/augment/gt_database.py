"""Ground-truth object database for the ObjectSample augmentation.

Port of the JAX package's ``augment/gt_database.py``: crop every GT
object's interior points across the training split into a database file,
from which ``ObjdetAugmentation.ObjectSample`` pastes collision-checked
samples into scenes at train time.

Database file: a pickle of ``{label: [entry, ...]}`` where each entry is
``{"bbox": (9,) float32, "label": int, "name": str,
"points_inside_box": (P_i, C) float32}``, numpy only, the same format as
the JAX package's: a database written by either package loads in the
other.
"""

import pickle

import numpy as np
import torch

from objectdetection_3d_tpu_torch.ops.boxes import points_in_boxes


def crop_gt_objects(points, bboxes, labels, name="", device="cpu"):
    """Per-box interior point crops of one cloud -> list of DB entries
    (the point test runs on ``device``)."""
    points = np.asarray(points, np.float32)
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 9)
    labels = np.asarray(labels).reshape(-1)
    if len(bboxes) == 0:
        return []
    inside = points_in_boxes(
        torch.as_tensor(np.ascontiguousarray(points[:, :3]), device=device),
        torch.as_tensor(bboxes, device=device)).cpu().numpy()
    return [{
        "bbox": bboxes[i],
        "label": int(labels[i]) if i < len(labels) else 0,
        "name": name,
        "points_inside_box": points[inside[:, i]],
    } for i in range(len(bboxes))]


def build_gt_database(split, out_path, min_points=1, log=print,
                      device="cuda"):
    """Crop every GT object of a dataset split into ``out_path``.

    Args:
        split: dataset split with ``__len__``/``get_data``/``get_attr``
            (e.g. ``Forest3D(...).get_split("training")``).
        out_path: destination ``.pkl``.
        min_points: skip objects with fewer interior points.
        device: where the point-in-box tests run: the card unless the
            caller passes ``"cpu"``.
    Returns:
        the database dict.
    """
    db = {}
    for idx in range(len(split)):
        data = split.get_data(idx)
        attr = split.get_attr(idx)
        entries = crop_gt_objects(data["point"], data["bboxes"],
                                  data.get("labels", []),
                                  name=attr.get("name", str(idx)),
                                  device=device)
        kept = 0
        for e in entries:
            if e["points_inside_box"].shape[0] >= min_points:
                db.setdefault(e["label"], []).append(e)
                kept += 1
        log(f"gt_database: {attr.get('name', idx)}: kept {kept}/"
            f"{len(entries)} objects")
    with open(out_path, "wb") as f:
        pickle.dump(db, f, protocol=pickle.HIGHEST_PROTOCOL)
    log(f"gt_database: wrote {sum(len(v) for v in db.values())} objects "
        f"({len(db)} classes) to {out_path}")
    return db


def load_gt_database(path):
    """Read a database pickle (one this program or the JAX package
    wrote: unpickling runs code, so load only such files)."""
    with open(path, "rb") as f:
        return pickle.load(f)
