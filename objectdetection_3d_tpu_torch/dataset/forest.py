"""Forest LiDAR dataset: the ``.npy`` pairs on disk.

Point clouds are ``<name>.npy`` float arrays ``(N, >=4)`` with columns
``x, y, z, reflectance, ...``; boxes live in a sibling ``<name>_bbx.npy``
``(M, 9)`` with z at the box *center* and angles in degrees on disk.
Loading converts z to the bottom, degrees to radians, and shifts cloud and
boxes so the cloud minimum corner sits at the origin.  The port's copy of
the JAX package's ``dataset/forest.py``.
"""

import glob
import logging
from pathlib import Path

import numpy as np

from objectdetection_3d_tpu_torch.dataset.base import (
    BaseDataset,
    BaseDatasetSplit,
)

log = logging.getLogger(__name__)


class ForestSplit(BaseDatasetSplit):
    """One split of the forest dataset."""

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info("Found %d pointclouds for %s", len(self.path_list), split)
        self.selected_features = self.cfg.get("input_features", None)

    def __len__(self):
        return len(self.path_list)

    def read_lidar(self, path):
        return np.load(path)

    @staticmethod
    def _boxes_from_disk(bbox_path):
        """Load ``<name>_bbx.npy`` and apply the disk-convention fixups:
        z center -> bottom, degrees -> radians."""
        boxes = np.load(bbox_path).astype(np.float64).reshape(-1, 9)
        boxes[:, 2] -= boxes[:, 5] / 2
        boxes[:, 6:] = np.deg2rad(boxes[:, 6:])
        return boxes

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        points = self.read_lidar(pc_path).astype(np.float32)
        boxes = self._boxes_from_disk(pc_path.rsplit(".", 1)[0] + "_bbx.npy")

        # shift cloud + boxes so the cloud min corner sits at the origin
        shift = points[:, :3].min(axis=0)
        points[:, :3] -= shift
        boxes[:, :3] -= shift

        outside = (boxes[:, 0] < 0) | (boxes[:, 1] < 0)
        if outside.any():
            log.warning("Boxes out of scene %s", boxes[outside])

        return {"point": points,
                "labels": np.zeros(boxes.shape[0]),
                "bboxes": boxes.astype(np.float32)}

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        name = pc_path.name.replace(".npy", "")
        return {"name": name, "path": str(pc_path), "split": self.split}


class Forest3D(BaseDataset):
    """Forest dataset rooted at ``dataset_path`` with ``training/``,
    ``validation/`` and ``testing/`` subdirectories of ``.npy`` pairs."""

    def __init__(self, dataset_path, **kwargs):
        super().__init__(dataset_path=dataset_path, **kwargs)
        cfg = self.cfg
        self.dataset_path = cfg.dataset_path

        self.train_dir = str(Path(cfg.dataset_path) / "training")
        self.val_dir = str(Path(cfg.dataset_path) / "validation")
        self.test_dir = str(Path(cfg.dataset_path) / "testing")

        self.train_files = sorted(
            f for f in glob.glob(self.train_dir + "/*.npy") if "bbx" not in f)
        self.val_files = sorted(
            f for f in glob.glob(self.val_dir + "/*.npy") if "bbx" not in f)
        self.test_files = sorted(
            f for f in glob.glob(self.test_dir + "/*.npy") if "bbx" not in f)

    @staticmethod
    def get_label_to_names():
        return {0: "Tree"}

    def get_split(self, split):
        return ForestSplit(self, split=split)

    def get_split_list(self, split):
        """Shuffled file list for a split (shuffled anew on every
        access)."""
        if split in ("test", "testing"):
            self.rng.shuffle(self.test_files)
            return list(self.test_files)
        if split in ("val", "validation"):
            self.rng.shuffle(self.val_files)
            return list(self.val_files)
        if split in ("train", "training"):
            self.rng.shuffle(self.train_files)
            return list(self.train_files)
        raise ValueError("Invalid split {}".format(split))
