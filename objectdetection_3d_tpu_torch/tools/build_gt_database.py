"""Build the GT object database for the ObjectSample augmentation.

    python -m objectdetection_3d_tpu_torch.tools.build_gt_database \
        [config.yaml] [out.pkl] [--device cpu]

Reads the dataset section of the pipeline config, crops every training
GT object's interior points (those with at least
``dataset.gt_db_min_points``, default 5), and writes the database pickle
that ``augment: {ObjectSample: {db_path: ...}}`` reads.  The point tests
run on the card unless ``--device cpu`` is given.
"""

import argparse
import sys

from objectdetection_3d_tpu_torch.augment.gt_database import (
    build_gt_database,
)
from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.dataset import Forest3D
from objectdetection_3d_tpu_torch.models.detector import resolve_device


def build(cfg, out_path, device="cuda", log=print):
    """The database of the training split of ``cfg``'s dataset section
    (a ``Config``), written to ``out_path``; returns the database."""
    split = Forest3D(**cfg.dataset).get_split("training")
    min_points = int(cfg.dataset.get("gt_db_min_points", 5))
    return build_gt_database(split, out_path, min_points=min_points,
                             log=log, device=resolve_device(device))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m objectdetection_3d_tpu_torch.tools."
             "build_gt_database",
        description="Crop every training GT object into a database "
                    "pickle.")
    parser.add_argument("config", nargs="?", default="config.yaml")
    parser.add_argument("out", nargs="?", default="gt_database.pkl")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    build(Config.load_from_file(args.config), args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
