"""Offline data preparation: raw cloud -> training-ready ``.npy``.

    python -m objectdetection_3d_tpu_torch.tools.prepare_data \
        <config.yaml> <input> <output.npy> [--device cpu]

``input`` is a raw ``.npy`` cloud ``(N, >=4)`` = x, y, z, reflectance
(or an ``.rdbx`` file where the vendor ``riegl.rdb`` package is
installed).  The config's ``model.preprocess`` section sets the steps:
featurize (normals + FPFH) -> foreground filter -> density downsample.
The filter runs only where its checkpoint exists, its MLP on the card
unless ``--device cpu`` is given.  A sibling ``<input>_bbx.npy`` is copied
through untouched.
"""

import argparse
import os
import shutil
import sys

import numpy as np

from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.models.preprocess_tools import (
    CustomVoxelizer,
    Featurizer,
    ForegroundFilter,
)


def prepare_cloud(points, preprocess_cfg, log=print, device="cuda"):
    """Run the offline chain on one raw (N, C) cloud.

    Returns the training-ready cloud: the original feature columns of the
    surviving points, density-downsampled.  The filter is skipped (and
    says why) when its checkpoint is missing; an invalid filter config
    raises (the JAX package skips the filter then too).
    """
    n_cols = points.shape[1]

    feat_cfg = dict(preprocess_cfg.get("featurizer", {}) or {})
    filt_cfg = dict(preprocess_cfg.get("filter", {}) or {})
    vox_cfg = dict(preprocess_cfg.get("voxelization", {}) or {})

    if feat_cfg and filt_cfg:
        try:
            filt = ForegroundFilter(filt_cfg, device=device)
        except FileNotFoundError as e:
            log(f"prepare_data: foreground filter skipped ({e})")
            filt = None
        if filt is not None:
            feats = Featurizer(**feat_cfg).generate_features(points)
            mask = filt.evaluate(feats).astype(bool)
            log(f"prepare_data: foreground filter kept "
                f"{int(mask.sum())}/{len(points)} points")
            points = points[mask]

    if vox_cfg:
        before = len(points)
        points = CustomVoxelizer(**vox_cfg).voxelize(points)
        # the voxelizer appends a count column when it downsamples; the
        # dataset contract keeps the original feature columns
        points = points[:, :n_cols]
        if len(points) != before:
            log(f"prepare_data: density downsample {before} -> "
                f"{len(points)} points")
    return np.ascontiguousarray(points, np.float32)


def _load(path):
    if path.endswith(".rdbx"):
        from objectdetection_3d_tpu_torch.dataset.rdb_tools import RDB_import

        pts, _geo = RDB_import(
            path, ["riegl.xyz", "riegl.reflectance"], "",
            100_000).get_features()
        return np.asarray(pts, np.float32)
    return np.load(path).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m objectdetection_3d_tpu_torch.tools.prepare_data",
        description="Featurize, filter and downsample a raw cloud into a "
                    "training .npy.")
    parser.add_argument("config")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = Config.load_from_file(args.config)

    points = _load(args.input)
    out = prepare_cloud(points, dict(cfg.model.get("preprocess", {})),
                        device=args.device)
    np.save(args.output, out)
    print(f"prepare_data: wrote {out.shape} to {args.output}")

    bbx = args.input.rsplit(".", 1)[0] + "_bbx.npy"
    if os.path.exists(bbx):
        shutil.copy(bbx, args.output.rsplit(".", 1)[0] + "_bbx.npy")
        print("prepare_data: copied GT boxes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
