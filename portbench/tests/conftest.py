"""Shared pieces of the benchmark's tests: a tiny configuration of the
detector and a throwaway checkout root that holds a ``BENCHMARK.json``
and data files for it, so that the harness runs end to end on the CPU.

The card tests (``-m cuda``) decide inside the test whether a card is
present: ``pytest portbench/tests -m cuda`` on the card machine."""

import copy
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def tiny_model():
    """The flagship's structure at a 16 x 16 x 4 grid: one encoder stage,
    a four-conv RPN, 4 anchors a cell, float32."""
    with open(os.path.join(REPO, "portbench", "configs",
                           "flagship.json")) as f:
        model = json.load(f)["model"]
    model = copy.deepcopy(model)
    model.update(
        point_cloud_range=[0.0, 0.0, 0.0, 8.0, 8.0, 4.0],
        voxelize={"max_voxel_points": 8, "voxel_size": [0.5, 0.5, 1.0],
                  "max_voxels": 256},
        voxel_encoder={"in_channels": 4, "feat_channels": [16],
                       "voxel_size": [0.5, 0.5, 1.0]},
        vertical_encoder={"in_channels": 16, "out_channels": [16]},
        backbone={"in_channels": 16, "out_channels": [16, 16],
                  "layer_nums": [1, 1], "layer_strides": [1, 1]})
    model["head"].update(in_channels=16, nms_pre=64, score_thr=0.05,
                         ranges=[[0.0, 0.0, 0.0, 8.0, 8.0, 4.0]],
                         sizes=[[0.6, 0.6, 2.0], [1.0, 1.0, 3.0]],
                         rotations=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.57]])
    model["tpu"].update(max_points_static=10240, max_voxels_static=256,
                        max_gt_static=8, assign_candidates_per_gt=64,
                        max_detections=64, compute_dtype="float32")
    return model


def tiny_fpn_model():
    model = tiny_model()
    model.update(use_dense_backbone=True,
                 backbone={"in_channels": 16, "out_channels": [16, 16],
                           "layer_nums": [1, 1], "layer_strides": [2, 2]},
                 neck={"out_channels": [8, 8], "upsample_strides": [2, 4]})
    model["head"]["in_channels"] = 16
    return model


TRAFFIC = {
    "predict": {"kind": "predict", "generator": "tree_scene",
                "params": {"extent": 8.0, "n_trees": 2, "n_points": 10000},
                "pool": 3},
    "train": {"kind": "train", "generator": "tree_scene",
              "params": {"extent": 8.0, "n_trees": 2, "n_points": 10000},
              "pool": 3,
              "optimizer": {"lr": 1e-3, "betas": [0.95, 0.99],
                            "weight_decay": 0.01, "grad_clip_value": 2.0}},
    "plot": {"kind": "plot", "generator": "large_tree_scene",
             "params": {"extent": 20.0, "n_trees": 3, "n_clutter": 20000},
             "pool": 2,
             "tiled": {"overlap": 1.0, "batch_tiles": 1,
                       "device_crop": True}},
}


def bench_with_unlisted():
    """``BENCHMARK.json`` with the entries of the cells held back from it
    (``portbench/unlisted/<cell>.json``) added, so that the tests drive
    those cells' harness too."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    held = os.path.join(REPO, "portbench", "unlisted")
    for name in sorted(os.listdir(held)):
        with open(os.path.join(held, name)) as f:
            extra = json.load(f)
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += extra[key]
    return bench


def make_root(path, cells, limits=None, extra_metrics=()):
    """A checkout root under ``path`` for the harness: the real
    ``BENCHMARK.json``'s metrics and the real metric readers, with
    ``cells`` {cell name: (model dict, traffic kind)} in place of the real
    cells (and of those held back, whose metrics it also takes).  ``limits`` {cell: {number: limit}} (default: each real cell's
    limits of the same kind)."""
    root = str(path)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "portbench", d), exist_ok=True)
    shutil.copytree(os.path.join(REPO, "portbench", "metrics"),
                    os.path.join(root, "portbench", "metrics"))
    bench = bench_with_unlisted()
    real = {w["name"]: w for w in bench["workloads"]}
    bench["configs"], bench["workloads"] = [], []
    for name, (model, kind) in cells.items():
        cname = name.split(".")[0]
        conf = {"name": cname, "model": model, "lowering_from_program": [],
                "weights": {}, "reduced": []}
        with open(os.path.join(root, "portbench", "configs",
                               cname + ".json"), "w") as f:
            json.dump(conf, f)
        if cname not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(
                {"name": cname, "source": "tests",
                 "file": f"portbench/configs/{cname}.json", "reduced": [],
                 "why": "tests"})
        with open(os.path.join(root, "portbench", "traffic",
                               "t" + kind + ".json"), "w") as f:
            json.dump(TRAFFIC[kind], f)
        bench["workloads"].append({"name": name, "config": cname,
                                   "traffic": "t" + kind, "chips": 1,
                                   "why": "tests"})
        lim = (limits or {}).get(name)
        if lim is None:
            twin = next(w for w in real if real[w]["traffic"] ==
                        {"predict": "clouds40m", "train": "train40m",
                         "plot": "plot160m"}[kind])
            with open(os.path.join(REPO, "portbench", "limits",
                                   twin + ".json")) as f:
                lim = json.load(f)["limits"]
        with open(os.path.join(root, "portbench", "limits",
                               name + ".json"), "w") as f:
            json.dump({"limits": lim}, f)
    kinds = {k: [n for n, (_, kk) in cells.items() if kk == k]
             for k in ("predict", "train", "plot")}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = m["workloads"][0].split(".")[1]
            m["workloads"] = kinds[kind]
    for m in extra_metrics:
        bench["per_layer"].append(m)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def cuda():
    """Skips the test where no card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
