"""The port's GT sampling path against the JAX package's, on the CPU.

* ``points_in_boxes`` (also in chunks) and ``box_collision_test`` on
  tilted boxes: equal masks, but points within 1e-5 m of a face (float32
  projections summed in another order may round across it).
* ``get_semantic_label``, ``surface_normals``, ``get_boxes_normals``:
  labels exact, geometry 1e-5; ``remove_points_in_boxes`` and
  ``sample_class`` with the same numpy generator: the same rows and the
  same picked entries.
* ``build_gt_database``: the same entries as the JAX package's, and a
  database written by either package loads in the other.
* ``ObjectSample`` with the same seed: the same points, boxes and labels,
  from a database written by the JAX package; its database loads once
  under concurrent threads.
* ``python -m objectdetection_3d_tpu_torch.tools.build_gt_database`` on a
  tiny workspace with ``--device cpu``.
"""

import pickle
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from objectdetection_3d_tpu.augment.augmentation import (
    ObjdetAugmentation as JaxAugmentation,
)
from objectdetection_3d_tpu.augment.gt_database import (
    build_gt_database as jax_build_gt_database,
)
from objectdetection_3d_tpu.dataset import Forest3D as JaxForest3D
from objectdetection_3d_tpu.ops import boxes as jax_boxes
from objectdetection_3d_tpu.ops import sampling as jax_sampling
from objectdetection_3d_tpu_torch.augment import augmentation, gt_database
from objectdetection_3d_tpu_torch.augment.augmentation import (
    ObjdetAugmentation,
)
from objectdetection_3d_tpu_torch.dataset import Forest3D
from objectdetection_3d_tpu_torch.ops import boxes, sampling
from test_dataset import write_cloud

torch.set_num_threads(1)


def _tilted(seed, n_boxes=6, n_points=3000):
    rng = np.random.default_rng(seed)
    bx = np.concatenate([rng.uniform(0, 8, (n_boxes, 2)),
                         rng.uniform(0, 1, (n_boxes, 1)),
                         rng.uniform(0.5, 2.0, (n_boxes, 3)),
                         rng.uniform(-0.3, 0.3, (n_boxes, 2)),
                         rng.uniform(-3, 3, (n_boxes, 1))], 1)
    pts = rng.uniform([0, 0, 0, 0], [8, 8, 3, 1], (n_points, 4))
    return pts.astype(np.float32), bx.astype(np.float32)


def _face_gap(points, bx):
    """(P, N) float64 distance of each point to the nearest face plane of
    each box, along that box's axes."""
    t = torch.as_tensor(bx, dtype=torch.float64)
    rot, mid = boxes.box_axes(t)
    d = torch.as_tensor(points[:, :3], dtype=torch.float64)[:, None] - mid
    proj = torch.einsum("pnk,nkj->pnj", d, rot)
    return ((proj.abs() * 2 - t[None, :, 3:6]).abs().amin(-1) / 2).numpy()


@pytest.mark.parametrize("chunk", [None, 500])
def test_points_in_boxes_matches_jax(monkeypatch, chunk):
    pts, bx = _tilted(0)
    if chunk:   # several chunks of points
        monkeypatch.setattr(boxes, "POINTS_IN_BOXES_PAIRS", chunk)
    got = boxes.points_in_boxes(torch.as_tensor(pts),
                                torch.as_tensor(bx)).numpy()
    want = np.asarray(jax_boxes.points_in_boxes(jnp.asarray(pts),
                                                jnp.asarray(bx)))
    near = _face_gap(pts, bx) < 1e-5
    assert got.shape == want.shape == (len(pts), len(bx))
    assert np.array_equal(got[~near], want[~near])
    assert 50 < got.sum() < got.size
    assert boxes.points_in_boxes(torch.zeros((0, 3)),
                                 torch.as_tensor(bx)).shape == (0, len(bx))


def test_box_collision_test_matches_jax():
    _, bx = _tilted(1, n_boxes=20)
    q = bx[::-1].copy()
    q[:, :2] += 0.5
    got = boxes.box_collision_test(torch.as_tensor(bx),
                                   torch.as_tensor(q)).numpy()
    want = np.asarray(jax_boxes.box_collision_test(jnp.asarray(bx),
                                                   jnp.asarray(q)))
    assert np.array_equal(got, want) and got.any() and not got.all()


def test_labels_and_normals_match_jax():
    pts, bx = _tilted(2)
    got = sampling.get_semantic_label(torch.as_tensor(pts[:, :3]),
                                      torch.as_tensor(bx), 0.2, 0.8)
    want = jax_sampling.get_semantic_label(pts[:, :3], bx, 0.2, 0.8)
    near = (_face_gap(pts, bx) < 1e-5).any(1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[~near], np.asarray(want)[~near])
    assert set(np.unique(got.numpy())) == {-1, 0, 1}
    corners = boxes.box_corners_3d(torch.as_tensor(bx))
    jc = jax_boxes.box_corners_3d(jnp.asarray(bx))
    for g, w in zip(sampling.surface_normals(corners),
                    jax_sampling.surface_normals(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(
        sampling.get_boxes_normals(torch.as_tensor(bx)).numpy(),
        np.asarray(jax_sampling.get_boxes_normals(bx)), atol=1e-5)


def test_remove_points_and_sample_class_match_jax():
    pts, bx = _tilted(3)
    got = sampling.remove_points_in_boxes(pts, bx)
    want = jax_sampling.remove_points_in_boxes(pts, bx)
    assert np.array_equal(got, want) and 0 < len(got) < len(pts)

    db = [{"bbox": b, "label": 0,
           "points_inside_box": np.zeros((5, 4), np.float32)}
          for b in _tilted(4, n_boxes=30)[1]]
    gt = list(bx[:3])
    for seed in (0, 1, 2):
        got = sampling.sample_class(12, gt, db,
                                    rng=np.random.default_rng(seed))
        want = jax_sampling.sample_class(12, gt, db,
                                         rng=np.random.default_rng(seed))
        assert [e["bbox"].tolist() for e in got] == \
            [e["bbox"].tolist() for e in want]
        assert 0 < len(got) < 12
    assert sampling.sample_class(0, gt, db) == []
    kept = sampling.filter_by_min_points(
        db[:2] + [{"label": 1, "points_inside_box": np.zeros((1, 4))}],
        {0: 4})
    assert len(kept) == 3 and jax_sampling.filter_by_min_points(
        db[:2], {0: 5}) == sampling.filter_by_min_points(db[:2], {0: 5})


@pytest.fixture
def forest(tmp_path):
    for split in ("training", "validation", "testing"):
        d = tmp_path / "data" / split
        d.mkdir(parents=True)
        for i in range(3):
            write_cloud(d, f"{split}_{i}", n_points=800, n_boxes=3,
                        seed=10 * i + len(split))
    return tmp_path


def _entries_equal(a, b):
    assert sorted(a) == sorted(b)
    for label in a:
        assert len(a[label]) == len(b[label])
        for x, y in zip(a[label], b[label]):
            assert x["label"] == y["label"] and x["name"] == y["name"]
            np.testing.assert_array_equal(x["bbox"], y["bbox"])
            np.testing.assert_array_equal(x["points_inside_box"],
                                          y["points_inside_box"])


def test_build_gt_database_matches_jax_and_loads_across(forest):
    data = str(forest / "data")
    ours = str(forest / "port.pkl")
    theirs = str(forest / "jax.pkl")
    db = gt_database.build_gt_database(
        Forest3D(data, name="synthetic", seed=0).get_split("training"),
        ours, min_points=1, log=lambda *a: None, device="cpu")
    want = jax_build_gt_database(
        JaxForest3D(data, name="synthetic", seed=0).get_split("training"),
        theirs, min_points=1, log=lambda *a: None)
    _entries_equal(db, want)
    assert sum(len(v) for v in db.values()) >= 3
    _entries_equal(gt_database.load_gt_database(theirs), want)
    with open(ours, "rb") as f:
        _entries_equal(pickle.load(f), want)


def _scene(seed=3):
    rng = np.random.default_rng(seed)
    pts = np.zeros((600, 4), np.float32)
    pts[:, :2] = rng.uniform(0, 8, (600, 2)) + 100.0
    pts[:, 2] = rng.uniform(0, 3, 600) + 100.0
    bx = np.array([[104.0, 104.0, 100.0, 0.8, 0.8, 2.0, 0, 0, 0.3]],
                  np.float32)
    return {"point": pts, "bboxes": bx, "labels": np.zeros(1, np.int64)}


def test_object_sample_matches_jax(forest):
    db_path = str(forest / "jax.pkl")
    jax_build_gt_database(JaxForest3D(str(forest / "data"), name="s",
                                      seed=0).get_split("training"),
                          db_path, min_points=1, log=lambda *a: None)
    for target, seed in ((5, 11), (8, 4), (1, 1)):
        cfg = {"ObjectSample": {"db_path": db_path,
                                "sample_dict": {0: target}}}
        got = ObjdetAugmentation(cfg, seed=0).augment(_scene(), {},
                                                      seed=seed)
        want = JaxAugmentation(cfg, seed=0).augment(_scene(), {}, seed=seed)
        for key in ("point", "bboxes", "labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert len(got["bboxes"]) <= max(target, 1)
    # with a candidate filter; the pasted boxes collide with nothing, and
    # each holds points
    cfg = {"ObjectSample": {"db_path": db_path, "sample_dict": {0: 5},
                            "min_points_dict": {0: 3}}}
    got = ObjdetAugmentation(cfg, seed=0).augment(_scene(), {}, seed=11)
    want = JaxAugmentation(cfg, seed=0).augment(_scene(), {}, seed=11)
    np.testing.assert_array_equal(got["point"], want["point"])
    bx = torch.as_tensor(got["bboxes"])
    assert len(bx) > 1
    coll = boxes.box_collision_test(bx, bx).numpy()
    np.fill_diagonal(coll, False)
    assert not coll[1:].any()
    inside = boxes.points_in_boxes(torch.as_tensor(got["point"][:, :3]), bx)
    assert bool((inside.sum(0)[1:] > 0).all())


def test_object_sample_loads_its_database_once_across_threads(forest,
                                                              monkeypatch):
    db_path = str(forest / "db.pkl")
    gt_database.build_gt_database(
        Forest3D(str(forest / "data"), name="s",
                 seed=0).get_split("training"),
        db_path, min_points=1, log=lambda *a: None, device="cpu")
    loads = []
    real = augmentation.load_gt_database

    def counting(path):
        loads.append(path)
        return real(path)

    monkeypatch.setattr(augmentation, "load_gt_database", counting)
    aug = ObjdetAugmentation({"ObjectSample": {
        "db_path": db_path, "sample_dict": {0: 4}}}, seed=0)
    outs, errors = [None] * 16, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            try:
                outs[i] = aug.augment(_scene(), {}, seed=i % 4)
            except Exception as e:   # recorded, re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(loads) == 1
    for i in range(4, 16):   # per-item RNG: same seed, same scene
        np.testing.assert_array_equal(outs[i]["point"], outs[i % 4]["point"])


def test_build_gt_database_module_runs_on_the_cpu(forest):
    cfg = {"dataset": {"name": "synthetic",
                       "dataset_path": str(forest / "data") + "/",
                       "gt_db_min_points": 1, "seed": 0}}
    cfg_path = forest / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = forest / "out.pkl"
    r = subprocess.run(
        [sys.executable, "-m",
         "objectdetection_3d_tpu_torch.tools.build_gt_database",
         str(cfg_path), str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    db = gt_database.load_gt_database(str(out))
    assert sum(len(v) for v in db.values()) >= 3
    want = jax_build_gt_database(
        JaxForest3D(str(forest / "data"), name="s",
                    seed=0).get_split("training"),
        str(forest / "jax.pkl"), min_points=1, log=lambda *a: None)
    _entries_equal(db, want)
