"""The port's tiled large-scene inference against the JAX package's
(``pipeline/tiled_inference.py``), on the CPU at the tiny config.

* ``scene.large_tree_scene`` is ``bench._tree_scene``, bit for bit;
* ``_tile_origins`` equals the JAX package's on a grid of scenes;
* the host crop hands predict exactly the JAX package's point buffers;
* the device crop delivers each tile's numpy in-window set (a multiset:
  the shuffle reorders rows), and exactly the point budget of in-window
  rows on an over-budget tile; its run bounds from ``searchsorted`` equal
  the JAX package's masked counts;
* the whole path on the 16 x 8 m scene of the JAX package's tests
  (trained tiny weights, shared through ``weights.from_jax_variables``):
  the port's host path equals the JAX package's (count and labels exact,
  boxes atol 1e-4, scores atol 1e-5), and the port's device path, at
  ``batch_tiles`` 1 and 2, its host path (boxes atol 1e-3);
* the merge: duplicates suppressed, truncation keeps the top scores, and
  ``_merge_host`` equals the JAX package's on the same candidates.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.pipeline.tiled_inference import (
    TiledInference as JaxTiledInference,
)
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.weights import from_jax_variables
from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
    TiledInference,
)
from objectdetection_3d_tpu_torch.scene import large_tree_scene
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    """The tiny JAX model overfit on one batch (as the JAX package's
    tiled tests do), and the port's model with the same weights."""
    model = JaxPointPillars(**tiny_model_cfg())
    variables = model.init_variables(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(
        batch_size=2, seed=7).items()}
    tx = model.get_optimizer(dict(lr=3e-3, betas=[0.95, 0.99],
                                  weight_decay=0.01), grad_clip_value=2.0)
    step = model.make_train_step(tx, donate=False)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"])}
    for _ in range(60):
        state, _ = step(state, batch)
    variables = {"params": state["params"],
                 "batch_stats": state["batch_stats"]}
    port = PointPillars(tiny_model_cfg(), device="cpu")
    from_jax_variables(port.net, jax.tree.map(np.asarray, variables))
    return model, variables, port, batch


def _two_tree_scene(batch):
    """The 16 x 8 m scene of the JAX package's tests: the training cloud
    and a copy shifted by 8 m, offset to (30, 10, 5)."""
    pts = np.asarray(batch["points"][0][: int(batch["num_points"][0])])
    shifted = pts.copy()
    shifted[:, 0] += 8.0
    return np.concatenate([pts, shifted]) + [30.0, 10.0, 5.0, 0.0]


def _uniform_scene(seed, n, hi):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.uniform([0, 0, 0], hi, (n, 3)), rng.uniform(0, 1, (n, 1))],
        axis=1).astype(np.float32)


def _recorder(into):
    """A stub predict that records each batch and detects nothing."""
    def predict(batch):
        into.append((np.asarray(batch["points"]),
                     np.asarray(batch["num_points"])))
        b = batch["points"].shape[0]
        return {"bbox": torch.zeros((b, 4, 9)),
                "score": torch.zeros((b, 4)),
                "label": torch.zeros((b, 4), dtype=torch.int32),
                "valid": torch.zeros((b, 4), dtype=torch.bool)}
    return predict


def _tiles(ti, scene):
    lo = scene[:, :3].min(0)
    xs = ti._tile_origins(lo[0], scene[:, 0].max(), ti.tile_x, ti.overlap)
    ys = ti._tile_origins(lo[1], scene[:, 1].max(), ti.tile_y, ti.overlap)
    return lo, [(x0, y0) for x0 in xs for y0 in ys]


def _in_window(scene, pcr, shift):
    sel = np.all((scene[:, :3] >= pcr[:3] + shift)
                 & (scene[:, :3] < pcr[3:] + shift), axis=1)
    want = scene[sel].copy()
    want[:, :3] -= shift
    return want


def _rows(a):
    """The rows of ``a`` rounded to 1e-4, lexicographically sorted."""
    a = np.round(a, 4)
    return a[np.lexsort(a.T[::-1])]


def _same_detections(a, b, atol_box, atol_score=None):
    assert len(a) == len(b) > 0

    def key(d):
        return (d["label"], round(float(d["bbox"][0]), 2),
                round(float(d["bbox"][1]), 2))

    for x, y in zip(sorted(a, key=key), sorted(b, key=key)):
        assert x["label"] == y["label"]
        np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=0,
                                   atol=atol_box)
        if atol_score is not None:
            assert abs(x["score"] - y["score"]) <= atol_score


def _bench_tree_scene():
    """``bench._tree_scene``, compiled alone from bench.py's source with
    numpy as its only global: importing ``bench`` would run its top level,
    which repoints JAX's compilation cache for every later test."""
    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "_tree_scene")
    namespace = {"np": np}
    exec(compile(ast.Module([fn], type_ignores=[]), str(path), "exec"),
         namespace)
    return namespace["_tree_scene"]


def test_large_tree_scene_is_the_bench_scene():
    tree_scene = _bench_tree_scene()
    np.testing.assert_array_equal(large_tree_scene(), tree_scene())
    small = dict(extent=50.0, n_trees=3, n_noise=1000, seed=4)
    np.testing.assert_array_equal(large_tree_scene(**small),
                                  tree_scene(**small))


@pytest.mark.parametrize("lo,hi,tile,overlap", [
    (0.0, 20.0, 8.0, 2.0), (0.0, 5.0, 8.0, 2.0),
    (np.float32(-3.7), np.float32(151.9), 40.0, 5.0),
    (np.float32(0.01), np.float32(159.99), 40.0, 5.0),
    (2.5, 17.25, 8.0, 6.0), (0.0, 8.0, 8.0, 0.0)])
def test_tile_origins_match_jax(trained, lo, hi, tile, overlap):
    jm, jv, port, _ = trained
    got = TiledInference(port, overlap=overlap)._tile_origins(
        lo, hi, tile, overlap)
    want = JaxTiledInference(jm, jv, overlap=overlap)._tile_origins(
        lo, hi, tile, overlap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_tiles", [1, 2])
def test_host_crop_buffers_match_jax(trained, batch_tiles):
    """``device_crop=False``: every batch handed to predict equals the
    JAX package's, padded chunk tails included."""
    jm, jv, port, _ = trained
    scene = _uniform_scene(0, 12000, [20, 14, 3])  # over budget per tile
    got, want = [], []
    TiledInference(port, overlap=2.0, batch_tiles=batch_tiles,
                   predict_fn=_recorder(got), device_crop=False,
                   max_merge_boxes=64)(scene)

    def jax_stub(variables, batch):
        want.append((np.asarray(batch["points"]),
                     np.asarray(batch["num_points"])))
        b = batch["points"].shape[0]
        return {"bbox": jnp.zeros((b, 4, 9)), "score": jnp.zeros((b, 4)),
                "label": jnp.zeros((b, 4), jnp.int32),
                "valid": jnp.zeros((b, 4), bool)}

    JaxTiledInference(jm, jv, overlap=2.0, batch_tiles=batch_tiles,
                      predict_fn=jax_stub, device_crop=False,
                      max_merge_boxes=64)(scene)
    assert len(got) == len(want) >= 3
    assert max(int(n.max()) for _, n in got) == port.tpu_cfg[
        "max_points_static"]
    for (gp, gn), (wp, wn) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gp, wp)


def test_device_crop_matches_numpy_filter(trained):
    """Per tile, the device crop's in-range rows are exactly the numpy
    in-window set in local coordinates; every other delivered row is
    out of the model's range (the voxelizer drops it)."""
    _, _, port, _ = trained
    recorded = []
    # below every run budget: the exact multiset compare holds
    scene = _uniform_scene(3, 1800, [20, 14, 3])
    ti = TiledInference(port, overlap=2.0, predict_fn=_recorder(recorded),
                        max_merge_boxes=64)
    assert ti(scene) == []
    pcr = np.asarray(port.point_cloud_range, np.float32)
    lo, tiles = _tiles(ti, scene)
    assert len(tiles) >= 4 and len(recorded) == len(tiles)
    for (x0, y0), (pts, num) in zip(tiles, recorded):
        body = pts[0, :int(num[0])]
        assert int(num[0]) == ti.max_pts
        inw = np.all((body[:, :3] >= pcr[:3]) & (body[:, :3] < pcr[3:]),
                     axis=1)
        want = _in_window(scene, pcr, np.array([x0, y0, lo[2]], np.float32))
        np.testing.assert_array_equal(_rows(body[inw]), _rows(want))


def test_device_crop_over_budget_keeps_the_budget_of_tile_rows(trained):
    """An over-budget tile gets exactly ``max_pts`` rows, every one from
    its in-window set; the host crop gets a subset of the same size."""
    _, _, port, _ = trained
    scene = _uniform_scene(5, 20000, [8, 8, 3])   # one tile, ~18k rows
    pcr = np.asarray(port.point_cloud_range, np.float32)
    for device_crop in (True, False):
        recorded = []
        ti = TiledInference(port, predict_fn=_recorder(recorded),
                            device_crop=device_crop)
        ti(scene)
        lo, tiles = _tiles(ti, scene)
        assert len(tiles) == len(recorded) == 1
        pts, num = recorded[0]
        body = pts[0, :int(num[0])]
        want = _in_window(scene, pcr, np.array([*tiles[0], lo[2]],
                                               np.float32))
        assert len(want) > 2 * ti.max_pts
        inw = np.all((body[:, :3] >= pcr[:3]) & (body[:, :3] < pcr[3:]),
                     axis=1)
        assert int(inw.sum()) == ti.max_pts == len(body)
        got = {tuple(r) for r in np.round(body, 4)}
        assert len(got) == ti.max_pts
        assert got <= {tuple(r) for r in np.round(want, 4)}


def test_run_bounds_equal_masked_counts(trained):
    """The searchsorted run bounds equal the JAX package's (runs, N)
    masked counts on the (column, y)-sorted scene, for tiles anywhere
    (columns past the scene's end included)."""
    _, _, port, _ = trained
    ti = TiledInference(port, overlap=2.0)
    scene = _uniform_scene(9, 5000, [20, 14, 3])
    scene[:50, 1] = scene[50:100, 1]           # equal y within columns
    scene[100:110, 1] = 0.0
    lo0 = float(scene[:, 0].min())
    ss, key = ti._sort_scene_cols(torch.as_tensor(scene), lo0)
    cols = np.floor((ss[:, 0].numpy() - np.float32(lo0))
                    / np.float32(ti.xcell)).astype(np.int32)
    ys = ss[:, 1].numpy()
    assert np.all(np.diff(key.numpy()) >= 0)
    rng = np.random.default_rng(0)
    shifts = np.concatenate([rng.uniform([-2, -2, 0], [30, 16, 0], (40, 3)),
                             scene[:8, :3]]).astype(np.float32)
    shifts[:4, 1] = [0.0, ys[7], ys[3000], -0.0]
    starts, lens = ti._run_bounds(key, torch.as_tensor(shifts), lo0)
    for t, (x0, y0, _) in enumerate(shifts):
        cx0 = np.int32(np.floor((x0 - np.float32(lo0))
                                / np.float32(ti.xcell)))
        run_cols = cx0 + np.arange(ti.n_runs, dtype=np.int32)
        y1 = y0 + np.float32(ti.tile_y)
        base = np.searchsorted(cols, run_cols, side="left")
        incol = cols[None, :] == run_cols[:, None]
        lo_off = np.sum(incol & (ys[None, :] < y0), axis=1)
        hi_off = np.sum(incol & (ys[None, :] < y1), axis=1)
        np.testing.assert_array_equal(starts[t].numpy(), base + lo_off)
        np.testing.assert_array_equal(lens[t].numpy(), hi_off - lo_off)


def test_scene_matches_the_jax_host_path(trained):
    jm, jv, port, batch = trained
    base = jm.make_predict_fn()(jv, batch)
    assert bool(np.asarray(base["valid"]).any())
    scene = _two_tree_scene(batch)
    want = JaxTiledInference(jm, jv, overlap=2.0,
                             predict_fn=jm.make_predict_fn(),
                             max_merge_boxes=64, device_crop=False)(scene)
    got = TiledInference(port, overlap=2.0, max_merge_boxes=64,
                         device_crop=False)(scene)
    _same_detections(got, want, 1e-4, 1e-5)
    boxes = np.stack([d["bbox"] for d in got])
    assert np.all((boxes[:, 0] >= 29.0) & (boxes[:, 0] <= 47.0))
    assert np.all((boxes[:, 1] >= 9.0) & (boxes[:, 1] <= 19.0))


@pytest.mark.parametrize("batch_tiles", [1, 2])
def test_device_path_matches_the_host_path(trained, batch_tiles):
    _, _, port, batch = trained
    scene = _two_tree_scene(batch)
    host = TiledInference(port, overlap=2.0, max_merge_boxes=64,
                          device_crop=False)(scene)
    ti = TiledInference(port, overlap=2.0, max_merge_boxes=64,
                        batch_tiles=batch_tiles)
    _same_detections(ti(scene), host, 1e-3)


def test_merge_suppresses_duplicates(trained):
    _, _, port, _ = trained
    ti = TiledInference(port, overlap=2.0, max_merge_boxes=64)
    # two identical boxes from overlapping tiles -> one survivor
    box = np.array([3.0, 3.0, 0.2, 0.8, 0.8, 2.5, 0, 0, 0.3], np.float32)
    n = ti.max_merge_boxes
    pb = np.zeros((n, 9), np.float32)
    pb[0] = box
    pb[1] = box
    ps = np.zeros((n,), np.float32)
    ps[:2] = [0.9, 0.8]
    pl = np.zeros((n,), np.int32)
    pv = np.arange(n) < 2
    keep = ti._merge(pb, ps, pl, pv).numpy()
    assert keep[0] and not keep[1:].any()


def _stub_tiles(n_tiles, d, seed):
    """Per-tile candidates of a stub predict: ``d`` disjoint boxes per
    tile with random scores, some of them duplicated across tiles."""
    rng = np.random.default_rng(seed)
    boxes, scores, labels = [], [], []
    for k in range(n_tiles):
        b = np.zeros((d, 9), np.float32)
        b[:, 0] = 0.3 + 0.19 * np.arange(d)
        b[:, 1] = 1.0 + 0.53 * (k // 2)      # tile pairs overlap exactly
        b[:, 2] = 0.2
        b[:, 3:6] = [0.1, 0.1, 1.0]
        boxes.append(b)
        scores.append(rng.uniform(0.31, 1.0, d).astype(np.float32))
        labels.append(np.zeros((d,), np.int32))
    return boxes, scores, labels


def test_merge_truncation_keeps_top_scores(trained):
    """Above ``max_merge_boxes`` the cut keeps the top-scoring candidates
    (a tile-order cut would drop the best boxes of later tiles)."""
    _, _, port, _ = trained
    d = 40
    calls = {"n": 0}

    def stub_predict(batch):
        # scores rise with the tile index: the last tile holds the best
        k = calls["n"]
        calls["n"] += 1
        bbox = np.zeros((1, d, 9), np.float32)
        bbox[0, :, 0] = 0.3 + 0.19 * np.arange(d)
        bbox[0, :, 1] = 1.0 + 0.53 * k
        bbox[0, :, 2] = 0.2
        bbox[0, :, 3:6] = [0.1, 0.1, 1.0]
        score = (0.5 + 0.004 * (d * k + np.arange(d)))[None]
        return {"bbox": torch.as_tensor(bbox),
                "score": torch.as_tensor(score.astype(np.float32)),
                "label": torch.zeros((1, d), dtype=torch.int32),
                "valid": torch.ones((1, d), dtype=torch.bool)}

    scene = _uniform_scene(0, 2000, [20, 8, 3])
    ti = TiledInference(port, overlap=2.0, predict_fn=stub_predict,
                        max_merge_boxes=64, device_crop=False)
    dets = ti(scene)
    n_tiles = calls["n"]
    assert n_tiles * d > ti.max_merge_boxes
    all_scores = 0.5 + 0.004 * np.arange(n_tiles * d)
    got = np.sort([float(x["score"]) for x in dets])
    # disjoint boxes: nothing suppressed, so exactly the budget
    assert len(got) == ti.max_merge_boxes
    assert np.isclose(got.max(), all_scores[-1], atol=1e-5)
    assert got.min() >= all_scores[-ti.max_merge_boxes] - 1e-5


@pytest.mark.parametrize("n_tiles", [3, 6])
def test_merge_host_matches_jax(trained, n_tiles):
    """The same candidates (duplicates across tiles; at 6 tiles over the
    budget) give the same merged detections in both packages."""
    jm, jv, port, _ = trained
    boxes, scores, labels = _stub_tiles(n_tiles, 20, seed=n_tiles)
    got = TiledInference(port, max_merge_boxes=64)._merge_host(
        boxes, scores, labels)
    want = JaxTiledInference(jm, jv, max_merge_boxes=64)._merge_host(
        boxes, scores, labels)
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x["label"] == y["label"] and x["score"] == y["score"]
        np.testing.assert_array_equal(x["bbox"], y["bbox"])
