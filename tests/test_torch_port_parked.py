"""The paths the flagship does not take, in the port against the JAX
package, float32 on the CPU at the tiny configuration: the layout-free
assignment, the (V, M, C) buffer voxelizer with deeper PFN stacks, the
gather encoder (``tpu.sparse_middle``) and the dense backbone and neck
(``use_dense_backbone``).  The same numpy-seeded inputs and the same
weights (``weights.from_jax_variables``) go through both packages.

Tolerances:

* assignment: masks, labels and ``num_pos`` exact, ``best_gt`` and the
  direction targets exact under ``pos_mask``, ``target_deltas`` and
  ``max_overlap`` 1e-5 (as ``test_torch_port_assign.py``);
* voxelizer: every output exact (reflectance order included);
* network outputs, pseudo-images and primitives: rtol = atol = 1e-4
  (float32 sums taken in another order), as ``test_torch_port_model.py``;
* predict: boxes atol 1e-4, scores atol 1e-5, labels and valid exact on
  the valid rows;
* one train step: losses 1e-4; the gradients the update receives rtol
  1e-4 of each leaf's largest element; updated parameters and running
  statistics rtol 1e-4, atol 1e-5 (as ``test_torch_port_train.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.models import anchors as jax_anchors
from objectdetection_3d_tpu.models.assign import (
    assign_targets as jax_assign_targets,
)
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models import anchors as port_anchors
from objectdetection_3d_tpu_torch.models.assign import assign_targets
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    from_jax_variables,
    to_jax_variables,
)
from test_torch_port_model import _leaves, _random_variables
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4
OPT_CFG = dict(lr=1e-3, betas=[0.95, 0.99], weight_decay=0.01)


def _models(cfg, port_cfg=None, seed=0):
    """(JAX model, its random variables, port model with those weights)."""
    jm = JaxPointPillars(**cfg)
    variables = _random_variables(
        jm.init_variables(jax.random.PRNGKey(seed)), seed=seed)
    tm = PointPillars(port_cfg or cfg, device="cpu")
    from_jax_variables(tm.net, variables)
    return jm, variables, tm


def _assert_heads(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def _assert_predict(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.any()
    np.testing.assert_array_equal(got["label"][v], want["label"][v])
    np.testing.assert_allclose(got["bbox"][v], want["bbox"][v], atol=1e-4)
    np.testing.assert_allclose(got["score"][v], want["score"][v],
                               atol=1e-5)


def _train_step_pair(jm, variables, tm, batch):
    """One train step in each package from the same weights and a fresh
    optimizer: losses, the gradients the update receives (before its
    clip, against ``jax.grad``), updated parameters and running
    statistics."""
    tx = jm.get_optimizer(OPT_CFG, grad_clip_value=2.0)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"])}
    new_state, want = jm.make_train_step(tx, donate=False)(state, batch)

    def jax_total(params):
        outs, _ = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, batch,
                           train=True)
        return sum(jm.loss(outs, batch, jm.anchors,
                           jm.anchor_aabb).values())

    want_g = dict(_leaves(jax.tree.map(np.asarray, jax.jit(jax.grad(
        jax_total))(variables["params"]))))

    ttx = tm.get_optimizer(OPT_CFG, grad_clip_value=2.0)
    got_g = {}
    update = ttx.step

    def step_recording_grads(closure=None):
        for name, p in tm.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            got_g[path] = arr
        return update(closure)

    ttx.step = step_recording_grads
    got = tm.make_train_step(ttx)(batch)
    assert set(got_g) == set(want_g)
    for path, arr in want_g.items():
        scale = float(np.abs(arr).max())
        np.testing.assert_allclose(got_g[path], arr, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert int(got["num_pos"]) > 0
    back = to_jax_variables(tm.net)
    for coll in ("params", "batch_stats"):
        want_c = dict(_leaves(jax.tree.map(np.asarray, new_state[coll])))
        got_c = dict(_leaves(back[coll]))
        assert set(got_c) == set(want_c)
        for path, arr in want_c.items():
            np.testing.assert_allclose(got_c[path], arr, rtol=1e-4,
                                       atol=1e-5, err_msg=str(path))
    return got


# ---------------------------------------------------------------------------
# the layout-free assignment (A11d)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scrambled():
    """Both packages' tiny models on ``tests/test_model.py``'s scrambled
    anchors: one anchor's size leaves its combo set, so the grid does not
    factor and no layout is made."""
    jax_orig = jax_anchors.Anchor3DRangeGenerator.flat_anchors
    port_orig = port_anchors.Anchor3DRangeGenerator.flat_anchors

    def jax_scrambled(self, featmap_size):
        a = jax_orig(self, featmap_size).copy()
        a[0, 3] += 0.123
        return a

    def port_scrambled(self, featmap_size, device="cpu"):
        a = port_orig(self, featmap_size, device).clone()
        a[0, 3] += 0.123
        return a

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_anchors.Anchor3DRangeGenerator, "flat_anchors",
               jax_scrambled)
    mp.setattr(port_anchors.Anchor3DRangeGenerator, "flat_anchors",
               port_scrambled)
    try:
        models = _models(tiny_model_cfg(), configs.tiny_model_cfg())
    finally:
        mp.undo()
    jm, _, tm = models
    assert jm.anchor_layout is None and tm.anchor_layout is None
    np.testing.assert_array_equal(tm.anchors.numpy(), np.asarray(jm.anchors))
    return models


def _assert_assign_equal(want, got):
    for name in ("pos_mask", "neg_mask", "target_labels", "num_pos"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    pos = want["pos_mask"]
    for name in ("best_gt", "dir_targets"):
        np.testing.assert_array_equal(got[name][pos], want[name][pos],
                                      err_msg=name)
    np.testing.assert_allclose(got["target_deltas"], want["target_deltas"],
                               atol=1e-5)
    np.testing.assert_allclose(got["max_overlap"], want["max_overlap"],
                               atol=1e-5)


@pytest.mark.parametrize("prefilter", ["full", "block"])
@pytest.mark.parametrize("seed,num_gt,max_gt,gt_chunk", [
    (0, 3, 8, 16), (1, 4, 8, 3), (3, 5, 20, 16)])
def test_layout_free_assignment_matches_jax(scrambled, prefilter, seed,
                                            num_gt, max_gt, gt_chunk):
    """``assign_targets(..., layout=None)``: the JAX package's layout-free
    branch at ``prefilter`` ``full`` and ``block`` (block 100, which does
    not divide N) against the port's one exact top-K; a ``gt_chunk`` that
    does not divide G wraps padding rows onto real GTs."""
    jm, _, tm = scrambled
    batch = tiny_batch(batch_size=1, num_gt=num_gt, seed=seed, max_gt=max_gt)
    gt, labels, mask = (batch[k][0] for k in ("bboxes", "labels", "gt_mask"))
    k = int(jm.tpu_cfg["assign_candidates_per_gt"])
    want = jax_assign_targets(
        jm.anchors, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask),
        pos_thr=jm._pos_thr, neg_thr=jm._neg_thr, candidates_per_gt=k,
        gt_chunk=gt_chunk, num_classes=jm.num_classes,
        anchor_aabb=jm.anchor_aabb, prefilter=prefilter, prefilter_block=100,
        layout=None)
    got = assign_targets(
        tm.anchors, torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(mask), tm._pos_thr, tm._neg_thr, None,
        candidates_per_gt=k, gt_chunk=gt_chunk, num_classes=tm.num_classes,
        anchor_aabb=tm.anchor_aabb)
    want = {k_: np.asarray(v) for k_, v in want.items()}
    got = {k_: v.numpy() for k_, v in got.items()}
    _assert_assign_equal(want, got)
    assert int(want["num_pos"]) > 0
    # the unevaluated bound leaves some anchors neither positive nor
    # negative
    assert (~want["pos_mask"] & ~want["neg_mask"]).any()


def test_layout_free_assignment_plain_route_and_knob(scrambled, monkeypatch):
    """``plain=True`` is the same assignment on the CPU; the model's
    ``assign`` takes the layout-free branch and reads no layout knob."""
    _, _, tm = scrambled
    batch = tiny_batch(batch_size=2, num_gt=3, seed=5)
    got = tm.assign(batch)
    plain = tm.assign(batch, plain=True)
    for key in got:
        assert torch.equal(got[key], plain[key]), key
    assert int(got["num_pos"].sum()) > 0
    monkeypatch.setitem(tm.tpu_cfg, "assign_exact_anchor_tier", False)
    again = tm.assign(batch)
    for key in got:
        assert torch.equal(got[key], again[key]), key


def test_layout_free_train_step_matches_jax(scrambled):
    jm, variables, _ = scrambled
    mp = pytest.MonkeyPatch()
    port_orig = port_anchors.Anchor3DRangeGenerator.flat_anchors

    def port_scrambled(self, featmap_size, device="cpu"):
        a = port_orig(self, featmap_size, device).clone()
        a[0, 3] += 0.123
        return a

    mp.setattr(port_anchors.Anchor3DRangeGenerator, "flat_anchors",
               port_scrambled)
    try:
        tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    finally:
        mp.undo()
    from_jax_variables(tm.net, variables)
    assert tm.anchor_layout is None
    batch = tiny_batch(batch_size=2, seed=1)
    _train_step_pair(jm, variables, tm, batch)
    # the eval step takes the same branch
    losses, preds = tm.make_eval_fn()(batch)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert bool(torch.isfinite(preds["bbox"]).all())


# ---------------------------------------------------------------------------
# the (V, M, C) buffer voxelizer and deeper PFN stacks
# ---------------------------------------------------------------------------
VOX_KW = dict(voxel_size=(0.5, 0.5, 1.0),
              point_cloud_range=(0.0, 0.0, 0.0, 8.0, 8.0, 4.0))


def _cloud(seed, p=512, n=400):
    """Clustered points (some voxels overflow the cap, some points leave
    the range or the voxel budget) with reflectances on 5 levels, so the
    reflectance order has ties that only the index breaks."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((p, 4), np.float32)
    pts[:n, :3] = rng.normal(4.0, 2.2, (n, 3)).astype(np.float32)
    pts[:n, 3] = rng.integers(0, 5, n) / 4.0
    return pts


@pytest.mark.parametrize("seed,m,v", [(0, 4, 64), (1, 3, 512), (2, 8, 16)])
def test_buffer_voxelizer_matches_jax(seed, m, v):
    from objectdetection_3d_tpu.ops.voxelize import voxelize as jax_voxelize
    from objectdetection_3d_tpu_torch.ops.voxelize import voxelize_batch

    clouds = np.stack([_cloud(seed), _cloud(seed + 10)])
    n = np.array([400, 350], np.int32)
    kw = dict(VOX_KW, max_points_per_voxel=m, max_voxels=v)
    got = voxelize_batch(torch.from_numpy(clouds), torch.from_numpy(n), **kw)
    for i in range(2):
        want = jax_voxelize(jnp.asarray(clouds[i]), int(n[i]), **kw)
        assert set(got) == set(want)
        for key in want:
            w = np.asarray(want[key])
            g = got[key][i].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert int(got["num_voxels"].max()) > 1


def test_shuffled_voxelizer_keeps_subsets_of_each_voxel():
    """The ``shuffle_key`` path with a ``torch.Generator``: held to
    properties, not to JAX's draws.  Each voxel keeps ``min(points, M)``
    of its own points, coords and counts are those of the reflectance
    path, and another draw keeps other points."""
    from objectdetection_3d_tpu_torch.ops.voxelize import Voxelizer

    pts = torch.from_numpy(_cloud(3))[None]
    n = torch.tensor([400], dtype=torch.int32)
    kw = dict(VOX_KW, max_voxel_points=3, max_voxels=512)
    ref = Voxelizer(**kw)(pts, n)
    shuffled = Voxelizer(**kw, reflectance_sampling=False)
    runs = [shuffled(pts, n, torch.Generator().manual_seed(s))
            for s in (0, 1)]
    cloud = pts[0, :400].numpy()
    cells = np.floor(cloud[:, :3] / np.array([0.5, 0.5, 1.0])).astype(int)
    for out in runs:
        for key in ("coords", "num_points_per_voxel", "num_voxels",
                    "voxel_mask"):
            assert torch.equal(out[key], ref[key]), key
        for j in range(int(out["num_voxels"][0])):
            z, y, x = out["coords"][0, j].tolist()
            mine = cloud[(cells == [x, y, z]).all(axis=1)]
            k = int(out["num_points_per_voxel"][0, j])
            assert k == min(len(mine), 3)
            kept = out["voxels"][0, j, :k].numpy()
            for row in kept:
                assert (mine == row).all(axis=1).any()
            assert len({tuple(r) for r in kept.tolist()}) == k
            assert not out["voxels"][0, j, k:].any()
    assert not torch.equal(runs[0]["voxels"], runs[1]["voxels"])


def _deep_pfn_cfg():
    cfg = tiny_model_cfg()
    cfg["voxel_encoder"]["feat_channels"] = [16, 20]
    cfg["vertical_encoder"]["in_channels"] = 20
    return cfg


@pytest.fixture(scope="module")
def deep_pfn():
    cfg = _deep_pfn_cfg()
    jm, variables, tm = _models(cfg)
    assert not jm._use_point_pfn and not tm.use_point_pfn
    return jm, variables, tm


def test_buffered_pfn_matches_jax(deep_pfn):
    """``feat_channels=[16, 20]``: the PFN (eval and train mode, with the
    running statistics it moves), the head outputs and predict."""
    from objectdetection_3d_tpu_torch.models.layers import (
        PillarFeatureNetBuffers,
    )

    jm, variables, tm = deep_pfn
    assert isinstance(tm.net.voxel_encoder, PillarFeatureNetBuffers)
    batch = tiny_batch(batch_size=2, seed=3)
    vox = jm.voxelize_batch(batch["points"], batch["num_points"])
    for train in (False, True):
        _, inter = jm.net.apply(
            variables, vox["voxels"], vox["num_points_per_voxel"],
            vox["coords"], vox["voxel_mask"], train=train,
            capture_intermediates=True,
            mutable=["intermediates", "batch_stats"])
        want = inter["intermediates"]["voxel_encoder"]["__call__"][0]
        tvox = tm.voxel_layer(torch.from_numpy(batch["points"]),
                              torch.from_numpy(batch["num_points"]))
        b, v, m, c = tvox["voxels"].shape
        tm.net.train(train)
        got = tm.net.voxel_encoder(
            tvox["voxels"].reshape(b * v, m, c),
            tvox["num_points_per_voxel"].reshape(-1),
            tvox["coords"].reshape(-1, 3), tvox["voxel_mask"].reshape(-1))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        if train:
            stats = inter["batch_stats"]["voxel_encoder"]
            for i in range(2):
                bn = getattr(tm.net.voxel_encoder, f"pfn_{i}").norm
                np.testing.assert_allclose(
                    bn.running_mean.numpy(),
                    np.asarray(stats[f"pfn_{i}"]["norm"]["mean"]), **TOL)
                np.testing.assert_allclose(
                    bn.running_var.numpy(),
                    np.asarray(stats[f"pfn_{i}"]["norm"]["var"]), **TOL)
    from_jax_variables(tm.net, variables)   # undo the statistics' move
    want, _ = jm.apply(variables, batch)
    _assert_heads(tm.apply(batch), want)
    _assert_predict(tm.make_predict_fn()(batch),
                    jm.make_predict_fn()(variables, batch))


def test_buffered_pfn_train_step_matches_jax(deep_pfn):
    jm, variables, _ = deep_pfn
    _, _, tm = _models(_deep_pfn_cfg())
    _train_step_pair(jm, variables, tm, tiny_batch(batch_size=2, seed=1))


@pytest.mark.parametrize("key,value,point", [
    ("point_pfn", False, False), ("point_pfn", True, True),
    ("sparse_middle", True, False)])
def test_point_pfn_choice_follows_jax(key, value, point):
    cfg = tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], **{key: value})
    tm = PointPillars(cfg, device="cpu")
    assert JaxPointPillars(**cfg)._use_point_pfn is point
    assert tm.use_point_pfn is point


def test_point_and_buffer_paths_compute_one_function():
    """``tpu.point_pfn: false`` on the flagship's single-layer stack: the
    buffer path gives the point path's outputs from the same weights
    (``tests/test_point_pfn.py``)."""
    cfg = tiny_model_cfg()
    _, variables, point = _models(cfg)
    cfg["tpu"] = dict(cfg["tpu"], point_pfn=False)
    buffers = PointPillars(cfg, device="cpu")
    from_jax_variables(buffers.net, variables)
    batch = tiny_batch(batch_size=2, seed=4)
    for a, b in zip(point.apply(batch), buffers.apply(batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the gather encoder (tpu.sparse_middle)
# ---------------------------------------------------------------------------
def _active_set(seed, grid=(8, 6, 7), n=40, v=48, c=5):
    """A sorted padded active set of ``n`` random cells in ``grid`` with
    features, as the voxelizer hands it to the encoder."""
    from objectdetection_3d_tpu.ops.sparse_conv import (
        flatten_cells as jax_flatten_cells,
    )

    rng = np.random.default_rng(seed)
    d, h, w = grid
    cells = np.sort(rng.choice(d * h * w, n, replace=False))
    coords = -np.ones((v, 3), np.int32)
    coords[:n] = np.stack([cells // (h * w), (cells // w) % h, cells % w], 1)
    mask = np.arange(v) < n
    feats = (rng.normal(0, 1, (v, c)) * mask[:, None]).astype(np.float32)
    flat = np.asarray(jax_flatten_cells(jnp.asarray(coords), grid))
    return grid, coords, mask, feats, flat


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_conv_primitives_match_jax(seed):
    """Each primitive of ``ops/sparse_conv.py`` against the JAX package's:
    the flat ids and index map exact, the binary-search lookup exact, the
    active-set downsample exact, the two convs and the pseudo-image 1e-4
    (float32 matmuls summed in another order)."""
    from objectdetection_3d_tpu.ops import sparse_conv as J
    from objectdetection_3d_tpu_torch.ops import sparse_conv as T

    grid, coords, mask, feats, flat = _active_set(seed)
    tc, tm_, tf = (torch.from_numpy(x) for x in (coords, mask, feats))
    got_flat = T.flatten_cells(tc, grid)
    np.testing.assert_array_equal(got_flat.numpy(), flat)
    imap = T.build_index_map(got_flat, grid)
    want_map = np.asarray(J.build_index_map(jnp.asarray(flat), grid))
    np.testing.assert_array_equal(imap.numpy(), want_map)
    assert int(imap[-1]) == len(flat)          # the sentinel reads row V

    rng = np.random.default_rng(seed + 7)
    queries = np.concatenate([flat, rng.integers(0, np.prod(grid) + 1, 60)])
    for g, w in zip(T.neighbor_lookup(got_flat, torch.from_numpy(
            queries.astype(np.int32))),
            J._neighbor_lookup(jnp.asarray(flat), jnp.asarray(queries))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    k3 = rng.normal(0, 0.3, (3, 3, 3, 5, 6)).astype(np.float32)
    want = J.subm_conv3d_sparse(jnp.asarray(feats), jnp.asarray(coords),
                                jnp.asarray(want_map), jnp.asarray(mask),
                                jnp.asarray(k3), grid)
    got = T.subm_conv3d_sparse(tf, tc, imap, tm_, torch.from_numpy(k3), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    new_w = J.downsample_z_active_set(jnp.asarray(coords), jnp.asarray(mask),
                                      grid, 40)
    new_g = T.downsample_z_active_set(tc, tm_, grid, 40)
    assert new_g["grid"] == tuple(new_w["grid"])
    for key in ("coords", "cell_flat", "active_mask"):
        np.testing.assert_array_equal(new_g[key].numpy(),
                                      np.asarray(new_w[key]), err_msg=key)
    assert new_g["active_mask"].any()

    kd = rng.normal(0, 0.3, (3, 6, 4)).astype(np.float32)
    x6 = np.asarray(want)
    want_d = J.strided_z_conv_sparse(jnp.asarray(x6), jnp.asarray(want_map),
                                     new_w["coords"], new_w["active_mask"],
                                     jnp.asarray(kd), grid)
    got_d = T.strided_z_conv_sparse(torch.from_numpy(x6.copy()), imap,
                                    new_g["coords"], new_g["active_mask"],
                                    torch.from_numpy(kd), grid)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)

    g2 = new_g["grid"]
    img_w = J.scatter_pseudo_image(want_d, new_w["coords"],
                                   new_w["active_mask"], g2)
    img_g = T.scatter_pseudo_image(got_d, new_g["coords"],
                                   new_g["active_mask"], g2)
    np.testing.assert_allclose(img_g.permute(1, 2, 0).numpy(),
                               np.asarray(img_w), **TOL)


def test_downsample_active_set_rules():
    """``tests/test_sparse_middle.py``'s case: D = 8 gives D' = 3, and
    z = 7 lies beyond the VALID window."""
    from objectdetection_3d_tpu_torch.ops.sparse_conv import (
        downsample_z_active_set,
    )

    coords = torch.tensor([[0, 1, 1], [5, 2, 2], [7, 3, 3], [-1, -1, -1]],
                          dtype=torch.int32)
    mask = torch.tensor([True, True, True, False])
    out = downsample_z_active_set(coords, mask, (8, 4, 4), 8)
    got = {tuple(c.tolist()) for c, m in zip(out["coords"],
                                             out["active_mask"]) if m}
    assert got == {(0, 1, 1), (2, 2, 2)}


def _sparse_cfg(sparse=True, stages=(16,)):
    cfg = tiny_model_cfg()
    cfg["vertical_encoder"]["out_channels"] = list(stages)
    cfg["backbone"]["in_channels"] = stages[-1]
    cfg["tpu"] = dict(cfg["tpu"], sparse_middle=sparse)
    return cfg


@pytest.fixture(scope="module")
def sparse_models():
    """One encoder stage: the tiny grid's D = 4 allows one (z 4 -> 1)."""
    return _models(_sparse_cfg())


def test_gather_encoder_matches_jax_and_the_dense_encoder(sparse_models):
    """``SparseMiddleExtractorGather`` forward: its pseudo-image against
    the JAX package's gather encoder and against the port's dense encoder
    from the same state dict; the head outputs and predict against JAX."""
    from objectdetection_3d_tpu_torch.models.sparse_middle import (
        SparseMiddleExtractorGather,
    )

    jm, variables, tm = sparse_models
    assert isinstance(tm.net.pseudoimage_generator,
                      SparseMiddleExtractorGather)
    batch = tiny_batch(batch_size=2, seed=3)
    vox = jm.voxelize_batch(batch["points"], batch["num_points"])
    _, inter = jm.net.apply(
        variables, vox["voxels"], vox["num_points_per_voxel"],
        vox["coords"], vox["voxel_mask"], train=False,
        capture_intermediates=True, mutable=["intermediates"])
    want = np.asarray(
        inter["intermediates"]["pseudoimage_generator"]["__call__"][0])
    got = {}
    hook = tm.net.pseudoimage_generator.register_forward_hook(
        lambda mod, args, out: got.__setitem__("pseudo", out))
    try:
        heads = tm.apply(batch)
    finally:
        hook.remove()
    assert np.count_nonzero(want) > 0
    np.testing.assert_allclose(got["pseudo"].permute(0, 2, 3, 1).numpy(),
                               want, **TOL)
    dense = PointPillars(_sparse_cfg(sparse=False), device="cpu")
    dense.net.load_state_dict(tm.net.state_dict())
    dgot = {}
    hook = dense.net.pseudoimage_generator.register_forward_hook(
        lambda mod, args, out: dgot.__setitem__("pseudo", out))
    try:
        dheads = dense.apply(batch)
    finally:
        hook.remove()
    np.testing.assert_allclose(dgot["pseudo"].numpy(),
                               got["pseudo"].numpy(), **TOL)
    want_h, _ = jm.apply(variables, batch)
    _assert_heads(heads, want_h)
    _assert_heads(dheads, want_h)
    _assert_predict(tm.make_predict_fn()(batch),
                    jm.make_predict_fn()(variables, batch))


@pytest.mark.parametrize("budget", [0, 1024])
def test_gather_encoder_two_stages(budget):
    """Two stages on a 12-deep grid (z 12 -> 5 -> 2): the active set is
    rebuilt by the downsample twice.  Against the JAX package's gather
    encoder at either budget; at budget 0 (= V, 256) the first downsample
    has more candidate sites than the budget and keeps the lowest ids in
    both packages, so only at 1024 does it also equal the dense encoder
    (the JAX package's own two encoders differ at 256 alike)."""
    def deep(sparse):
        cfg = _sparse_cfg(sparse, stages=(16, 12))
        cfg["point_cloud_range"] = [0.0, 0.0, 0.0, 8.0, 8.0, 6.0]
        cfg["voxelize"]["voxel_size"] = [0.5, 0.5, 0.5]
        cfg["voxel_encoder"]["voxel_size"] = [0.5, 0.5, 0.5]
        cfg["backbone"]["in_channels"] = 24
        cfg["tpu"]["sparse_budget"] = budget
        return cfg

    jm, variables, sparse = _models(deep(True))
    batch = tiny_batch(batch_size=2, seed=6)
    want, _ = jm.apply(variables, batch)
    got = sparse.apply(batch)
    _assert_heads(got, want)
    if budget:
        dense = PointPillars(deep(False), device="cpu")
        from_jax_variables(dense.net, variables)
        for a, b in zip(got, dense.apply(batch)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_gather_encoder_train_step_matches_jax(sparse_models):
    jm, variables, _ = sparse_models
    _, _, tm = _models(_sparse_cfg())
    got = _train_step_pair(jm, variables, tm,
                           tiny_batch(batch_size=2, seed=4))
    # and the dense encoder's step from the same weights gives the same
    # losses (``tests/test_sparse_middle.py``)
    dense = PointPillars(_sparse_cfg(sparse=False), device="cpu")
    from_jax_variables(dense.net, variables)
    tx = dense.get_optimizer(OPT_CFG, grad_clip_value=2.0)
    dlosses = dense.make_train_step(tx)(tiny_batch(batch_size=2, seed=4))
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(dlosses[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the dense backbone and neck (use_dense_backbone)
# ---------------------------------------------------------------------------
def _dense_backbone_cfg():
    """``tests/test_model.py``'s dense-backbone case: strides 2, 2, 2 and
    a last upsample of 4 give a featmap of H/2 x W/2.  The neck's
    ``in_channels`` key is not read (its inputs are the backbone's)."""
    cfg = tiny_model_cfg()
    cfg["use_dense_backbone"] = True
    cfg["backbone"] = dict(in_channels=16, out_channels=[16, 24, 32],
                           layer_nums=[1, 1, 1], layer_strides=[2, 2, 2])
    cfg["neck"] = dict(in_channels=[512, 256, 128],
                       out_channels=[16, 16, 16],
                       upsample_strides=[1, 2, 4])
    return cfg


@pytest.fixture(scope="module")
def dense_backbone():
    models = _models(_dense_backbone_cfg())
    jm, _, tm = models
    assert tm.featmap == jm.featmap == (8, 8)
    np.testing.assert_array_equal(tm.anchors.numpy(), np.asarray(jm.anchors))
    return models


def test_dense_backbone_forward_and_predict_match_jax(dense_backbone):
    jm, variables, tm = dense_backbone
    batch = tiny_batch(batch_size=2, seed=3)
    want, _ = jm.apply(variables, batch)
    got = tm.apply(batch)
    assert got[0].shape == (2, 8, 8, tm.num_anchors)
    _assert_heads(got, want)
    _assert_predict(tm.make_predict_fn()(batch),
                    jm.make_predict_fn()(variables, batch))


def test_dense_backbone_train_step_matches_jax(dense_backbone):
    """The plain batch norms of the backbone and neck move their running
    statistics as flax's do (biased variance, momentum 0.99 kept)."""
    jm, variables, _ = dense_backbone
    _, _, tm = _models(_dense_backbone_cfg())
    _train_step_pair(jm, variables, tm, tiny_batch(batch_size=2, seed=1))


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_deconv_weights_round_trip_both_ways(stride):
    """A flax ``ConvTranspose`` (kernel = stride, ``padding="SAME"``) and
    the port's ``deconv_{i}`` from the same leaf give the same output,
    and the leaf comes back unchanged from the port's weight."""
    import flax.linen as fnn

    from objectdetection_3d_tpu_torch.models.weights import _leaf_to_port

    rng = np.random.default_rng(stride)
    x = rng.normal(0, 1, (2, 5, 6, 3)).astype(np.float32)
    mod = fnn.ConvTranspose(4, (stride, stride), strides=(stride, stride),
                            use_bias=False)
    kernel = rng.normal(0, 1, (stride, stride, 3, 4)).astype(np.float32)
    want = np.asarray(mod.apply({"params": {"kernel": kernel}},
                                jnp.asarray(x)))
    name, w = _leaf_to_port("params", ("neck", f"deconv_{stride}", "kernel"),
                            kernel)
    assert name == f"neck.deconv_{stride}.weight" and w.shape == (3, 4,
                                                                 stride,
                                                                 stride)
    deconv = torch.nn.ConvTranspose2d(3, 4, stride, stride=stride,
                                      bias=False)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(w.copy()))
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    coll, path, back = _port_to_leaf(name, deconv.weight.detach().numpy())
    assert (coll, path) == ("params", ("neck", f"deconv_{stride}", "kernel"))
    np.testing.assert_array_equal(back, kernel)


def test_dense_backbone_weights_round_trip(dense_backbone):
    """``to_jax_variables`` of the port's net is the JAX tree it was
    loaded from, leaf for leaf (backbone, neck and ``deconv_{i}``
    included), and loading it back changes no bit."""
    _, variables, tm = dense_backbone
    back = to_jax_variables(tm.net)
    for coll in ("params", "batch_stats"):
        want = dict(_leaves(jax.tree.map(np.asarray, variables[coll])))
        got = dict(_leaves(back[coll]))
        assert set(got) == set(want)
        assert any("deconv_2" in p for p in got) or coll == "batch_stats"
        for path, arr in want.items():
            np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    from_jax_variables(tm.net, back)
    for k, v in tm.net.state_dict().items():
        assert torch.equal(v, before[k]), k
