"""The port's target assignment and its geometry kernels' plain versions
against the JAX package, float32 on the CPU.

* K3 / K4 plain (``ops/assign_geometry.py``) against the Pallas kernels in
  interpret mode on the ``_tiny_layout`` shapes of
  ``tests/test_assign_geometry.py``: keys rtol 1e-5, atol 1e-6 (the
  per-GT tables come from einsums summed in another order); integer and
  flag outputs exact after the combo-major -> flat reorder.
* ``assign_targets`` against the JAX package's on the layout path, with
  the exact anchor tier and without it (``exact_anchor_tier=False``, the
  ``tpu.assign_exact_anchor_tier`` knob): masks, labels and ``num_pos`` exact,
  ``best_gt`` and the direction targets exact under ``pos_mask``,
  ``target_deltas`` and ``max_overlap`` 1e-5.  Outside ``pos_mask`` both
  follow a ``best_gt`` that no loss reads, and a touching pair there may
  clip to 1e-7 in one clipper and to 0 in the other (the JAX package's
  CPU path runs its XLA clipper, the port the Pallas body's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.models.assign import (
    assign_targets as jax_assign_targets,
)
from objectdetection_3d_tpu.ops.assign_geometry import (
    _combo_table,
    _pad_cells,
)
from objectdetection_3d_tpu.ops.assign_geometry import (
    chunk_geometry as jax_chunk_geometry,
)
from objectdetection_3d_tpu.ops.assign_geometry import (
    containment_rescue as jax_containment_rescue,
)
from objectdetection_3d_tpu.ops.assign_geometry import (
    top3_merge as jax_top3_merge,
)
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models.assign import (
    assign_targets,
    make_anchor_layout,
    topk_rows_lowest_index,
)
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.ops import assign_geometry as geo
from test_assign_geometry import _gt_chunk, _tiny_layout
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

KEY_TOL = dict(rtol=1e-5, atol=1e-6)


def _m_major_to_flat(x, nc):
    """(..., M, Ncp) combo-major kernel layout -> (..., Nc * M) flat."""
    x = np.asarray(x)[..., :nc]
    return np.swapaxes(x, -1, -2).reshape(x.shape[:-2] + (-1,))


@pytest.fixture(scope="module")
def tiny_geometry():
    rng = np.random.default_rng(0)
    anchors, layout, m = _tiny_layout(rng)
    gt, mask = _gt_chunk(rng)
    # a GT around cell 3, holding its anchors (containment IoUs > 0)
    cx, cy, cz = layout[0][3]
    gt[1] = [cx, cy, cz - 0.5, 3.0, 3.0, 5.0, 0.0, 0.0, 0.0]
    t_layout = make_anchor_layout(torch.from_numpy(anchors), m)
    return anchors, layout, m, gt, mask, t_layout


def test_anchor_layout_matches_jax(tiny_geometry):
    _, layout, _, _, _, t_layout = tiny_geometry
    for got, want in zip(t_layout, layout):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(geo.combo_table(t_layout).numpy(),
                                  _combo_table(layout))


def test_anchor_layout_rejects_unfactorable_grids():
    anchors = torch.zeros((8, 9))
    anchors[1, 0] = 1.0      # two combos of cell 0 at different centers
    with pytest.raises(ValueError):
        make_anchor_layout(anchors, 2)
    with pytest.raises(ValueError):
        make_anchor_layout(anchors, 3)


def test_chunk_geometry_plain_matches_interpret(tiny_geometry):
    _, layout, _, gt, mask, t_layout = tiny_geometry
    gch = gt.shape[0]
    nc = layout[0].shape[0]
    sentinel = 7
    want = jax_chunk_geometry(
        jnp.asarray(gt), jnp.asarray(mask), jnp.arange(gch, dtype=jnp.int32),
        layout, jnp.asarray(_pad_cells(layout[0])[0]),
        jnp.asarray(_combo_table(layout)), sentinel, interpret=True)
    ftab, tabs = geo.chunk_tables(torch.from_numpy(gt),
                                  torch.from_numpy(mask), t_layout)
    got = geo.chunk_geometry(ftab, torch.arange(gch, dtype=torch.int32),
                             tabs, geo.combo_table(t_layout), t_layout[0],
                             sentinel)
    np.testing.assert_allclose(got["key"].numpy(),
                               _m_major_to_flat(want["key"], nc), **KEY_TOL)
    for name in ("cm", "v1", "v2", "v3"):
        np.testing.assert_allclose(got[name].numpy(),
                                   _m_major_to_flat(want[name], nc),
                                   **KEY_TOL, err_msg=name)
    for name in ("cb", "a1", "a2", "a3", "mb"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      _m_major_to_flat(want[name], nc),
                                      err_msg=name)
    np.testing.assert_allclose(got["rmax"].numpy(),
                               np.asarray(want["rmax"])[:, :nc], **KEY_TOL)
    assert (got["cm"] > 0).any() and (got["mb"] == 0).any()


def test_chunk_geometry_plain_matches_interpret_on_negative_dims(
        tiny_geometry):
    """C9: GT rows with negative dims (one dim, and all three) go through
    the plain version as through the JAX body; on the card K3 refuses
    them (``tests/test_torch_port_cuda.py``)."""
    _, layout, _, gt, mask, t_layout = tiny_geometry
    gt = gt.copy()
    gt[0, 3] *= -1.0
    gt[2, 4:6] *= -1.0
    gt[1, 3:6] = -20.0          # its containment IoUs are negative
    gch = gt.shape[0]
    nc = layout[0].shape[0]
    want = jax_chunk_geometry(
        jnp.asarray(gt), jnp.asarray(mask), jnp.arange(gch, dtype=jnp.int32),
        layout, jnp.asarray(_pad_cells(layout[0])[0]),
        jnp.asarray(_combo_table(layout)), 7, interpret=True)
    ftab, tabs = geo.chunk_tables(torch.from_numpy(gt),
                                  torch.from_numpy(mask), t_layout)
    cell, cell_on_v = geo._anchor_frame(geo.combo_table(t_layout),
                                        t_layout[0])
    iou, _, _ = geo._containment(ftab[1], tabs, 1, geo.combo_table(t_layout),
                                 cell, cell_on_v, False)
    assert float(iou.min()) < 0.0
    got = geo.chunk_geometry(ftab, torch.arange(gch, dtype=torch.int32),
                             tabs, geo.combo_table(t_layout), t_layout[0], 7)
    np.testing.assert_allclose(got["key"].numpy(),
                               _m_major_to_flat(want["key"], nc), **KEY_TOL)
    for name in ("cm", "v1", "v2", "v3"):
        np.testing.assert_allclose(got[name].numpy(),
                                   _m_major_to_flat(want[name], nc),
                                   **KEY_TOL, err_msg=name)
    for name in ("cb", "a1", "a2", "a3", "mb"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      _m_major_to_flat(want[name], nc),
                                      err_msg=name)
    np.testing.assert_allclose(got["rmax"].numpy(),
                               np.asarray(want["rmax"])[:, :nc], **KEY_TOL)


@pytest.mark.parametrize("ok", [(1, 1, 1, 1, 1), (0, 1, 0, 0, 0)])
def test_containment_rescue_plain_matches_interpret(tiny_geometry, ok):
    _, layout, _, gt, mask, t_layout = tiny_geometry
    gch = gt.shape[0]
    nc = layout[0].shape[0]
    ftab, tabs = geo.chunk_tables(torch.from_numpy(gt),
                                  torch.from_numpy(mask), t_layout)
    combo = geo.combo_table(t_layout)
    geom = geo.chunk_geometry(ftab, torch.arange(gch, dtype=torch.int32),
                              tabs, combo, t_layout[0], gch)
    # each GT's own containment row max: its achievers are the rescues
    row_max = geom["rmax"].amax(dim=1).numpy()
    rescue_ok = np.asarray(ok, bool)
    want = jax_containment_rescue(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(row_max),
        jnp.asarray(rescue_ok), layout, jnp.asarray(_pad_cells(layout[0])[0]),
        jnp.asarray(_combo_table(layout)), interpret=True)
    rthr = torch.stack([torch.from_numpy(row_max),
                        torch.from_numpy(rescue_ok).float()], dim=1)
    got = geo.containment_rescue(ftab, rthr, tabs, combo, t_layout[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _m_major_to_flat(want, nc))
    assert got.sum() > 0


def _per_gt_hits(ftab, rthr, tabs, combo, cells):
    """(gch, Nc, M) bool: the plain rescue of each GT row alone."""
    m = combo.shape[1]
    return torch.stack([geo.containment_rescue_plain(
        ftab[g:g + 1], rthr[g:g + 1], tabs[:, 3 * g:3 * g + 3], combo,
        cells).reshape(-1, m) > 0 for g in range(ftab.shape[0])])


@pytest.mark.parametrize("case", ["above", "one-size", "masked-box"])
def test_containment_rescue_thresholds_match_interpret(tiny_geometry, case):
    """Row maxima that are not the rows' own containment maxima, as in the
    assignment (where they also hold the candidate and tier maxima): GT 1
    holds anchors of both sizes (ratio_a 0.028 and 0.1), GT 2 lies inside
    anchors of both sizes at cell 7 (ratio_b 0.056 and 0.016).  "above":
    GT 1's row max lies above every containment IoU; "one-size": each
    row max is a ratio that one anchor size reaches (GT 1 the larger
    size's ratio_a, GT 2 the smaller size's ratio_b, the others none);
    "masked-box": the masked last row holds GT 1's box."""
    _, layout, m, gt, mask, t_layout = tiny_geometry
    gt = gt.copy()
    cx, cy, cz = layout[0][7]
    gt[2] = [cx, cy, cz + 0.3, 0.3, 0.3, 0.8, 0.0, 0.0, 0.1]
    if case == "masked-box":
        gt[4] = gt[1]
    gch = gt.shape[0]
    nc = layout[0].shape[0]
    cells = t_layout[0]
    combo = geo.combo_table(t_layout)
    ftab, tabs = geo.chunk_tables(torch.from_numpy(gt),
                                  torch.from_numpy(mask), t_layout)
    own = geo.chunk_geometry(ftab, torch.arange(gch, dtype=torch.int32),
                             tabs, combo, cells, gch)["rmax"].amax(dim=1)
    volg, cvol = ftab[:, 15], combo[12]
    row_max = own.clone()
    if case == "above":
        row_max[1] = 0.5
    elif case == "one-size":
        row_max[:] = 2.0
        row_max[1] = cvol[2] / volg[1]      # size 1 (combos 2, 3) only
        row_max[2] = volg[2] / cvol[0]      # size 0 (combos 0, 1) only
    rescue_ok = np.ones(gch, bool)
    want = jax_containment_rescue(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(row_max.numpy()),
        jnp.asarray(rescue_ok), layout, jnp.asarray(_pad_cells(layout[0])[0]),
        jnp.asarray(_combo_table(layout)), interpret=True)
    rthr = torch.stack([row_max, torch.from_numpy(rescue_ok).float()],
                       dim=1)
    got = geo.containment_rescue(ftab, rthr, tabs, combo, cells)
    np.testing.assert_array_equal(got.numpy(), _m_major_to_flat(want, nc))

    # K4 skips every (GT, combo) without flag A or B: none of them hits
    flags = geo.rescue_flags(ftab, rthr, tabs, combo)
    per_gt = _per_gt_hits(ftab, rthr, tabs, combo, cells)
    dead = (flags & 3) == 0
    assert not per_gt[dead[:, None, :].expand_as(per_gt)].any()
    assert torch.equal(per_gt.any(dim=0).reshape(-1).int(), got)
    assert got.sum() > 0
    if case == "above":
        assert not per_gt[1].any() and per_gt[2].any()
    elif case == "one-size":
        assert per_gt[1, :, 2:].any() and not per_gt[1, :, :2].any()
        assert per_gt[2, 7, 0] and not per_gt[2, :, 2:].any()
        assert not per_gt[[0, 3, 4]].any()
    else:
        assert not mask[4] and dead[4].all() and not per_gt[4].any()


def test_top3_merge_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    state = [np.full(n, -np.inf, np.float32), np.full(n, 9, np.int32)] * 3
    t_state = [torch.from_numpy(a.copy()) for a in state]
    for gid in range(6):
        # few distinct values: many ties, which keep the incumbent
        w = rng.integers(0, 3, n).astype(np.float32)
        gw = np.full(n, gid, np.int32)
        state = [np.asarray(a) for a in jax_top3_merge(
            *map(jnp.asarray, state), jnp.asarray(w), jnp.asarray(gw))]
        t_state = list(geo.top3_merge(*t_state, torch.from_numpy(w),
                                      torch.from_numpy(gw)))
    for got, want in zip(t_state, state):
        np.testing.assert_array_equal(got.numpy(), want)


def test_topk_rows_takes_lowest_index_on_ties():
    key = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0],
                        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                        [5.0, 4.0, 3.0, 2.0, 1.0, 0.0]])
    got = topk_rows_lowest_index(key, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  [[1, 2, 4], [0, 1, 2], [0, 1, 2]])
    # the same set as lax.top_k, whose ties also take the lowest index
    want = jax.lax.top_k(jnp.asarray(key.numpy()), 3)[1]
    np.testing.assert_array_equal(np.sort(np.asarray(want), axis=1),
                                  got.numpy())


@pytest.fixture(scope="module")
def models():
    return (JaxPointPillars(**tiny_model_cfg()),
            PointPillars(configs.tiny_model_cfg(), device="cpu"))


def _assign_pair(models, gt, labels, mask, tier=True):
    jm, tm = models
    k = int(jm.tpu_cfg["assign_candidates_per_gt"])
    want = jax_assign_targets(
        jm.anchors, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask),
        pos_thr=jm._pos_thr, neg_thr=jm._neg_thr, candidates_per_gt=k,
        num_classes=jm.num_classes, anchor_aabb=jm.anchor_aabb,
        layout=jm.anchor_layout, exact_anchor_tier=tier)
    got = assign_targets(
        tm.anchors, torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(mask), tm._pos_thr, tm._neg_thr, tm.anchor_layout,
        candidates_per_gt=k, num_classes=tm.num_classes,
        combo_tab=tm.combo_tab, exact_anchor_tier=tier)
    return {k_: np.asarray(v) for k_, v in want.items()}, {
        k_: v.numpy() for k_, v in got.items()}


def _assert_assign_equal(want, got, overlap_atol=1e-5):
    for name in ("pos_mask", "neg_mask", "target_labels", "num_pos"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    pos = want["pos_mask"]
    for name in ("best_gt", "dir_targets"):
        np.testing.assert_array_equal(got[name][pos], want[name][pos],
                                      err_msg=name)
    np.testing.assert_allclose(got["target_deltas"], want["target_deltas"],
                               atol=1e-5)
    np.testing.assert_allclose(got["max_overlap"], want["max_overlap"],
                               atol=overlap_atol)


_SEEDS = [(0, 3, 8), (1, 3, 8), (2, 4, 8), (3, 5, 20)]


# the default tier keeps the cases' old ids; "notier" is
# exact_anchor_tier=False
@pytest.mark.parametrize("seed,num_gt,max_gt,tier", [
    pytest.param(*s, tier, id="-".join(map(str, s)) + ("" if tier else
                                                       "-notier"))
    for tier in (True, False) for s in _SEEDS])
def test_assign_targets_matches_jax(models, seed, num_gt, max_gt, tier):
    batch = tiny_batch(batch_size=1, num_gt=num_gt, seed=seed,
                       max_gt=max_gt)
    want, got = _assign_pair(models, batch["bboxes"][0], batch["labels"][0],
                             batch["gt_mask"][0], tier)
    _assert_assign_equal(want, got)
    assert 0 < int(want["num_pos"])
    # some anchors are ignored: neither positive nor negative
    assert (~want["pos_mask"] & ~want["neg_mask"]).any()


def test_assign_targets_all_padding(models):
    g = 8
    gt = np.zeros((g, 9), np.float32)
    labels = np.zeros((g,), np.int32)
    mask = np.zeros((g,), bool)
    want, got = _assign_pair(models, gt, labels, mask)
    _assert_assign_equal(want, got)
    assert int(got["num_pos"]) == 0
    assert got["neg_mask"].all()
    assert np.isfinite(got["target_deltas"]).all()


def test_assign_needs_a_layout(models):
    _, tm = models
    with pytest.raises(NotImplementedError):
        assign_targets(tm.anchors, torch.zeros((2, 9)),
                       torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.bool), 0.2, 0.08, None)


def _ring_scene(seed):
    """The scene of the JAX package's
    ``test_exact_anchor_tier_recovers_ring_positives``: anchor-sized GTs
    (no containment), K = 2 candidates per GT, so most positives are
    found by the exact anchor tier alone."""
    from objectdetection_3d_tpu.models.anchors import (
        Anchor3DRangeGenerator,
    )

    rng = np.random.default_rng(seed)
    gen = Anchor3DRangeGenerator(
        ranges=[[0, 0, 0, 16.0, 16.0, 6.0]], sizes=[[1.2, 1.2, 3.0]],
        rotations=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.57]])
    anchors = np.asarray(gen.flat_anchors((32, 32)), np.float32)
    g_valid = 6
    gt = np.zeros((8, 9), np.float32)
    gt[:g_valid, :2] = rng.uniform(3, 13, (g_valid, 2))
    gt[:g_valid, 2] = rng.uniform(-0.2, 0.2, g_valid)
    gt[:g_valid, 3:6] = [1.4, 1.4, 3.2]
    gt[:g_valid, 6:8] = rng.uniform(-0.05, 0.05, (g_valid, 2))
    gt[:g_valid, 8] = rng.uniform(-np.pi, np.pi, g_valid)
    return anchors, gt, np.arange(8) < g_valid, np.zeros(8, np.int32)


@pytest.mark.parametrize("seed", [1, 7])
def test_exact_anchor_tier_changes_positives_as_in_jax(seed):
    from objectdetection_3d_tpu.models.assign import (
        make_anchor_layout as jax_layout,
    )

    anchors, gt, mask, labels = _ring_scene(seed)
    kw = dict(pos_thr=0.2, neg_thr=0.08, candidates_per_gt=2, gt_chunk=4)
    j_layout = tuple(jnp.asarray(a) for a in jax_layout(anchors, 2))
    t_anchors = torch.from_numpy(anchors)
    t_layout = make_anchor_layout(t_anchors, 2)
    num_pos = {}
    for tier in (True, False):
        want = jax_assign_targets(
            jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels),
            jnp.asarray(mask), **kw, layout=j_layout,
            exact_anchor_tier=tier)
        got = assign_targets(
            t_anchors, torch.from_numpy(gt), torch.from_numpy(labels),
            torch.from_numpy(mask), layout=t_layout, exact_anchor_tier=tier,
            **kw)
        want = {k_: np.asarray(v) for k_, v in want.items()}
        # the ring's partial overlaps are clipped by the JAX package's XLA
        # clipper and by the port's Pallas-body clipper, whose plane
        # orders differ: overlaps near 0.5 differ by up to ~2e-5
        _assert_assign_equal(want, {k_: v.numpy() for k_, v in got.items()},
                             overlap_atol=1e-4)
        num_pos[tier] = int(got["num_pos"])
    assert num_pos[False] < num_pos[True]


def test_assign_reads_the_exact_anchor_tier_knob(models, monkeypatch):
    """``PointPillars.assign`` passes ``tpu.assign_exact_anchor_tier`` on:
    with False it equals the JAX assignment without the tier and never
    runs the tier's pair clipper (K7)."""
    from objectdetection_3d_tpu_torch.ops import gathered_iou3d

    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg.get("tpu") or {}, assign_exact_anchor_tier=False)
    tm = PointPillars(cfg, device="cpu")
    assert tm.tpu_cfg["assign_exact_anchor_tier"] is False

    def no_pair(*args, **kwargs):
        raise AssertionError("the exact anchor tier ran")

    for name in ("iou_gathered_pair", "iou_gathered_pair_plain"):
        monkeypatch.setattr(gathered_iou3d, name, no_pair)
    batch = tiny_batch(batch_size=1, num_gt=5, seed=3, max_gt=20)
    got = tm.assign(batch, plain=True)
    want, _ = _assign_pair(models, batch["bboxes"][0], batch["labels"][0],
                           batch["gt_mask"][0], tier=False)
    _assert_assign_equal(want, {k_: v[0].numpy() for k_, v in got.items()})
