"""The port's box geometry, anchors, decode, SAT test and NMS against the
JAX package, in float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetection_3d_tpu.models.anchors import (
    Anchor3DRangeGenerator as JaxAnchors,
    BBoxCoder as JaxCoder,
)
from objectdetection_3d_tpu.ops import boxes as jax_boxes
from objectdetection_3d_tpu.ops.iou3d import obb_intersect as jax_obb
from objectdetection_3d_tpu.ops.nms import multiclass_nms as jax_nms
from objectdetection_3d_tpu_torch.models.anchors import (
    Anchor3DRangeGenerator,
    BBoxCoder,
)
from objectdetection_3d_tpu_torch.models.detector import topk_lowest_index
from objectdetection_3d_tpu_torch.ops import boxes
from objectdetection_3d_tpu_torch.ops.iou3d import obb_intersect
from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms

torch.set_num_threads(1)

# float32 trig and 3x3 products summed in another order
ATOL = 1e-5


def _boxes(seed, n, spread=3.0):
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 9), np.float32)
    b[:, :3] = rng.uniform(0, spread, (n, 3))
    b[:, 3:6] = rng.uniform(0.3, 2.0, (n, 3))
    b[:, 6:8] = rng.uniform(-0.4, 0.4, (n, 2))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("fn", ["box_corners_3d",
                                "rotated_corners_2d_envelope"])
def test_box_functions_match_jax(fn):
    b = _boxes(0, 64)
    want = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(b)))
    got = getattr(boxes, fn)(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rotation_axes_and_period_match_jax():
    b = _boxes(1, 32)
    rot_w, mid_w = jax_boxes.box_axes(jnp.asarray(b))
    rot_g, mid_g = boxes.box_axes(torch.from_numpy(b))
    np.testing.assert_allclose(rot_g.numpy(), np.asarray(rot_w), atol=ATOL)
    np.testing.assert_allclose(mid_g.numpy(), np.asarray(mid_w), atol=ATOL)
    val = np.linspace(-10, 10, 101).astype(np.float32)
    np.testing.assert_allclose(
        boxes.limit_period(torch.from_numpy(val), 1.0, np.pi).numpy(),
        np.asarray(jax_boxes.limit_period(jnp.asarray(val), 1.0, jnp.pi)),
        atol=ATOL)


def test_iou_aabb_2d_matches_jax():
    rng = np.random.default_rng(2)
    lo = rng.uniform(0, 5, (20, 2)).astype(np.float32)
    a = np.concatenate([lo, lo + rng.uniform(0.1, 3, (20, 2))], -1)
    lo = rng.uniform(0, 5, (12, 2)).astype(np.float32)
    c = np.concatenate([lo, lo + rng.uniform(0.1, 3, (12, 2))], -1)
    a, c = a.astype(np.float32), c.astype(np.float32)
    want = np.asarray(jax_boxes.iou_aabb_2d(jnp.asarray(a), jnp.asarray(c)))
    got = boxes.iou_aabb_2d(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_anchors_and_decode_match_jax():
    ranges = [[0.0, 0.0, 0.0, 40.0, 40.0, 30.0]]
    sizes = [[0.75, 0.75, 12], [1.3, 1.3, 17], [1.0, 1.75, 20]]
    rots = [[0.0, 0.0, 0.0], [0.0, 0.0, 1.57], [0.3142, 0.0, 0.0],
            [-0.3142, 0.0, 0.0]]
    featmap = (40, 24)
    want = JaxAnchors(ranges, sizes, rots).flat_anchors(featmap)
    gen = Anchor3DRangeGenerator(ranges, sizes, rots)
    got = gen.flat_anchors(featmap).numpy()
    assert gen.num_base_anchors == 12
    np.testing.assert_array_equal(got, want)
    # flat order ((y*W+x)*S+s)*R+r
    y, x, s, r = 7, 5, 2, 3
    row = got[((y * featmap[1] + x) * 3 + s) * 4 + r]
    assert row[0] == pytest.approx(40.0 * x / (featmap[1] - 1))
    assert row[1] == pytest.approx(40.0 * y / (featmap[0] - 1))
    np.testing.assert_array_equal(row[3:6], np.float32(sizes[s]))
    np.testing.assert_array_equal(row[6:9], np.float32(rots[r]))

    rng = np.random.default_rng(4)
    deltas = rng.normal(0, 0.3, want.shape).astype(np.float32)
    dec_w = np.asarray(JaxCoder.decode(jnp.asarray(want),
                                       jnp.asarray(deltas)))
    dec_g = BBoxCoder.decode(torch.from_numpy(got),
                             torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(dec_g, dec_w, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obb_intersect_matches_jax(seed):
    b1 = _boxes(seed, 48)
    b2 = _boxes(seed + 10, 40)
    want = np.asarray(jax_obb(jnp.asarray(b1), jnp.asarray(b2)))
    got = obb_intersect(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nms_dim,thr", [(3, 1e-5), (2, 0.1)])
def test_multiclass_nms_matches_jax(nms_dim, thr):
    rng = np.random.default_rng(5)
    b = _boxes(6, 64, spread=6.0)
    scores = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    valid = rng.uniform(0, 1, 64) > 0.1
    want = np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(scores), 0.3, thr,
                              nms_dim=nms_dim,
                              valid_mask=jnp.asarray(valid)))
    got = multiclass_nms(torch.from_numpy(b), torch.from_numpy(scores), 0.3,
                         thr, nms_dim=nms_dim,
                         valid_mask=torch.from_numpy(valid)).numpy()
    assert want.sum() > 2
    np.testing.assert_array_equal(got, want)


def test_nms_exact_3d_iou_matches_jax():
    # above 1e-4, nms_dim=3 runs the exact rotated-3D IoU
    # (tests/test_torch_port_iou3d.py holds it against the JAX package at
    # 0.1)
    b = _boxes(7, 4)
    scores = np.linspace(0.4, 0.9, 4, dtype=np.float32)[:, None]
    want = np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(scores), 0.3, 0.5,
                              nms_dim=3))
    got = multiclass_nms(torch.from_numpy(b), torch.from_numpy(scores), 0.3,
                         0.5, nms_dim=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_ties_rank_lower_index_first():
    # two identical overlapping boxes with equal scores: the lower index
    # ranks first and suppresses the other
    b = torch.from_numpy(np.repeat(_boxes(8, 1), 3, axis=0))
    scores = torch.tensor([[0.5], [0.9], [0.9]])
    keep = multiclass_nms(b, scores, 0.3, 1e-5, nms_dim=3)
    assert keep[:, 0].tolist() == [False, True, False]


def test_topk_ties_take_lowest_index_first():
    x = torch.tensor([1.0, 3.0, 2.0, 3.0, 2.0, 2.0, 0.5, 2.0])
    assert topk_lowest_index(x, 5).tolist() == [1, 3, 2, 4, 5]
    # equal values everywhere (inactive pixels carry the head bias)
    flat = torch.full((1000,), -4.59)
    assert topk_lowest_index(flat, 7).tolist() == list(range(7))
    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.integers(0, 20, 4096).astype(np.float32))
    got = topk_lowest_index(vals, 300)
    want = sorted(range(4096), key=lambda i: (-vals[i].item(), i))[:300]
    assert got.tolist() == want
