"""The port's losses and ``BBoxCoder.encode`` against the JAX package,
float32 on the CPU.  Tolerance 1e-6 (relative and absolute): the same
elementwise formulas, summed in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetection_3d_tpu.losses import losses as jax_losses
from objectdetection_3d_tpu.models.anchors import BBoxCoder as JaxBBoxCoder
from objectdetection_3d_tpu_torch.losses import losses
from objectdetection_3d_tpu_torch.models.anchors import BBoxCoder

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("avg_factor", [None, 7.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches_jax(avg_factor, weighted):
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 3, (200, 3)).astype(np.float32)
    target = rng.integers(0, 4, 200).astype(np.int32)   # 3 = background
    weight = (rng.uniform(size=(200, 1)) > 0.3).astype(np.float32)
    w = weight if weighted else None
    want = jax_losses.FocalLoss(gamma=2.0, alpha=0.25, loss_weight=1.5)(
        jnp.asarray(pred), jnp.asarray(target),
        weight=None if w is None else jnp.asarray(w), avg_factor=avg_factor)
    got = losses.FocalLoss(gamma=2.0, alpha=0.25, loss_weight=1.5)(
        _t(pred), _t(target), weight=None if w is None else _t(w),
        avg_factor=avg_factor)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_focal_loss_single_logit_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 2, 64).astype(np.float32)
    target = (rng.uniform(size=64) > 0.5).astype(np.float32)
    want = jax_losses.FocalLoss()(jnp.asarray(pred), jnp.asarray(target))
    got = losses.FocalLoss()(_t(pred), _t(target))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_one_hot_maps_label_c_to_background():
    got = losses.one_hot(torch.tensor([0, 2, 3, 1]), 3)
    want = np.asarray(jax_losses.one_hot(jnp.asarray([0, 2, 3, 1]), 3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].sum() == 0


@pytest.mark.parametrize("avg_factor", [None, 3.0])
def test_smooth_l1_matches_jax(avg_factor):
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 0.3, (100, 9)).astype(np.float32)
    tgt = rng.normal(0, 0.3, (100, 9)).astype(np.float32)
    weight = (rng.uniform(size=(100, 1)) > 0.5).astype(np.float32)
    want = jax_losses.SmoothL1Loss(beta=0.11, loss_weight=2.0)(
        jnp.asarray(pred), jnp.asarray(tgt), weight=jnp.asarray(weight),
        avg_factor=avg_factor)
    got = losses.SmoothL1Loss(beta=0.11, loss_weight=2.0)(
        _t(pred), _t(tgt), weight=_t(weight), avg_factor=avg_factor)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("avg_factor", [None, 5.0])
def test_cross_entropy_matches_jax(avg_factor):
    rng = np.random.default_rng(3)
    score = rng.normal(0, 2, (120, 2)).astype(np.float32)
    label = rng.integers(-1, 3, 120).astype(np.int32)   # clipped to [0, 1]
    weight = rng.uniform(size=120).astype(np.float32)
    want = jax_losses.CrossEntropyLoss(loss_weight=0.2)(
        jnp.asarray(score), jnp.asarray(label), weight=jnp.asarray(weight),
        avg_factor=avg_factor)
    got = losses.CrossEntropyLoss(loss_weight=0.2)(
        _t(score), _t(label), weight=_t(weight), avg_factor=avg_factor)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_bbox_encode_matches_jax_and_decode_inverts_it():
    rng = np.random.default_rng(4)
    anchors = np.concatenate([
        rng.uniform(0, 40, (256, 3)), rng.uniform(0.5, 20, (256, 3)),
        rng.uniform(-0.4, 0.4, (256, 3))], 1).astype(np.float32)
    boxes = np.concatenate([
        rng.uniform(0, 40, (256, 3)), rng.uniform(0.5, 20, (256, 3)),
        rng.uniform(-np.pi, np.pi, (256, 3))], 1).astype(np.float32)
    want = np.asarray(JaxBBoxCoder.encode(jnp.asarray(anchors),
                                          jnp.asarray(boxes)))
    got = BBoxCoder.encode(_t(anchors), _t(boxes))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # decode returns the box's z center where encode took its bottom, as
    # in the JAX package
    back = BBoxCoder.decode(_t(anchors), got).numpy()
    back[:, 2] -= back[:, 5] / 2
    np.testing.assert_allclose(back, boxes, rtol=1e-5, atol=1e-4)
