"""The port's exact rotated-3D IoU (the plain clipper of ``ops/iou3d.py``
and the plain versions of K6 and K7 in ``ops/gathered_iou3d.py``) against
the JAX package, float32 on the CPU.

The JAX kernel bodies (``_gathered_iou``, ``_gathered_iou_multi``) run
eagerly, as ``tests/test_pallas_iou3d.py`` runs them: interpret mode
compiles the clipper graph for tens of minutes.  Pairs include identical
boxes, exactly touching faces and nested boxes.  Tolerance: atol 1e-5 of
IoU (sin/cos and the last sums round differently); the JAX package's XLA
clipper clips the planes in another order and is held at 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu.ops.iou3d import iou3d as jax_iou3d
from objectdetection_3d_tpu.ops.iou3d import (
    iou3d_aligned as jax_iou3d_aligned,
)
from objectdetection_3d_tpu.ops.nms import multiclass_nms as jax_nms
from objectdetection_3d_tpu.ops.pallas_iou3d import (
    _gathered_iou,
    _gathered_iou_multi,
)
from objectdetection_3d_tpu.ops.pallas_iou3d import (
    iou_gathered as jax_iou_gathered,
)
from objectdetection_3d_tpu_torch.ops import iou3d as port_iou3d
from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
    iou_gathered,
    iou_gathered_pair,
)
from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms

torch.set_num_threads(1)


def _random_pairs(rng, p):
    b1 = np.zeros((p, 9), np.float32)
    b1[:, :3] = rng.uniform(-5, 5, (p, 3))
    b1[:, 3:6] = rng.uniform(0.3, 4.0, (p, 3))
    b1[:, 6:9] = rng.uniform(-0.6, 0.6, (p, 3))
    b2 = (b1 + rng.normal(0, 0.8, (p, 9))).astype(np.float32)
    b2[:, 3:6] = np.abs(b2[:, 3:6]) + 0.2
    # adversarial: identical, exactly touching in x, contained
    b2[:32] = b1[:32]
    b2[32:64] = b1[32:64]
    b2[32:64, 0] += b1[32:64, 3]
    b2[64:96] = b1[64:96]
    b2[64:96, 3:6] *= 0.5
    return b1, b2


def _soa(boxes):
    b = jnp.asarray(boxes, jnp.float32)
    return [b[:, i] for i in range(9)]


@pytest.fixture(scope="module")
def gathered_case():
    rng = np.random.default_rng(0)
    table, boxes2 = _random_pairs(rng, 512)
    g = 40
    table = table[:g]
    valid = rng.uniform(size=g) > 0.2
    ids_a = rng.integers(0, g, 512).astype(np.int32)
    ids_b = rng.integers(0, g, 512).astype(np.int32)
    # pair p < 96 meets its adversarial partner
    boxes2[:96] = table[ids_a[:96]]
    boxes2[32:64, 0] += table[ids_a[32:64], 3]
    boxes2[64:96, 3:6] *= 0.5
    return table, valid, ids_a, ids_b, boxes2


def _jax_table(table, valid):
    return jnp.concatenate([jnp.asarray(table).T,
                            jnp.asarray(valid, jnp.float32)[None]], 0)


def test_iou_gathered_plain_matches_kernel_body(gathered_case):
    table, valid, ids_a, _, boxes2 = gathered_case
    with jax.disable_jit():
        want = np.asarray(_gathered_iou(_jax_table(table, valid),
                                        jnp.asarray(ids_a), _soa(boxes2)))
    got = iou_gathered(torch.from_numpy(table), torch.from_numpy(valid),
                       torch.from_numpy(ids_a), torch.from_numpy(boxes2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (want[:32][valid[ids_a[:32]]] > 0.999).all()
    assert (got.numpy() == 0)[~valid[ids_a]].all()


def test_iou_gathered_pair_plain_matches_kernel_body(gathered_case):
    table, valid, ids_a, ids_b, boxes2 = gathered_case
    with jax.disable_jit():
        want = _gathered_iou_multi(_jax_table(table, valid),
                                   [jnp.asarray(ids_a), jnp.asarray(ids_b)],
                                   _soa(boxes2))
    got = iou_gathered_pair(torch.from_numpy(table), torch.from_numpy(valid),
                            torch.from_numpy(ids_a), torch.from_numpy(ids_b),
                            torch.from_numpy(boxes2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_iou_gathered_plain_matches_xla_clipper(gathered_case):
    table, valid, ids_a, _, boxes2 = gathered_case
    want = np.asarray(jax_iou_gathered(
        jnp.asarray(table), jnp.asarray(valid), jnp.asarray(ids_a),
        jnp.asarray(boxes2), pallas="off"))
    got = iou_gathered(torch.from_numpy(table), torch.from_numpy(valid),
                       torch.from_numpy(ids_a), torch.from_numpy(boxes2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_chunks_do_not_change_the_clipper(monkeypatch):
    rng = np.random.default_rng(1)
    b1, b2 = (torch.from_numpy(a) for a in _random_pairs(rng, 300))
    whole = port_iou3d.intersection_volume_aligned(b1, b2)
    monkeypatch.setattr(port_iou3d, "PAIR_CHUNK", 7)
    chunked = port_iou3d.intersection_volume_aligned(b1, b2)
    assert torch.equal(whole, chunked)
    assert port_iou3d.intersection_volume_aligned(b1[:0], b2[:0]).shape == (
        0,)


def test_iou3d_matches_jax():
    rng = np.random.default_rng(2)
    b1, b2 = _random_pairs(rng, 96)
    boxes1 = np.concatenate([b1[:24], np.zeros((2, 9), np.float32)])
    boxes2 = b2[:30]
    want = np.asarray(jax_iou3d(jnp.asarray(boxes1), jnp.asarray(boxes2)))
    got = port_iou3d.iou3d(torch.from_numpy(boxes1), torch.from_numpy(boxes2))
    assert got.shape == (26, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert (got[24:] == 0).all()          # zero-volume padding rows
    want = np.asarray(jax_iou3d_aligned(jnp.asarray(b1), jnp.asarray(b2)))
    got = port_iou3d.iou3d_aligned(torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_exact_iou_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 48
    boxes = np.zeros((n, 9), np.float32)
    centers = rng.uniform(0, 6, (n // 3, 2))
    boxes[:, :2] = np.repeat(centers, 3, 0) + rng.normal(0, 0.3, (n, 2))
    boxes[:, 2] = rng.uniform(0, 0.5, n)
    boxes[:, 3:6] = rng.uniform([0.6, 0.6, 2.0], [1.2, 1.2, 4.0], (n, 3))
    boxes[:, 6:9] = rng.uniform(-0.2, 0.2, (n, 3))
    scores = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.2,
                              0.1, nms_dim=3))
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.2, 0.1, nms_dim=3)
    np.testing.assert_array_equal(got.numpy(), want)
    # suppression happened, and not of everything
    valid = scores > 0.2
    assert 0 < want.sum() < valid.sum()
