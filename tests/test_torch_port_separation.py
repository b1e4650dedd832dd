"""What the K6/K7 and K8 kernels compute in Python beside their CUDA code.

* The separating-plane test that K6/K7 run before the clip
  (``ops/iou3d.separated_directions``): wherever it clears both
  directions of a pair, the port's plain clipper and the JAX package's
  Pallas clipper body (``_clip_volumes``, run eagerly as
  ``tests/test_pallas_iou3d.py`` runs it) both return exactly 0.  Seeded
  pairs: random, tilted, touching, nested, far apart, and faces 1.2 mm
  and 0.8 mm apart (just outside and inside the test's margin).  Where
  it clears one direction only, the plain clipper's six face volumes of
  the cleared box are exactly +0.0, and leaving them out of the sum
  changes no bit: what lets the kernels skip them.
* K8's weight packings, unpacked here by plain loops over their
  documented layouts and compared exactly with the weights they came
  from: the subm weights (``pallas_conv.kernel_weights``) and the down
  weights (``fused_stage.down_weights``).  No JAX function packs weights,
  so no JAX reference runs for them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu.ops.pallas_iou3d import _clip_volumes
from objectdetection_3d_tpu_torch.ops.fused_stage import (
    down_weights,
    fused_stage,
)
from objectdetection_3d_tpu_torch.ops.iou3d import (
    SEPARATION_MARGIN,
    _face_volumes,
    clip_work,
    intersection_volume_aligned,
    separated_directions,
)
from objectdetection_3d_tpu_torch.ops.pallas_conv import kernel_weights
from test_torch_port_cuda import (
    _aligned_pairs,
    _random_pairs,
    _separation_cases,
)

torch.set_num_threads(1)


def _pairs(kind, rng):
    """(box 1, box 2) float32 numpy pairs of one kind."""
    if kind == "random":
        b1, b2 = _random_pairs(rng, 400)
        # spread them so that some pairs lie apart
        b2[:, :2] += rng.uniform(-6, 6, (400, 2)).astype(np.float32)
        return b1, b2
    if kind == "tilted":
        b1, b2 = _random_pairs(rng, 400)
        b1[:, 6:9] = rng.uniform(-0.6, 0.6, (400, 3))
        b2[:, 6:9] = rng.uniform(-0.6, 0.6, (400, 3))
        b2[:, :2] = b1[:, :2] + rng.uniform(-5, 5, (400, 2))
        return b1, b2.astype(np.float32)
    table, ids, boxes = _separation_cases(rng, 37)
    return table[ids], boxes


@pytest.mark.parametrize("kind", ["random", "tilted", "cases"])
def test_cleared_pairs_clip_to_exact_zero(kind):
    rng = np.random.default_rng(len(kind))
    b1, b2 = _pairs(kind, rng)
    sep = separated_directions(torch.from_numpy(b1), torch.from_numpy(b2))
    assert sep.shape == (len(b1), 2) and sep.dtype == torch.bool
    cleared = sep.all(-1).numpy()
    assert 0 < cleared.sum() < len(b1)
    port = intersection_volume_aligned(torch.from_numpy(b1),
                                       torch.from_numpy(b2)).numpy()
    with jax.disable_jit():
        ref = np.asarray(_clip_volumes(
            [jnp.asarray(b1[:, i]) for i in range(9)],
            [jnp.asarray(b2[:, i]) for i in range(9)]))
    assert (port[cleared] == 0).all()
    assert (ref[cleared] == 0).all()
    # the test is conservative: overlapping pairs are never cleared
    assert not cleared[port > 1e-6].any()


@pytest.mark.parametrize("kind", ["one-way", "dense", "random"])
def test_one_way_cleared_faces_add_exact_zero(kind):
    """On pairs cleared in one direction only, the cleared box's six face
    volumes are exactly +0.0 and the pair's volume, summed in row order
    without them, is the same float bit for bit."""
    b1, b2 = (torch.from_numpy(x) for x in _aligned_pairs(
        kind, 2000, np.random.default_rng(11)))
    sep = separated_directions(b1, b2)
    one = sep.any(-1) & ~sep.all(-1)
    assert int(one.sum()) >= {"one-way": 2000, "dense": 1,
                              "random": 20}[kind]
    b1, b2, sep = b1[one], b2[one], sep[one]
    rows = _face_volumes(b1, b2)
    cleared = torch.cat([sep[:, :1].expand(-1, 6),
                         sep[:, 1:].expand(-1, 6)], dim=1).t()
    assert bool((rows[cleared] == 0).all())
    assert not bool(torch.signbit(rows[cleared]).any())
    kept = torch.zeros_like(rows[0])
    for row in range(12):
        kept = torch.where(cleared[row], kept, kept + rows[row])
    vol = intersection_volume_aligned(b1, b2)
    assert torch.equal(kept.view(torch.int32), vol.view(torch.int32))


def test_clip_work_counts_the_live_rings():
    """``clip_work`` counts what the clip of the open directions needs: a
    small upright box inside a large one keeps its 4 corners through all
    6 planes on each of its 6 faces (144 live vertices, no crossing, 12
    fan triangles); the large box's faces, marked cleared, and pairs
    cleared both ways count nothing."""
    small = torch.tensor([[0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    large = torch.tensor([[0.0, 0.0, 0.0, 4.0, 4.0, 4.0, 0.0, 0.0, 0.0]])
    assert not separated_directions(small, large).any()
    got = clip_work(small, large, torch.tensor([[False, True]]))
    assert got == {"directions": 1, "slots": 144, "crossings": 0,
                   "triangles": 12}
    got = clip_work(small.repeat(3, 1), large.repeat(3, 1),
                    torch.tensor([[False, True], [True, True],
                                  [False, True]]))
    assert got == {"directions": 2, "slots": 288, "crossings": 0,
                   "triangles": 24}
    assert clip_work(small, large, torch.ones((1, 2), dtype=torch.bool)) \
        == {"directions": 0, "slots": 0, "crossings": 0, "triangles": 0}


def test_margin_decides_a_face_gap():
    """Upright boxes whose faces are 1.2 mm apart are cleared both ways,
    0.8 mm apart (inside the margin) in neither; touching boxes in
    neither."""
    box = np.array([3.0, 4.0, 0.2, 0.8, 0.6, 12.0, 0, 0, 0], np.float32)
    gaps = (1.2e-3, 0.8e-3, 0.0)
    b2 = np.stack([box + np.eye(9, dtype=np.float32)[0] * (box[3] + g)
                   for g in gaps])
    b1 = np.stack([box] * len(gaps))
    sep = separated_directions(torch.from_numpy(b1), torch.from_numpy(b2))
    assert SEPARATION_MARGIN == 1e-3
    assert sep.tolist() == [[True, True], [False, False], [False, False]]


def test_no_pairs():
    empty = torch.zeros((0, 9))
    assert separated_directions(empty, empty).shape == (0, 2)


def _unpack_subm(packed, c, co):
    """(27, c, co) from kernel_weights' (ceil(C/16), 27, np, 16)."""
    w = np.zeros((27, c, co), np.float32)
    for ch in range(packed.shape[0]):
        for k in range(16):
            if ch * 16 + k < c:
                w[:, ch * 16 + k, :] = packed[ch, :, :co, k]
    return w


@pytest.mark.parametrize("c,co,np_", [(20, 20, 24), (20, 32, 32),
                                      (32, 64, 64), (3, 7, 24),
                                      (12, 24, 24)])
def test_k8_weight_packings_unpack_to_the_weights(c, co, np_):
    rng = np.random.default_rng(c * 100 + co)
    subm = torch.from_numpy(rng.normal(0, 1, (3, 3, 3, c, co)).astype(
        np.float32)).to(torch.bfloat16)
    down = torch.from_numpy(rng.normal(0, 1, (3, co, co)).astype(
        np.float32)).to(torch.bfloat16)
    ws, width = kernel_weights(subm.reshape(27, c, co))
    assert width == np_ and ws.is_contiguous()
    assert tuple(ws.shape) == (-(-c // 16), 27, np_, 16)
    got = ws.float().numpy()
    np.testing.assert_array_equal(_unpack_subm(got, c, co),
                                  subm.reshape(27, c, co).float().numpy())
    # zero beyond C and Co
    assert not got[:, :, co:].any()
    if c % 16:
        assert not got[-1, :, :, c % 16:].any()

    wd = down_weights(down, np_)
    kd = -(-np_ // 16) * 16
    assert wd.dtype == torch.bfloat16 and wd.is_contiguous()
    assert tuple(wd.shape) == (3, np_, kd)
    got = wd.float().numpy()
    for t in range(3):
        for n in range(co):
            np.testing.assert_array_equal(got[t, n, :co],
                                          down[t, :, n].float().numpy())
    assert not got[:, co:].any() and not got[:, :, co:].any()


def test_fused_stage_takes_at_most_32_input_channels():
    """The JAX gate's widths, which the bf16 kernel's resident weights
    need: C = 33 is refused on every device."""
    x = torch.zeros((1, 4, 8, 8, 33))
    vec = torch.zeros((20,))
    with pytest.raises(ValueError, match="input"):
        fused_stage(x, torch.zeros((1, 4, 8, 8)),
                    torch.zeros((3, 3, 3, 33, 20)), torch.zeros((3, 20, 20)),
                    vec, vec, vec, vec)
