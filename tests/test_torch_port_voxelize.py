"""The port's voxelizer against the JAX package's ``voxelize_points``:
every output exact, the sorted points bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetection_3d_tpu.ops.voxelize import (
    voxelize_points as jax_voxelize_points,
)
from objectdetection_3d_tpu_torch.ops.voxelize import (
    cells_sorted,
    voxelize_points,
)

torch.set_num_threads(1)

KW = dict(voxel_size=(0.5, 0.5, 1.0),
          point_cloud_range=(0.0, 0.0, 0.0, 8.0, 8.0, 4.0))


def _cloud(seed, p, n, levels):
    """``n`` valid points of ``p``; reflectance quantized to ``levels``
    values (many exact ties), a share of points out of range, clusters
    that overflow the per-voxel cap."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((p, 4), np.float32)
    spread = rng.uniform([-1, -1, -0.5], [9, 9, 4.5], (n, 3))
    clustered = rng.uniform([2, 2, 1], [2.4, 2.4, 1.8], (n // 4, 3))
    pts[:n, :3] = np.concatenate([spread[:n - n // 4], clustered])
    pts[:n, 3] = rng.integers(0, levels, n) / max(levels - 1, 1)
    return pts


@pytest.mark.parametrize("seed,p,n,levels,m,v,refl", [
    (0, 2048, 1500, 3, 8, 256, True),
    (1, 2048, 2048, 1, 4, 64, True),      # every reflectance tied
    (2, 1024, 700, 5, 8, 512, False),
    (3, 1024, 0, 2, 8, 128, True),        # no valid point at all
])
def test_voxelize_points_exact(seed, p, n, levels, m, v, refl):
    pts = _cloud(seed, p, n, levels)
    kw = dict(KW, max_points_per_voxel=m, max_voxels=v,
              reflectance_sampling=refl)
    want = jax_voxelize_points(jnp.asarray(pts), n, **kw)
    got = voxelize_points(torch.from_numpy(pts), n, **kw)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.dtype == w.dtype, key
        assert g.shape == w.shape, key
        if key == "points":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_non_finite_points_are_out_of_range():
    """A NaN or infinite coordinate drops the point.  (The JAX package
    converts a NaN x to cell 0 and keeps the point: ROADMAP queue C.)
    The port's result equals the JAX package's on the same cloud with
    those points moved out of range."""
    pts = _cloud(4, 1024, 900, 3)
    bad = np.array([3, 10, 11, 500])
    pts[bad[0], 0] = np.nan
    pts[bad[1], 1] = np.inf
    pts[bad[2], 2] = -np.inf
    pts[bad[3], :3] = np.nan
    kw = dict(KW, max_points_per_voxel=8, max_voxels=256)
    got = voxelize_points(torch.from_numpy(pts), 900, **kw)
    moved = pts.copy()
    moved[bad, :3] = -100.0
    want = jax_voxelize_points(jnp.asarray(moved), 900, **kw)
    for key in want:
        if key == "points":   # the moved rows differ, in the same places
            g = got[key].numpy()
            w = np.asarray(want[key])
            same = (g == w).all(axis=1)
            assert (~same).sum() == len(bad)
            assert (w[~same, :3] == -100.0).all()
        else:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)


def test_sort_order_is_cell_then_reflectance_then_index():
    # two points in one cell with equal reflectance keep input order;
    # higher reflectance goes first; out-of-range points go last
    pts = torch.tensor([[[0.1, 0.1, 0.1, 0.2],
                         [0.2, 0.2, 0.2, 0.9],
                         [-1.0, 0.0, 0.0, 1.0],
                         [0.3, 0.3, 0.3, 0.2],
                         [7.9, 7.9, 3.9, 0.5]]], dtype=torch.float32)
    cell, pts_s = cells_sorted(pts, torch.tensor([5]), **KW)
    assert cell[0].tolist() == [0, 0, 0, 1023, 1024]
    assert pts_s[0, :, 3].tolist() == pytest.approx([0.9, 0.2, 0.2, 0.5,
                                                     1.0])
    assert pts_s[0, 1, 0].item() == pytest.approx(0.1)


@pytest.mark.parametrize("voxel_size", [(0.5, 0.5, 1.0), (0.1, 0.1, 0.25)])
def test_sentinel_rows_add_no_voxel(voxel_size):
    """The tiled device crop pads tiles with rows of 1e9 in every column.
    Their cell index (2e9 at 0.5 m, 1e10 at the flagship's 0.1 m: past
    int32) must land out of range, so the voxels of a cloud are the same
    with sentinel rows mixed in as without them."""
    kw = dict(voxel_size=voxel_size,
              point_cloud_range=(0.0, 0.0, 0.0, 8.0, 8.0, 4.0),
              max_points_per_voxel=8, max_voxels=1024)
    cloud = _cloud(5, 1500, 1500, 7)
    n_sent = 600
    rows = np.concatenate([cloud, np.full((n_sent, 4), 1e9, np.float32)])
    mixed = rows[np.random.default_rng(0).permutation(len(rows))]
    want = voxelize_points(torch.from_numpy(cloud), 1500, **kw)
    got = voxelize_points(torch.from_numpy(mixed), len(mixed), **kw)
    assert int(want["num_voxels"]) > 0
    for key in ("coords", "num_points_per_voxel", "num_voxels",
                "voxel_mask"):
        assert torch.equal(got[key], want[key]), key
    assert int(got["pt_valid"].sum()) == int(want["pt_valid"].sum())
    # every sentinel row is dropped
    sent = (got["points"] == 1e9).all(dim=-1)
    assert int(sent.sum()) == n_sent
    assert not bool(got["pt_valid"][sent].any())
    assert bool((got["pt_voxel"][sent] == kw["max_voxels"]).all())
