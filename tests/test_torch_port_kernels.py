"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its XLA tails.

The CUDA kernels themselves run only on a card:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` hold them against
these plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetection_3d_tpu.ops.grid_scatter import (
    scatter_to_grid as jax_scatter_to_grid,
)
from objectdetection_3d_tpu.ops.voxel_scan import (
    postsort_scan as jax_postsort_scan,
)
from objectdetection_3d_tpu.ops.voxelize import Voxelizer as JaxVoxelizer
from objectdetection_3d_tpu_torch.ops.grid_scatter import (
    scatter_to_grid,
    scatter_to_grid_plain,
)
from objectdetection_3d_tpu_torch.ops.voxel_scan import (
    postsort_scan,
    postsort_scan_plain,
)
from objectdetection_3d_tpu_torch.ops.voxelize import Voxelizer

torch.set_num_threads(1)

SENTINEL = 5000


def _scan_rows(p=8192, seed=0):
    """Three sorted rows: a normal one, one that begins with the previous
    row's last valid cell, and one with no valid point."""
    rng = np.random.default_rng(seed)
    row0 = np.sort(rng.integers(0, SENTINEL, 6000))
    row0 = np.concatenate([row0, np.full(p - 6000, SENTINEL)])
    row1 = np.sort(rng.integers(row0[5999], SENTINEL, 7000))
    row1[:3] = row0[5999]
    row1 = np.concatenate([row1, np.full(p - 7000, SENTINEL + 7)])
    row2 = np.full(p, SENTINEL)
    return np.stack([row0, row1, row2]).astype(np.int32)


def test_postsort_scan_plain_matches_pallas_interpret():
    cells = _scan_rows()
    jv, jr = jax_postsort_scan(jnp.asarray(cells), SENTINEL, interpret=True)
    tv, tr = postsort_scan(torch.from_numpy(cells), SENTINEL)
    assert tv.dtype == tr.dtype == torch.int32
    valid = cells < SENTINEL
    assert valid[1, 0] and cells[1, 0] == cells[0, valid[0]].max()
    np.testing.assert_array_equal(tv.numpy()[valid], np.asarray(jv)[valid])
    np.testing.assert_array_equal(tr.numpy()[valid], np.asarray(jr)[valid])
    # runs restart at every row
    assert tv[1, 0] == 0 and tr[1, 0] == 0


def _chained_rows(case, p=8192, seed=2):
    """B > 1 rows for the tiled scan's row restarts.  "chained": four rows
    with no sentinel, each starting with the previous row's last id (and
    long runs across the 2048-id tiles of the card's kernel); "sentinel":
    an all-sentinel row between two rows, the second starting with the
    id the first ends with."""
    rng = np.random.default_rng(seed)
    rows, last = [], 0
    for r in range(4 if case == "chained" else 3):
        if case == "sentinel" and r == 1:
            rows.append(np.full(p, SENTINEL))
            continue
        # runs of about 10 ids, some of them across 2048-id tiles
        steps = (rng.random(p) < 0.1).astype(np.int64)
        steps[0] = 0
        rows.append(last + np.cumsum(steps))
        last = int(rows[-1][-1])
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("case", ["chained", "sentinel"])
def test_postsort_scan_rows_restart_matches_pallas_interpret(case):
    cells = _chained_rows(case)
    b = cells.shape[0]
    jv, jr = jax_postsort_scan(jnp.asarray(cells), SENTINEL, interpret=True)
    tv, tr = postsort_scan(torch.from_numpy(cells), SENTINEL)
    valid = cells < SENTINEL
    for r in range(1, b):
        if valid[r - 1].all() and valid[r, 0]:
            assert cells[r, 0] == cells[r - 1, -1]
    np.testing.assert_array_equal(tv.numpy()[valid], np.asarray(jv)[valid])
    np.testing.assert_array_equal(tr.numpy()[valid], np.asarray(jr)[valid])
    for r in range(b):
        if valid[r].any():
            assert tv[r, 0] == 0 and tr[r, 0] == 0
        else:                           # an all-sentinel row: no run
            assert (tv[r] == -1).all()
            assert torch.equal(tr[r], torch.arange(cells.shape[1],
                                                   dtype=torch.int32))


def test_postsort_scan_defines_sentinel_points():
    """Both versions give every point a value: the run count so far and
    the distance to the last run start (0 if none)."""
    cells = torch.tensor([[3, 3, 9, SENTINEL, SENTINEL],
                          [SENTINEL] * 5], dtype=torch.int32)
    vox, rank = postsort_scan_plain(cells, SENTINEL)
    assert vox.tolist() == [[0, 0, 1, 1, 1], [-1, -1, -1, -1, -1]]
    assert rank.tolist() == [[0, 1, 0, 1, 2], [0, 1, 2, 3, 4]]


def test_postsort_scan_cpu_tensor_takes_plain_version():
    cells = torch.from_numpy(_scan_rows(seed=1)[:, ::128].copy())
    before = postsort_scan.launches
    got = postsort_scan(cells, SENTINEL)
    want = postsort_scan_plain(cells, SENTINEL)
    assert postsort_scan.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        postsort_scan(cells.long(), SENTINEL)


@pytest.mark.parametrize("pallas", ["off", "interpret"])
def test_voxelizer_matches_jax_points_batch(pallas):
    """Port voxelizer (plain scan) against the JAX XLA tail ("off") and
    the Pallas scan ("interpret"); P % 4096 == 0 for the kernel."""
    rng = np.random.default_rng(3)
    b, p = 2, 8192
    pts = np.zeros((b, p, 4), np.float32)
    n = np.array([6000, 8192], np.int32)
    for i in range(b):
        pts[i, :n[i], :3] = rng.uniform([-1, -1, -1], [9, 9, 5], (n[i], 3))
        pts[i, :n[i], 3] = rng.integers(0, 5, n[i]) / 4.0
    kw = dict(voxel_size=(0.5, 0.5, 1.0),
              point_cloud_range=(0.0, 0.0, 0.0, 8.0, 8.0, 4.0),
              max_voxel_points=8, max_voxels=512)
    want = JaxVoxelizer(**kw).points_batch(jnp.asarray(pts), jnp.asarray(n),
                                           pallas=pallas)
    got = Voxelizer(**kw).points_batch(torch.from_numpy(pts),
                                       torch.from_numpy(n))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def _grid_case(rng, d, h, w, c, v, n_active):
    cells = np.sort(rng.choice(d * h * w, n_active,
                               replace=False)).astype(np.int32)
    cell_flat = np.concatenate(
        [cells, np.full(v - n_active, d * h * w, np.int32)])
    feats = rng.normal(0, 1, (v, c)).astype(np.float32)
    return cell_flat, feats


@pytest.mark.parametrize("shape", [(4, 16, 16, 8, 64, 40),
                                   (3, 16, 8, 4, 32, 20),
                                   (2, 8, 16, 16, 16, 16),
                                   (2, 8, 8, 4, 16, 0)])
def test_scatter_to_grid_matches_pallas_interpret(shape):
    d, h, w, c, v, na = shape
    rng = np.random.default_rng(int(np.sum(shape)))
    cell_flat, feats = _grid_case(rng, d, h, w, c, v, na)
    want = np.asarray(jax_scatter_to_grid(
        jnp.asarray(feats), jnp.asarray(cell_flat), (d, h, w), True))
    got = scatter_to_grid(torch.from_numpy(feats),
                          torch.from_numpy(cell_flat), (d, h, w))
    assert got.shape == (d, h, w, c)
    np.testing.assert_array_equal(got.numpy(), want)
    if na == 0:
        assert not want.any()


def test_scatter_to_grid_batched_is_per_item():
    rng = np.random.default_rng(11)
    d, h, w, c, v = 3, 8, 8, 4, 32
    items = [_grid_case(rng, d, h, w, c, v, na) for na in (20, 0, 32)]
    cells = torch.from_numpy(np.stack([i[0] for i in items]))
    feats = torch.from_numpy(np.stack([i[1] for i in items]))
    before = scatter_to_grid.launches
    got = scatter_to_grid(feats.to(torch.bfloat16), cells, (d, h, w))
    assert scatter_to_grid.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (3, d, h, w, c)
    for i in range(3):
        one = scatter_to_grid_plain(feats[i:i + 1].to(torch.bfloat16),
                                    cells[i:i + 1], (d, h, w))[0]
        assert torch.equal(got[i], one)
    with pytest.raises(ValueError):
        scatter_to_grid(feats.double(), cells, (d, h, w))
