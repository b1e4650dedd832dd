"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: without a CUDA device (or without nvcc) every test skips
with its reason.  On the card:

    python -m pytest --noconftest -m cuda -q tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port.)
"""

import shutil

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch.ops.grid_scatter import (
    scatter_to_grid,
    scatter_to_grid_plain,
)
from objectdetection_3d_tpu_torch.ops.voxel_scan import (
    postsort_scan,
    postsort_scan_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None and shutil.which("nvcc") is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _sorted_rows(rng, b, p, sentinel, n_valid):
    rows = []
    for n in n_valid:
        r = np.sort(rng.integers(0, sentinel, n))
        rows.append(np.concatenate([r, np.full(p - n, sentinel)]))
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("b,p", [(1, 131072), (3, 5000), (2, 1), (4, 4097)])
def test_postsort_scan_kernel_matches_plain(cuda, b, p):
    rng = np.random.default_rng(p)
    sentinel = 997
    n_valid = [int(rng.integers(0, p + 1)) for _ in range(b)]
    n_valid[0] = p
    cells = torch.from_numpy(_sorted_rows(rng, b, p, sentinel, n_valid))
    cells = cells.to(cuda)
    before = postsort_scan.launches
    vox, rank = postsort_scan(cells, sentinel)
    torch.cuda.synchronize()
    assert postsort_scan.launches == before + 1
    want_vox, want_rank = postsort_scan_plain(cells, sentinel)
    assert torch.equal(vox, want_vox)
    assert torch.equal(rank, want_rank)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 100, 40, 40, 20, 4096, 3000),
                                   (3, 3, 7, 5, 3, 40, 17),
                                   (2, 2, 8, 8, 4, 16, 0)])
def test_scatter_to_grid_kernel_matches_plain(cuda, dtype, shape):
    b, d, h, w, c, v, na = shape
    rng = np.random.default_rng(sum(shape))
    n = d * h * w
    ids = np.full((b, v), n, np.int32)
    for i in range(b):
        ids[i, :na] = np.sort(rng.choice(n, na, replace=False))
    feats = torch.from_numpy(rng.normal(0, 1, (b, v, c)).astype(np.float32))
    feats = feats.to(cuda, dtype)
    ids = torch.from_numpy(ids).to(cuda)
    before = scatter_to_grid.launches
    got = scatter_to_grid(feats, ids, (d, h, w))
    torch.cuda.synchronize()
    assert scatter_to_grid.launches == before + 1
    assert torch.equal(got, scatter_to_grid_plain(feats, ids, (d, h, w)))
    one = scatter_to_grid(feats[0], ids[0], (d, h, w))
    assert torch.equal(one, got[0])


def test_kernel_wrappers_reject_bad_input(cuda):
    cells = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        postsort_scan(cells.t(), 5)
    feats = torch.zeros((8, 4), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        scatter_to_grid(feats, cells[0], (2, 2, 2))
