"""Post-sort voxel scan: run index and in-run rank of sorted cell ids.

Port of the JAX package's ``ops/voxel_scan.py::postsort_scan`` (kernel K1).
The wrapper calls the custom operator ``od3d::postsort_scan``
(``ops/custom_ops.py``): on a CUDA tensor it launches the hand-written
kernel in ``csrc/voxel_scan.cu`` (:func:`scan_kernel`: a reduce and a
scan launch over tiles of each row, counted as one call); on a CPU tensor
it runs the plain version below, the cumsum + cummax formulation of the
JAX package's XLA tail (``ops/voxelize.py::voxelize_points``).  A CUDA
tensor never takes the plain version.
"""

import ctypes

import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3


def postsort_scan_plain(cell_s, sentinel):
    """Plain PyTorch version of :func:`postsort_scan` (same outputs at
    every point, sentinel points included)."""
    b, p = cell_s.shape
    idx = torch.arange(p, dtype=torch.int32, device=cell_s.device)
    prev = torch.cat([cell_s[:, :1], cell_s[:, :-1]], dim=1)
    first = (((cell_s != prev) | (idx == 0)) & (cell_s < sentinel))
    vox = torch.cumsum(first.to(torch.int32), dim=1, dtype=torch.int32) - 1
    start = torch.cummax(torch.where(first, idx, 0), dim=1).values
    return vox.to(torch.int32), (idx - start).to(torch.int32)


def postsort_scan(cell_s, sentinel):
    """Run indices + in-run ranks of sorted cell ids.

    Args:
        cell_s: (B, P) int32 cell ids, nondecreasing per row; ids >=
            ``sentinel`` mark out-of-range points (sorted to the end).
        sentinel: int sentinel value.
    Returns:
        vox: (B, P) int32 — 0-based run index per point, restarting at
            every row,
        rank: (B, P) int32 — position inside the run.
        Both are defined at sentinel points too (the run count so far and
        the distance to the last run start); callers mask them with
        ``cell_s < sentinel``.
    """
    if cell_s.dim() != 2 or cell_s.dtype != torch.int32:
        raise ValueError(f"cell_s must be (B, P) int32, got "
                         f"{tuple(cell_s.shape)} {cell_s.dtype}")
    if cell_s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cell_s.device}")
    if cell_s.device.type == "cuda" and not cell_s.is_contiguous():
        raise ValueError("cell_s must be contiguous")
    return torch.ops.od3d.postsort_scan(cell_s, int(sentinel))


def scan_kernel(cell_s, sentinel):
    """Launch K1 on a contiguous (B, P) int32 CUDA tensor."""
    b, p = cell_s.shape
    tiles = -(-p // cuda_lib.load("voxel_scan").postsort_scan_tile())
    vox = torch.empty_like(cell_s)
    rank = torch.empty_like(cell_s)
    # each tile's (run starts, latest start), written by the kernel's
    # reduce launch before its scan launch reads it
    agg = torch.empty((b, max(tiles, 1), 2), dtype=torch.int32,
                      device=cell_s.device)
    cuda_lib.launch("voxel_scan", "postsort_scan", _ARGTYPES,
                    (cell_s.data_ptr(), vox.data_ptr(), rank.data_ptr(),
                     agg.data_ptr(), b, p, int(sentinel)), cell_s.device)
    postsort_scan.launches += 1
    return vox, rank


postsort_scan.launches = 0
