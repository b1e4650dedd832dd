"""Dense pseudo-image grid build.

Port of the JAX package's ``ops/grid_scatter.py::scatter_to_grid``
(kernel K2).  The wrapper calls the custom operator
``od3d::scatter_to_grid`` (``ops/custom_ops.py``): on a CUDA tensor it
launches the hand-written kernels in ``csrc/grid_scatter.cu``
(:func:`scatter_kernel`): a streaming zero fill of the grid, then a copy
of the voxel rows over it.  On a CPU tensor it runs the plain version
below, a zero-fill followed by an index copy (the JAX package's XLA
scatter, ``models/network.py``).  A CUDA tensor never takes the plain
version.

The gradient (the operator's registered autograd) is that of the JAX
package's custom VJP: a row gather of the grid's cotangent at the voxel
cells, zero for padding rows (:func:`gather_rows`).  It is an XLA gather
there, not a kernel, and plain PyTorch indexing here.

The activity mask is not an output: callers build it with a plain scatter,
as the JAX package does.
"""

import ctypes

import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int]
_DTYPES = (torch.bfloat16, torch.float32)


def scatter_to_grid_plain(feats, cell_flat, grid_dhw):
    """Plain PyTorch version of :func:`scatter_to_grid` on (B, V, C)
    features and (B, V) ids."""
    d, h, w = grid_dhw
    b, v, c = feats.shape
    n = d * h * w
    grid = torch.zeros((b, n, c), dtype=feats.dtype, device=feats.device)
    valid = cell_flat < n
    rows = torch.arange(b, device=feats.device)[:, None].expand(b, v)
    grid[rows[valid], cell_flat[valid].long()] = feats[valid]
    return grid.view(b, d, h, w, c)


def scatter_kernel(feats, cell_flat, grid_dhw):
    """Launch K2 on (B, V, C) CUDA features; returns (B, D, H, W, C)."""
    feats, cell_flat = feats.contiguous(), cell_flat.contiguous()
    d, h, w = (int(s) for s in grid_dhw)
    b, v, c = feats.shape
    grid = torch.empty((b, d, h, w, c), dtype=feats.dtype,
                       device=feats.device)
    cuda_lib.launch("grid_scatter", "scatter_to_grid", _ARGTYPES,
                    (feats.data_ptr(), cell_flat.data_ptr(), grid.data_ptr(),
                     b, v, c, d * h * w, feats.element_size()), feats.device)
    scatter_to_grid.launches += 1
    return grid


def gather_rows(grid_ct, cell_flat, grid_dhw):
    """The gradient of :func:`scatter_to_grid` in ``feats``: the rows of
    the (B, D, H, W, C) cotangent at the (B, V) cells, zero for padding
    rows."""
    d, h, w = grid_dhw
    n = d * h * w
    b, v = cell_flat.shape
    flat_ct = grid_ct.reshape(b, n, -1)
    valid = cell_flat < n
    idx = torch.where(valid, cell_flat, 0).long()
    rows = torch.arange(b, device=idx.device)[:, None].expand(b, v)
    return flat_ct[rows, idx] * valid[..., None].to(grid_ct.dtype)


def scatter_to_grid(feats, cell_flat, grid_dhw):
    """Build the dense (D, H, W, C) pseudo-image grid (differentiable in
    ``feats``).

    Args:
        feats: (V, C) or (B, V, C) voxel features, bfloat16 or float32;
            rows of padding voxels are ignored.
        cell_flat: (V,) or (B, V) int32 flat cell ids in (z, y, x) raster
            order, SORTED ascending per row, unique below ``D*H*W``;
            padding rows carry ``D*H*W`` or larger.
        grid_dhw: (D, H, W).
    Returns:
        (D, H, W, C) or (B, D, H, W, C) grid in feats.dtype.
    """
    single = feats.dim() == 2
    if single:
        feats, cell_flat = feats[None], cell_flat[None]
    if feats.dim() != 3 or cell_flat.shape != feats.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)} and cell_flat "
                         f"{tuple(cell_flat.shape)} do not match")
    if feats.dtype not in _DTYPES or cell_flat.dtype != torch.int32:
        raise ValueError(f"feats must be bf16/f32 and cell_flat int32, got "
                         f"{feats.dtype} / {cell_flat.dtype}")
    if feats.device != cell_flat.device:
        raise ValueError("feats and cell_flat lie on different devices")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    grid = torch.ops.od3d.scatter_to_grid(feats, cell_flat,
                                          [int(s) for s in grid_dhw])
    return grid[0] if single else grid


scatter_to_grid.launches = 0
