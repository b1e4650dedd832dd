"""The kernels of predict as PyTorch custom operators (``torch.ops.od3d``).

Each operator has a CPU implementation, the kernel's plain PyTorch
version, and a CUDA implementation, the launch of the hand-written kernel
(counted in its wrapper's ``launches``, as before).  A CUDA tensor never
takes the plain version: a build or launch failure raises.  Each also has
a fake implementation that gives its static output shapes and dtypes, so
``torch.export`` traces predict through the operators without running
them, and the exported program calls them by name
(``serving.load_serving`` imports this module and nothing of the model).

=============================  =====  =====================================
operator                       #      gradient
=============================  =====  =====================================
``postsort_scan``              K1     none (int32 outputs)
``scatter_to_grid``            K2     the row gather of the grid's cotangent
``subm_conv3d``                K10    none (the encoder's eval mode only)
``conv2d_3x3``                 K9     dx: ``conv2d_3x3_dx`` (the kernel on
                                      the flipped, transposed taps); dw: the
                                      9 contractions in ``torch.matmul``
``fused_stage``                K8     none (the encoder's eval mode only)
``masked_affine_relu``         K11    none (the encoder's eval mode only)
=============================  =====  =====================================

The public wrappers (``ops/voxel_scan.postsort_scan`` and the others)
check their arguments and call these operators; callers use the
wrappers.  The training path's kernels (K3-K7) stay plain wrappers: no
predict reaches them.
"""

import torch
from torch import Tensor

from objectdetection_3d_tpu_torch.ops import (
    fused_stage as _k8,
    grid_scatter as _k2,
    masked_norm as _k11,
    pallas_conv as _k10,
    voxel_scan as _k1,
    zfold_conv as _k9,
)


# K1 ------------------------------------------------------------------------
@torch.library.custom_op("od3d::postsort_scan", mutates_args=(),
                         device_types="cpu")
def postsort_scan(cell_s: Tensor, sentinel: int) -> tuple[Tensor, Tensor]:
    return _k1.postsort_scan_plain(cell_s, sentinel)


postsort_scan.register_kernel("cuda")(_k1.scan_kernel)


@postsort_scan.register_fake
def _(cell_s, sentinel):
    return torch.empty_like(cell_s), torch.empty_like(cell_s)


# K2 ------------------------------------------------------------------------
@torch.library.custom_op("od3d::scatter_to_grid", mutates_args=(),
                         device_types="cpu")
def scatter_to_grid(feats: Tensor, cell_flat: Tensor,
                    grid_dhw: list[int]) -> Tensor:
    return _k2.scatter_to_grid_plain(feats, cell_flat, grid_dhw)


scatter_to_grid.register_kernel("cuda")(_k2.scatter_kernel)


@scatter_to_grid.register_fake
def _(feats, cell_flat, grid_dhw):
    b, _, c = feats.shape
    return feats.new_empty((b, *grid_dhw, c))


def _scatter_setup(ctx, inputs, output):
    _, cell_flat, grid_dhw = inputs
    ctx.save_for_backward(cell_flat)
    ctx.grid_dhw = tuple(grid_dhw)


def _scatter_backward(ctx, grid_ct):
    (cell_flat,) = ctx.saved_tensors
    return _k2.gather_rows(grid_ct, cell_flat, ctx.grid_dhw), None, None


scatter_to_grid.register_autograd(_scatter_backward,
                                  setup_context=_scatter_setup)


# K10 -----------------------------------------------------------------------
@torch.library.custom_op("od3d::subm_conv3d", mutates_args=(),
                         device_types="cpu")
def subm_conv3d(x: Tensor, kernel: Tensor) -> Tensor:
    return _k10.subm_conv3d_plain(x, kernel)


subm_conv3d.register_kernel("cuda")(_k10.subm_kernel)


@subm_conv3d.register_fake
def _(x, kernel):
    return x.new_empty((*x.shape[:4], kernel.shape[-1]))


# K9 ------------------------------------------------------------------------
@torch.library.custom_op("od3d::conv2d_3x3", mutates_args=(),
                         device_types="cpu")
def conv2d_3x3(x: Tensor, w: Tensor) -> Tensor:
    return _k9.conv2d_3x3_plain(x, w)


@conv2d_3x3.register_kernel("cuda")
def _(x, w):
    return _k9.conv_kernel(x, w, "launches")


@conv2d_3x3.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:3], w.shape[-1]))


@torch.library.custom_op("od3d::conv2d_3x3_dx", mutates_args=(),
                         device_types="cpu")
def conv2d_3x3_dx(g: Tensor, w: Tensor) -> Tensor:
    """K9's input gradient: the conv of the cotangent ``g`` (N, H, W, Co)
    with tap (2-dy, 2-dx) of ``w`` and its channels swapped."""
    return _k9.conv2d_3x3_plain(g, _k9.dx_weights(w))


@conv2d_3x3_dx.register_kernel("cuda")
def _(g, w):
    return _k9.conv_kernel(g, _k9.dx_weights(w), "dx_launches")


@conv2d_3x3_dx.register_fake
def _(g, w):
    return g.new_empty((*g.shape[:3], w.shape[2]))


def _conv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _conv_backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.to(x.dtype)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = conv2d_3x3_dx(g, w)
    if ctx.needs_input_grad[1]:
        dw = _k9.weight_grad(x, g)
    return dx, dw


conv2d_3x3.register_autograd(_conv_backward, setup_context=_conv_setup)


# K8 ------------------------------------------------------------------------
@torch.library.custom_op("od3d::fused_stage", mutates_args=(),
                         device_types="cpu")
def fused_stage(x: Tensor, mask: Tensor, subm_w: Tensor, down_w: Tensor,
                a_s: Tensor, b_s: Tensor, a_d: Tensor, b_d: Tensor) -> Tensor:
    return _k8.fused_stage_plain(x, mask, subm_w, down_w, a_s, b_s, a_d, b_d)


fused_stage.register_kernel("cuda")(_k8.stage_kernel)


@fused_stage.register_fake
def _(x, mask, subm_w, down_w, a_s, b_s, a_d, b_d):
    b, d, h, w, _ = x.shape
    return x.new_empty((b, (d - 3) // 2 + 1, h, w, subm_w.shape[-1]))


# K11 -----------------------------------------------------------------------
@torch.library.custom_op("od3d::masked_affine_relu", mutates_args=(),
                         device_types="cpu")
def masked_affine_relu(x: Tensor, mask: Tensor, a: Tensor,
                       b: Tensor) -> Tensor:
    return _k11.masked_affine_relu_plain(x, mask, a, b)


masked_affine_relu.register_kernel("cuda")(_k11.norm_kernel)


@masked_affine_relu.register_fake
def _(x, mask, a, b):
    return x.new_empty(x.shape)
