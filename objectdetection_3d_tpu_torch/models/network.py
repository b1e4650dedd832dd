"""Top-level network: voxelized points -> pseudo-image -> head.

Port of the JAX package's ``models/network.py::PointPillarsNet`` on its
point-PFN path: PillarFeatureNet -> dense grid build -> vertical encoder
(SparseMiddleExtractor) -> SubmanifoldSparseRPN -> Anchor3DHead.  Module
names follow the JAX package's flax tree (``voxel_encoder``,
``pseudoimage_generator``, ``sparse_rpn``, ``bbox_head``), so weights map
leaf to leaf (``models/weights.py``).
"""

import math

import torch
from torch import nn

from objectdetection_3d_tpu_torch.models.layers import (
    Anchor3DHead,
    MaskedBatchNorm,
    PillarFeatureNet,
    SparseMiddleExtractor,
    SubmanifoldSparseRPN,
)
from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid


class PointPillarsNet(nn.Module):
    """End-to-end PointPillars network over point-granularity voxel
    batches.  ``decompose_convs`` .. ``fused_stages`` are the vertical
    encoder's lowering knobs (``SparseMiddleExtractor``)."""

    # (h0, h1): build only the grid rows h0 <= y < h1 (a slab of H, when H
    # is split over ranks by ``parallel/data_parallel.py``); None: all
    rows = None

    def __init__(self, grid, in_channels, pfn_channels, voxel_size,
                 point_cloud_range, max_slots, middle_channels,
                 middle_in_channels, rpn_channels, rpn_layer_nums,
                 num_classes, num_anchors, box_params_num=9,
                 dtype=torch.float32, use_dense_backbone=False,
                 sparse_middle=False, decompose_convs=False,
                 pallas_subm=False, zfold_convs=False, zfold_pallas=False,
                 fused_stages=False):
        super().__init__()
        if use_dense_backbone:
            raise NotImplementedError(
                "use_dense_backbone (the SECOND backbone + FPN neck) is not "
                "ported yet")
        if sparse_middle:
            raise NotImplementedError(
                "tpu.sparse_middle (the gather-based vertical encoder) is "
                "not ported yet")
        self.grid = tuple(int(g) for g in grid)  # (D, H, W)
        self.dtype = dtype
        self.voxel_encoder = PillarFeatureNet(
            in_channels, pfn_channels, voxel_size, point_cloud_range,
            max_slots, dtype=dtype)
        if int(pfn_channels[-1]) != int(middle_in_channels):
            raise ValueError("vertical_encoder.in_channels must equal the "
                             "PFN's output width")
        self.pseudoimage_generator = SparseMiddleExtractor(
            middle_in_channels, middle_channels, dtype=dtype,
            decompose_convs=decompose_convs, pallas_subm=pallas_subm,
            zfold_convs=zfold_convs, zfold_pallas=zfold_pallas,
            fused_stages=fused_stages)
        d_out = SparseMiddleExtractor.out_depth(self.grid[0],
                                                len(middle_channels))
        self.sparse_rpn = SubmanifoldSparseRPN(
            int(middle_channels[-1]) * d_out, rpn_channels, rpn_layer_nums,
            dtype=dtype)
        self.bbox_head = Anchor3DHead(
            int(rpn_channels[-1]), num_classes, num_anchors, box_params_num,
            dtype=dtype)

    def forward(self, num_points, coords, voxel_mask, points, pt_voxel,
                pt_valid):
        """
        Args:
            num_points: (B, V) int points per voxel.
            coords: (B, V, 3) int voxel coords (z, y, x), -1 padding.
            voxel_mask: (B, V) bool voxel validity.
            points: (B, P, C) cell-sorted points.
            pt_voxel: (B, P) per-point voxel index in [0, V] (V = dump).
            pt_valid: (B, P) bool.
        Returns:
            (cls, reg, dirs): (B, H, W, A*num_classes / A*9 / A*6) float32.
        """
        d, h, w = self.grid
        b, v = num_points.shape
        dev = num_points.device
        # one extra segment per item holds the dump slot (out-of-range or
        # overflow points); segment ids stay globally nondecreasing
        nvp = v + 1
        seg = (torch.arange(b, device=dev)[:, None] * nvp
               + pt_voxel).reshape(-1)
        pad = torch.zeros((b, 1), dtype=num_points.dtype, device=dev)
        counts_p = torch.cat([num_points, pad], dim=1).reshape(-1)
        coords_p = torch.cat(
            [coords, torch.zeros((b, 1, 3), dtype=coords.dtype, device=dev)],
            dim=1).reshape(b * nvp, 3)
        mask_p = torch.cat([voxel_mask, torch.zeros_like(voxel_mask[:, :1])],
                           dim=1).reshape(-1)
        feats = self.voxel_encoder(points.reshape(b * points.shape[1], -1),
                                   seg, pt_valid.reshape(-1), counts_p,
                                   coords_p, mask_p)
        feats = feats.reshape(b, nvp, -1)[:, :v].to(self.dtype)

        # dense (z, y, x) grid; the voxelizer emits cells sorted in this
        # raster order, the grid-scatter kernel's contract.  A slab keeps
        # the voxels of its rows; the others go where the padding goes
        if self.rows is None:
            h0, inside = 0, voxel_mask
        else:
            h0, h1 = self.rows
            h = h1 - h0
            inside = (voxel_mask & (coords[..., 1] >= h0)
                      & (coords[..., 1] < h1))
        cell = ((coords[..., 0] * h + coords[..., 1] - h0) * w
                + coords[..., 2])
        cell = torch.where(inside, cell, d * h * w).to(torch.int32)
        grid = scatter_to_grid(feats.contiguous(), cell.contiguous(),
                               (d, h, w))
        # padding voxels write the extra cell d*h*w, which is cut off: no
        # shape here depends on the data
        mask = torch.zeros((b, d * h * w + 1), dtype=self.dtype, device=dev)
        mask = mask.scatter(1, cell.long(),
                            torch.ones_like(cell, dtype=self.dtype))
        mask = mask[:, :-1].reshape(b, 1, d, h, w)

        # NDHWC memory seen as NCDHW (channels_last_3d): no copy
        pseudo = self.pseudoimage_generator(grid.permute(0, 4, 1, 2, 3),
                                            mask)
        # the reference re-derives the 2D active set from nonzero pixels
        rpn_mask = (pseudo != 0).any(dim=1, keepdim=True)
        x = self.sparse_rpn(pseudo, rpn_mask)
        return self.bbox_head(x)


@torch.no_grad()
def init_parameters(net, generator):
    """Redraw every parameter of ``net`` (a ``PointPillarsNet``) from the
    CPU ``generator``, by the laws of the modules' constructors, and reset
    every batch norm's running statistics.  The global torch RNG is not
    touched.

    * batch norms: weight 1, bias 0, running mean 0, running var 1;
    * Linear / Conv2d: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
      bias (PyTorch's default);
    * the vertical encoder's kernels: N(0, 1/fan_in) (LeCun normal);
    * the head's cls and reg convs: weight N(0, 0.01^2), bias -log(99)
      and 0.
    """
    def put(p, value):
        p.copy_(value.to(device=p.device, dtype=p.dtype))

    def uniform(p, bound):
        put(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def normal(p, std):
        put(p, torch.randn(p.shape, generator=generator) * std)

    for mod in net.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            uniform(mod.weight, bound)
            if mod.bias is not None:
                uniform(mod.bias, bound)
    for _, p in net.pseudoimage_generator.named_parameters(recurse=False):
        normal(p, 1.0 / math.sqrt(p[0].numel()))
    head = net.bbox_head
    normal(head.conv_cls.weight, 0.01)
    head.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
    normal(head.conv_reg.weight, 0.01)
    head.conv_reg.bias.zero_()
