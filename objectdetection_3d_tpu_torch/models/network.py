"""Top-level network: voxels -> pseudo-image -> head.

Port of the JAX package's ``models/network.py::PointPillarsNet``: the PFN
(``PillarFeatureNet`` on the point path, ``PillarFeatureNetBuffers`` on
the (V, M, C) buffers) -> the vertical encoder (the dense grid build and
``SparseMiddleExtractor``, or ``SparseMiddleExtractorGather`` under
``sparse_middle``) -> ``SubmanifoldSparseRPN``, or the dense
``BackboneDWS`` + ``BackboneUPS`` under ``use_dense_backbone`` ->
``Anchor3DHead``.  Module names follow the JAX package's flax tree
(``voxel_encoder``, ``pseudoimage_generator``, ``sparse_rpn``,
``backbone``, ``neck``, ``bbox_head``), so weights map leaf to leaf
(``models/weights.py``).

``remat`` (the config's ``tpu.remat``) recomputes the JAX package's
``nn.remat`` regions in the backward: the dense vertical encoder
(``True``, ``"all"``, ``"middle"``) and the RPN (``True``, ``"all"``,
``"rpn"``), through ``torch.utils.checkpoint`` called inside
:meth:`PointPillarsNet.forward`, so no parameter or buffer name changes.
The grid build, the gather encoder, the dense backbone and neck and the
head are never recomputed.
"""

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from objectdetection_3d_tpu_torch.models.layers import (
    Anchor3DHead,
    BackboneDWS,
    BackboneUPS,
    MaskedBatchNorm,
    PillarFeatureNet,
    PillarFeatureNetBuffers,
    SparseMiddleExtractor,
    SubmanifoldSparseRPN,
    recomputing,
)
from objectdetection_3d_tpu_torch.models.sparse_middle import (
    SparseMiddleExtractorGather,
)
from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid
from objectdetection_3d_tpu_torch.ops.sparse_conv import flatten_cells
from objectdetection_3d_tpu_torch.profiling import span

# the values of ``tpu.remat`` and the regions each recomputes
REMAT_REGIONS = {False: (), True: ("middle", "rpn"), "all": ("middle", "rpn"),
                 "middle": ("middle",), "rpn": ("rpn",)}
# what a sharded step sets on a region's modules
# (``parallel/data_parallel.py``, ``Shard.context``)
_SHARD_HOOKS = ("stats_sum", "halo")


def parse_remat(value):
    """The ``tpu.remat`` value, or ``ValueError`` (the JAX package's
    ``_parse_remat``)."""
    if value in (False, True, "all", "middle", "rpn"):
        return value
    raise ValueError(
        f"tpu.remat must be true/false/'all'/'middle'/'rpn', got {value!r}")


@contextlib.contextmanager
def _replaying(hooks):
    """A checkpointed region's recompute: the sharded step's ``hooks``
    (module, name, value), as the forward saw them, set again (the
    backward runs after the step's context has closed, and the recompute
    must repeat the forward's collectives in the same groups), and the
    batch norms' running statistics held (``layers.recomputing``)."""
    unset = object()
    before = [(m, k, m.__dict__.get(k, unset)) for m, k, _ in hooks]
    for m, k, v in hooks:
        setattr(m, k, v)
    try:
        with recomputing():
            yield
    finally:
        for m, k, v in before:
            if v is unset:
                del m.__dict__[k]
            else:
                setattr(m, k, v)


class PointPillarsNet(nn.Module):
    """End-to-end PointPillars network over voxel batches.

    ``point_pfn``: the PFN runs at point granularity (single-layer stacks)
    and :meth:`forward` takes the points; else it runs on the (V, M, C)
    buffers and :meth:`forward` takes ``voxels``.  ``decompose_convs`` ..
    ``fused_stages`` are the dense vertical encoder's lowering knobs
    (``SparseMiddleExtractor``); ``sparse_middle`` with ``sparse_budget``
    (active sites per stage, 0 = V) runs the gather encoder instead.
    ``use_dense_backbone`` replaces the RPN by the strided backbone
    (``rpn_channels``, ``rpn_layer_nums``, ``backbone_strides``) and the
    neck (``neck_channels``, ``neck_upsample_strides``); each layer takes
    its input width from the layer before it.  ``remat``: the
    ``tpu.remat`` value (:func:`parse_remat`), the regions recomputed in
    the backward (:data:`REMAT_REGIONS`).
    """

    # (h0, h1): build only the grid rows h0 <= y < h1 (a slab of H, when H
    # is split over ranks by ``parallel/data_parallel.py``), or, after the
    # gather encoder, keep only those rows of the pseudo-image; None: all
    rows = None

    def __init__(self, grid, in_channels, pfn_channels, voxel_size,
                 point_cloud_range, max_slots, middle_channels,
                 middle_in_channels, rpn_channels, rpn_layer_nums,
                 num_classes, num_anchors, box_params_num=9,
                 dtype=torch.float32, point_pfn=True,
                 use_dense_backbone=False, backbone_strides=(2, 2, 2),
                 neck_channels=(), neck_upsample_strides=(),
                 sparse_middle=False, sparse_budget=0, decompose_convs=False,
                 pallas_subm=False, zfold_convs=False, zfold_pallas=False,
                 fused_stages=False, remat=False):
        super().__init__()
        self.grid = tuple(int(g) for g in grid)  # (D, H, W)
        self.remat_regions = REMAT_REGIONS[parse_remat(remat)]
        self.dtype = dtype
        self.point_pfn = bool(point_pfn)
        self.sparse_middle = bool(sparse_middle)
        self.use_dense_backbone = bool(use_dense_backbone)
        if self.point_pfn:
            self.voxel_encoder = PillarFeatureNet(
                in_channels, pfn_channels, voxel_size, point_cloud_range,
                max_slots, dtype=dtype)
        else:
            self.voxel_encoder = PillarFeatureNetBuffers(
                in_channels, pfn_channels, voxel_size, point_cloud_range,
                dtype=dtype)
        if int(pfn_channels[-1]) != int(middle_in_channels):
            raise ValueError("vertical_encoder.in_channels must equal the "
                             "PFN's output width")
        if self.sparse_middle:
            self.pseudoimage_generator = SparseMiddleExtractorGather(
                middle_in_channels, middle_channels, self.grid,
                budget=sparse_budget, dtype=dtype)
        else:
            self.pseudoimage_generator = SparseMiddleExtractor(
                middle_in_channels, middle_channels, dtype=dtype,
                decompose_convs=decompose_convs, pallas_subm=pallas_subm,
                zfold_convs=zfold_convs, zfold_pallas=zfold_pallas,
                fused_stages=fused_stages)
        d_out = SparseMiddleExtractor.out_depth(self.grid[0],
                                                len(middle_channels))
        pseudo_channels = int(middle_channels[-1]) * d_out
        if self.use_dense_backbone:
            if not neck_channels:
                raise ValueError("use_dense_backbone needs the neck's "
                                 "out_channels and upsample_strides")
            self.backbone = BackboneDWS(pseudo_channels, rpn_channels,
                                        rpn_layer_nums, backbone_strides,
                                        dtype=dtype)
            self.neck = BackboneUPS(rpn_channels, neck_channels,
                                    neck_upsample_strides, dtype=dtype)
            head_channels = sum(int(c) for c in neck_channels[
                :min(len(rpn_channels), len(neck_upsample_strides))])
        else:
            self.sparse_rpn = SubmanifoldSparseRPN(
                pseudo_channels, rpn_channels, rpn_layer_nums, dtype=dtype)
            head_channels = int(rpn_channels[-1])
        self.bbox_head = Anchor3DHead(
            head_channels, num_classes, num_anchors, box_params_num,
            dtype=dtype)

    def forward(self, num_points, coords, voxel_mask, points=None,
                pt_voxel=None, pt_valid=None, voxels=None):
        """
        Args:
            num_points: (B, V) int points per voxel.
            coords: (B, V, 3) int voxel coords (z, y, x), -1 padding.
            voxel_mask: (B, V) bool voxel validity.
            points: (B, P, C) cell-sorted points (point path).
            pt_voxel: (B, P) per-point voxel index in [0, V] (V = dump).
            pt_valid: (B, P) bool.
            voxels: (B, V, M, C) per-voxel point buffers (buffer path).
        Returns:
            (cls, reg, dirs): (B, H', W', A*num_classes / A*9 / A*6)
            float32; (H', W') is the grid's (H, W), or the neck's.
        """
        b, v = num_points.shape
        with span("predict.pfn_grid"):
            if self.point_pfn:
                feats = self._point_feats(num_points, coords, voxel_mask,
                                          points, pt_voxel, pt_valid)
            else:
                m, c = voxels.shape[2:]
                feats = self.voxel_encoder(
                    voxels.reshape(b * v, m, c), num_points.reshape(b * v),
                    coords.reshape(b * v, 3), voxel_mask.reshape(b * v))
            feats = feats.reshape(b, v, -1).to(self.dtype)
            if self.sparse_middle:
                # the voxelizer emits cells sorted by flat id, the order
                # the gather encoder's active sets keep
                cell_flat = torch.stack([flatten_cells(coords[i], self.grid)
                                         for i in range(b)])
            else:
                grid, mask = self._dense_grid(feats, coords, voxel_mask)

        with span("predict.encoder"):
            if self.sparse_middle:
                pseudo = self.pseudoimage_generator(feats, coords, cell_flat,
                                                    voxel_mask)
                if self.rows is not None:
                    # the encoder ran whole; this rank keeps its slab of H
                    pseudo = pseudo[:, :, self.rows[0]:self.rows[1]]
            else:
                # NDHWC memory seen as NCDHW (channels_last_3d): no copy
                pseudo = self._region("middle", self.pseudoimage_generator,
                                      grid.permute(0, 4, 1, 2, 3), mask)
        with span("predict.rpn_head"):
            if self.use_dense_backbone:
                x = self.neck(self.backbone(pseudo))
            else:
                # the reference re-derives the 2D active set from nonzero
                # pixels
                rpn_mask = (pseudo != 0).any(dim=1, keepdim=True)
                x = self._region("rpn", self.sparse_rpn, pseudo, rpn_mask)
            return self.bbox_head(x)

    def _region(self, name, module, *args):
        """``module(*args)``; checkpointed (its activations recomputed in
        the backward) where ``remat`` names the region ``name`` and the
        forward trains with autograd on.  Eval, predict and export never
        checkpoint."""
        if not (name in self.remat_regions and self.training
                and torch.is_grad_enabled()):
            return module(*args)
        hooks = [(m, k, m.__dict__[k]) for m in module.modules()
                 for k in _SHARD_HOOKS if k in m.__dict__]
        # the regions draw no random numbers: no RNG state to keep
        return checkpoint(
            module, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _replaying(hooks)))

    def _point_feats(self, num_points, coords, voxel_mask, points, pt_voxel,
                     pt_valid):
        """(B, V, C) voxel features from the point-granularity PFN."""
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
        return feats.reshape(b, nvp, -1)[:, :v]

    def _dense_grid(self, feats, coords, voxel_mask):
        """The (B, D, H, W, C) grid of the voxel features (K2) and its
        (B, 1, D, H, W) activity mask."""
        d, h, w = self.grid
        b = feats.shape[0]
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
        mask = torch.zeros((b, d * h * w + 1), dtype=self.dtype,
                           device=feats.device)
        mask = mask.scatter(1, cell.long(),
                            torch.ones_like(cell, dtype=self.dtype))
        return grid, mask[:, :-1].reshape(b, 1, d, h, w)


@torch.no_grad()
def init_parameters(net, generator):
    """Redraw every parameter of ``net`` (a ``PointPillarsNet``) from the
    CPU ``generator``, by the laws of the modules' constructors, and reset
    every batch norm's running statistics.  The global torch RNG is not
    touched.

    * batch norms: weight 1, bias 0, running mean 0, running var 1;
    * Linear / Conv2d / ConvTranspose2d: U(-1/sqrt(fan_in),
      1/sqrt(fan_in)) for weight and bias, fan_in the size of
      ``weight[0]`` (PyTorch's default);
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
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
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
