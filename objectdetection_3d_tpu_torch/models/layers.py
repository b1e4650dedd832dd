"""Network building blocks of the port.

Port of the point-PFN, dense-masked vertical encoder, submanifold RPN and
head of the JAX package's ``models/layers.py``.  The sparse convolutions
of the reference are dense convolutions times an activity mask, exactly
as in the JAX package:

* a submanifold conv is a dense bias-free conv whose output is multiplied
  by the input activity mask;
* a strided sparse conv activates every output site that sees an active
  input: the mask dilates like a max-pool with the conv's window/stride;
* batch norm keeps inactive sites at zero; in training mode its
  statistics are those of the active sites.

Layout: the JAX package is channels-last (NDHWC / NHWC); the port keeps
PyTorch's NCDHW / NCHW logical layout inside the network and returns the
head outputs in the JAX package's NHWC layout.  Parameters stay float32;
each op casts them to the module's compute ``dtype`` as flax does.  The
z-fold, decomposed and Pallas conv lowerings of the JAX package compute
the same convs and are not ported: the convs here are
``torch.nn.functional.conv3d`` / ``conv2d``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _bcast(vec, ndim, dtype):
    """(C,) -> (1, C, 1, ...) of ``ndim`` dims in ``dtype``."""
    return vec.to(dtype).view(1, -1, *([1] * (ndim - 2)))


class MaskedBatchNorm(nn.Module):
    """Batch norm over the active sites of a masked dense tensor.

    ``y = ((x - mean) * rsqrt(var + eps) * scale + bias) * mask``; inactive
    sites stay exactly zero.  In training mode the statistics are those of
    the active sites of the batch (computed in float32), and the running
    statistics move by ``momentum`` towards the batch mean and the
    *unbiased* batch variance; in eval mode the running statistics are
    used.  ``weight`` is the JAX package's ``scale``.
    """

    def __init__(self, channels, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def _update_running(self, mean, var, count):
        unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
        self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                + self.momentum * mean)
        self.running_var.copy_((1 - self.momentum) * self.running_var
                               + self.momentum * unbiased)

    def _stats(self, x, mask):
        """(mean, var) of the channels (dim 1) over the active sites."""
        if not self.training:
            return self.running_mean, self.running_var
        m = mask.to(torch.float32)
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        count = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=dims) / count
        var = (((xf - _bcast(mean, x.dim(), torch.float32)) ** 2)
               * m).sum(dim=dims) / count
        self._update_running(mean.detach(), var.detach(), count)
        return mean, var

    def forward(self, x, mask):
        """x: (B, C, ...); mask: (B, 1, ...) activity, broadcastable."""
        mean, var = self._stats(x, mask)
        nd, dt = x.dim(), x.dtype
        inv = torch.rsqrt(var + self.eps)
        y = (x - _bcast(mean, nd, dt)) * _bcast(inv, nd, dt)
        y = y * _bcast(self.weight, nd, dt) + _bcast(self.bias, nd, dt)
        return y * mask.to(dt)


class PointMaskedBN(MaskedBatchNorm):
    """MaskedBatchNorm for point-granularity PFN rows (N, C).

    Training statistics emulate the padded (V, M, C) buffer of the
    reference: its ``total_slots - P`` zero padding slots add zeros to the
    sums and ``total_slots`` (valid voxels x M) to the count.  Also
    returns the per-channel value a padding slot takes after
    normalization: those zero slots take part in the buffer path's
    max-pool.
    """

    def forward(self, x, pt_valid, total_slots):
        m = pt_valid.to(torch.float32)[:, None]
        if self.training:
            xf = x.float()
            count = torch.clamp(total_slots.to(torch.float32), min=1.0)
            mean = (xf * m).sum(dim=0) / count
            n_real = m.sum()
            # the (count - n_real) padding slots are exact zeros
            var = ((((xf - mean) ** 2) * m).sum(dim=0)
                   + (count - n_real) * mean ** 2) / count
            self._update_running(mean.detach(), var.detach(), count)
        else:
            mean, var = self.running_mean, self.running_var
        dt = x.dtype
        mean_t = mean.to(dt)
        inv = torch.rsqrt(var + self.eps).to(dt)
        scale, bias = self.weight.to(dt), self.bias.to(dt)
        y = (x - mean_t) * inv
        y = y * scale + bias
        pad_y = (torch.zeros_like(mean_t) - mean_t) * inv * scale + bias
        return y * m.to(dt), pad_y


class PFNLayerPoints(nn.Module):
    """Terminal PFN layer at point granularity: Linear (no bias) ->
    point-masked BN (eps 1e-3) -> ReLU -> segment max over each voxel's
    points.  Voxels with fewer than ``max_slots`` points also take the
    padding-slot ReLU floor into the max, as the padded buffer path does.
    """

    def __init__(self, in_channels, units, max_slots, dtype=torch.float32):
        super().__init__()
        self.max_slots = int(max_slots)
        self.dtype = dtype
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = PointMaskedBN(units, eps=1e-3, momentum=0.01)

    def forward(self, x, seg, pt_valid, counts, total_slots):
        """
        Args:
            x: (N, C) decorated per-point features (invalid rows zeroed).
            seg: (N,) nondecreasing segment (voxel) index per point.
            pt_valid: (N,) bool.
            counts: (S,) capped per-voxel point counts.
            total_slots: scalar tensor, valid voxels x ``max_slots``.
        Returns:
            (S, units) pooled features.
        """
        y = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        y, pad_y = self.norm(y, pt_valid, total_slots)
        y = F.relu(y)
        floor = F.relu(pad_y)
        units = y.shape[1]
        # the max is exact in float32, whatever the compute dtype
        vals = torch.where(pt_valid[:, None], y.float(),
                           torch.full_like(y, float("-inf"),
                                           dtype=torch.float32))
        pooled = torch.full((counts.shape[0], units), float("-inf"),
                            dtype=torch.float32, device=y.device)
        pooled = pooled.scatter_reduce_(
            0, seg.long()[:, None].expand(-1, units), vals, "amax")
        pooled = pooled.to(y.dtype)
        return torch.where(counts[:, None] < self.max_slots,
                           torch.maximum(pooled, floor[None, :]), pooled)


class PillarFeatureNet(nn.Module):
    """Voxel feature encoder, point-granularity path.

    Decorates each point with its offset from the voxel point centroid (3)
    and from the pillar xy center (2), runs the single PFN layer, and
    appends ``num_points`` as the final output channel.
    """

    def __init__(self, in_channels, feat_channels, voxel_size,
                 point_cloud_range, max_slots, dtype=torch.float32):
        super().__init__()
        chans = list(feat_channels)
        if len(chans) != 1:
            raise NotImplementedError(
                "the port's PFN supports single-layer stacks (the "
                "point-granularity path); deeper feat_channels are not "
                "ported yet")
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.dtype = dtype
        self.pfn_0 = PFNLayerPoints(in_channels + 5, chans[0] - 1, max_slots,
                                    dtype=dtype)

    def forward(self, points, seg, pt_valid, counts, coords, voxel_mask):
        """
        Args:
            points: (N, C) cell-sorted points.
            seg: (N,) their nondecreasing voxel index in [0, S).
            pt_valid: (N,) bool.
            counts: (S,) valid point counts per voxel.
            coords: (S, 3) int voxel coords as (z, y, x).
            voxel_mask: (S,) bool voxel validity.
        Returns:
            (S, feat_channels[-1]) features (last channel = num_points).
        """
        nseg = counts.shape[0]
        xyz = points[:, :3]
        validf = pt_valid.to(points.dtype)[:, None]
        cnt = counts.clamp(min=1).to(points.dtype)
        centroid = torch.zeros((nseg, 3), dtype=points.dtype,
                               device=points.device)
        centroid = centroid.index_add_(0, seg.long(),
                                       xyz * validf) / cnt[:, None]

        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_off = vx / 2 + self.point_cloud_range[0]
        y_off = vy / 2 + self.point_cloud_range[1]
        pil = torch.stack([
            coords[:, 2].to(points.dtype) * vx + x_off,
            coords[:, 1].to(points.dtype) * vy + y_off], dim=-1)
        ref5 = torch.cat([centroid, pil], dim=-1)[seg.long()]
        centroid_off = xyz - ref5[:, :3]
        px = points[:, 0] - ref5[:, 3]
        py = points[:, 1] - ref5[:, 4]

        feats = torch.cat([points, centroid_off, px[:, None], py[:, None]],
                          dim=-1).to(self.dtype)
        feats = feats * validf.to(self.dtype)
        total_slots = voxel_mask.sum() * self.pfn_0.max_slots
        pooled = self.pfn_0(feats, seg, pt_valid, counts, total_slots)

        out = torch.cat([pooled, counts.to(pooled.dtype)[:, None]], dim=-1)
        return out * voxel_mask[:, None].to(out.dtype)


def _lecun_normal(shape, fan_in):
    return torch.randn(shape) * (1.0 / math.sqrt(fan_in))


class SparseMiddleExtractor(nn.Module):
    """Vertical encoder: per stage a 3x3x3 submanifold conv (active set
    unchanged) then a (3,1,1)-kernel (2,1,1)-stride sparse conv (active
    set dilated, z roughly halved), each followed by masked BN (eps 1e-5)
    and ReLU.  The remaining z levels fold into channels (C, D)-major, as
    the reference's ``view(N, C*D, H, W)`` of an NCDHW tensor.

    Parameters keep the JAX package's names: ``subm_{i}_kernel`` as
    (Cout, Cin, 3, 3, 3) and ``down_{i}_kernel`` as (Cout, Cout, 3, 1, 1).
    """

    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        super().__init__()
        self.out_channels = tuple(int(c) for c in out_channels)
        self.dtype = dtype
        c = int(in_channels)
        for i, ch in enumerate(self.out_channels):
            self.register_parameter(f"subm_{i}_kernel", nn.Parameter(
                _lecun_normal((ch, c, 3, 3, 3), 27 * c)))
            self.add_module(f"subm_bn_{i}", MaskedBatchNorm(ch))
            self.register_parameter(f"down_{i}_kernel", nn.Parameter(
                _lecun_normal((ch, ch, 3, 1, 1), 3 * ch)))
            self.add_module(f"down_bn_{i}", MaskedBatchNorm(ch))
            c = ch

    @staticmethod
    def out_depth(d, stages):
        for _ in range(stages):
            d = (d - 3) // 2 + 1
        return d

    def forward(self, grid, mask):
        """
        Args:
            grid: (B, C, D, H, W) scattered voxel features.
            mask: (B, 1, D, H, W) activity mask.
        Returns:
            (B, C_out * D_final, H, W) pseudo-image.
        """
        dt = self.dtype
        x = grid.to(dt)
        mask = mask.to(dt)
        for i in range(len(self.out_channels)):
            w = getattr(self, f"subm_{i}_kernel").to(dt)
            x = F.conv3d(x, w, padding=1)
            x = x * mask
            x = F.relu(getattr(self, f"subm_bn_{i}")(x, mask))

            wd = getattr(self, f"down_{i}_kernel").to(dt)
            x = F.conv3d(x, wd, stride=(2, 1, 1))
            mask = F.max_pool3d(mask, (3, 1, 1), (2, 1, 1))
            x = F.relu(getattr(self, f"down_bn_{i}")(x, mask))

        b, c, d, h, w = x.shape
        return x.reshape(b, c * d, h, w)


class SubmanifoldSparseRPN(nn.Module):
    """2D RPN over the pseudo-image: dense 3x3 convs under a fixed
    nonzero-pixel mask, each with masked BN (eps 1e-3) and ReLU."""

    def __init__(self, in_channels, out_channels, layer_nums,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = int(in_channels)
        li = 0
        for ch, extra in zip(out_channels, layer_nums):
            for _ in range(1 + int(extra)):
                self.add_module(f"conv_{li}", nn.Conv2d(c, int(ch), 3,
                                                        padding=1,
                                                        bias=False))
                self.add_module(f"bn_{li}", MaskedBatchNorm(
                    int(ch), eps=1e-3, momentum=0.01))
                c = int(ch)
                li += 1
        self.num_layers = li

    def forward(self, x, mask):
        """x: (B, C, H, W) pseudo-image; mask: (B, 1, H, W)."""
        dt = self.dtype
        x = x.to(dt)
        mask = mask.to(dt)
        for li in range(self.num_layers):
            w = getattr(self, f"conv_{li}").weight.to(dt)
            x = F.conv2d(x, w, padding=1)
            x = x * mask
            x = F.relu(getattr(self, f"bn_{li}")(x, mask))
        return x


class Anchor3DHead(nn.Module):
    """1x1 conv head: per cell class logits (A*C), box deltas (A*9) and
    direction logits (A*6), returned NHWC in float32."""

    def __init__(self, in_channels, num_classes, num_anchors,
                 box_params_num=9, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_cls = nn.Conv2d(in_channels, num_anchors * num_classes, 1)
        self.conv_reg = nn.Conv2d(in_channels, num_anchors * box_params_num,
                                  1)
        self.conv_dir = nn.Conv2d(in_channels, num_anchors * 6, 1)
        with torch.no_grad():
            nn.init.normal_(self.conv_cls.weight, std=0.01)
            nn.init.constant_(self.conv_cls.bias,
                              -math.log((1 - 0.01) / 0.01))
            nn.init.normal_(self.conv_reg.weight, std=0.01)
            nn.init.zeros_(self.conv_reg.bias)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        outs = []
        for conv in (self.conv_cls, self.conv_reg, self.conv_dir):
            y = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt))
            outs.append(y.float().permute(0, 2, 3, 1))
        return tuple(outs)
