"""Network building blocks of the port.

Port of the JAX package's ``models/layers.py``: the PFN on its point path
and on its (V, M, C) buffer path, the dense-masked vertical encoder, the
submanifold RPN, the dense SECOND backbone and FPN neck
(``use_dense_backbone``), the head, and the foreground filter ``MLP``.
The sparse convolutions
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
each op casts them to the module's compute ``dtype`` as flax does.

The vertical encoder reads the JAX package's lowering knobs and sends the
same stages through the same kernels: ``pallas_subm_conv`` (K10,
``ops/pallas_conv.py``), ``zfold_convs`` with ``zfold_pallas`` (the z-fold
and K9, ``ops/zfold_conv.py``) and ``fused_stages`` (K8,
``ops/fused_stage.py``).  The lowerings that are XLA convs in the JAX
package and compute the same conv are ``torch.nn.functional.conv3d``
here: ``decompose_convs`` (z-shifted 2D convs), the z-fold without
``zfold_pallas``, and the folded down conv under every knob.  All
lowerings share one parameter tree.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_3d_tpu_torch.ops.fused_stage import fused_stage
from objectdetection_3d_tpu_torch.ops.pallas_conv import subm_conv3d
from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3


# > 0 while a checkpointed region of the network (``tpu.remat``) runs its
# forward again for the backward; see :func:`recomputing`
_recompute_depth = 0


@contextlib.contextmanager
def recomputing():
    """Inside: the forward runs again to rebuild a checkpointed region's
    activations for its backward.  The batch norms compute the same batch
    statistics and do not move their running statistics a second time,
    as flax's ``nn.remat`` drops the recompute's ``batch_stats``."""
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


def get_paddings_indicator(actual_num, max_num, axis=0):
    """Mask of the valid slots of a padded dimension: entry (i, j) is
    ``j < actual_num[i]`` (for ``axis=0``); (N, max_num) bool."""
    actual = actual_num.unsqueeze(axis + 1)
    shape = [1] * actual.dim()
    shape[axis + 1] = -1
    rng = torch.arange(max_num, dtype=torch.int32,
                       device=actual.device).reshape(shape)
    return actual.to(torch.int32) > rng


def get_paddings_indicator_np(actual_num, max_num):
    """:func:`get_paddings_indicator` in numpy, over a flat count."""
    return np.reshape(actual_num, (-1, 1)) > np.arange(max_num)[None]


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

    # sums a float32 tensor over the ranks that share the batch, with
    # autograd (``parallel/data_parallel.py`` sets it for a sharded step);
    # None: the statistics are those of this device's batch
    stats_sum = None

    def __init__(self, channels, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _moves_running(self):
        """Whether a training-mode forward moves the running statistics:
        not while a checkpointed region is recomputed."""
        return self.training and not _recompute_depth

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
        if self.stats_sum is None:
            count = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=dims) / count
            var = (((xf - _bcast(mean, x.dim(), torch.float32)) ** 2)
                   * m).sum(dim=dims) / count
        else:
            # the sums of every rank's sites, then the centred sum
            tot = self.stats_sum(torch.cat([(xf * m).sum(dim=dims),
                                            m.sum()[None]]))
            count = torch.clamp(tot[-1], min=1.0)
            mean = tot[:-1] / count
            var = self.stats_sum(
                (((xf - _bcast(mean, x.dim(), torch.float32)) ** 2)
                 * m).sum(dim=dims)) / count
        if self._moves_running():
            self._update_running(mean.detach(), var.detach(), count)
        return mean, var

    def eval_affine(self):
        """The eval-mode batch norm as ``y = a * x + b`` at active sites:
        ``a = weight * rsqrt(running_var + eps)``,
        ``b = bias - running_mean * a``, float32 (K8's epilogue)."""
        a = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        return a, self.bias.float() - self.running_mean.float() * a

    def forward(self, x, mask):
        """x: (B, C, ...); mask: (B, 1, ...) activity, broadcastable."""
        mean, var = self._stats(x, mask)
        nd, dt = x.dim(), x.dtype
        inv = torch.rsqrt(var + self.eps)
        y = (x - _bcast(mean, nd, dt)) * _bcast(inv, nd, dt)
        y = y * _bcast(self.weight, nd, dt) + _bcast(self.bias, nd, dt)
        return y * mask.to(dt)


class BatchNorm(MaskedBatchNorm):
    """Batch norm over every site of a (B, C, ...) tensor: flax's
    ``nn.BatchNorm`` (the backbone's and the neck's).  In training mode
    the biased batch variance both normalizes and is what the running
    variance moves towards (``MaskedBatchNorm`` keeps the unbiased one, as
    the reference's sparse batch norms do).  Flax's momentum 0.99 is
    ``momentum=0.01`` here."""

    @torch.no_grad()
    def _update_running(self, mean, var, count):
        self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                + self.momentum * mean)
        self.running_var.copy_((1 - self.momentum) * self.running_var
                               + self.momentum * var)

    def forward(self, x):
        return super().forward(x, torch.ones_like(x[:, :1]))


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
            if self.stats_sum is None:
                count = torch.clamp(total_slots.to(torch.float32), min=1.0)
                mean = (xf * m).sum(dim=0) / count
                n_real = m.sum()
                centred = (((xf - mean) ** 2) * m).sum(dim=0)
            else:
                tot = self.stats_sum(torch.cat([
                    (xf * m).sum(dim=0), total_slots.to(torch.float32)[None],
                    m.sum()[None]]))
                count = torch.clamp(tot[-2], min=1.0)
                mean = tot[:-2] / count
                n_real = tot[-1]
                centred = self.stats_sum((((xf - mean) ** 2) * m).sum(dim=0))
            # the (count - n_real) padding slots are exact zeros
            var = (centred + (count - n_real) * mean ** 2) / count
            if self._moves_running():
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


class PFNLayer(nn.Module):
    """PFN layer on the (V, M, C) buffers: Linear (no bias) -> masked BN
    (eps 1e-3) over every slot of the valid voxels, padding slots as the
    zeros they are -> ReLU -> max over the slots.  A layer that is not the
    last appends the pooled row to every slot (2 x ``units`` out)."""

    def __init__(self, in_channels, units, last_layer, dtype=torch.float32):
        super().__init__()
        self.last_layer = bool(last_layer)
        self.dtype = dtype
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = MaskedBatchNorm(units, eps=1e-3, momentum=0.01)

    def forward(self, x, voxel_mask):
        """x: (V, M, C) decorated features; voxel_mask: (V,) bool.
        Returns (V, units) if last, else (V, M, 2 * units)."""
        v, m, _ = x.shape
        y = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        slots = voxel_mask[:, None, None].expand(v, m, 1).reshape(v * m, 1)
        y = F.relu(self.norm(y.reshape(v * m, -1), slots)).reshape(v, m, -1)
        pooled = y.amax(dim=1)
        if self.last_layer:
            return pooled
        return torch.cat([y, pooled[:, None, :].expand_as(y)], dim=-1)


def fixed_point_segment_sum(values, seg, num_segments, frac_bits):
    """Per-segment sums of the rows of ``values`` (N, C), bit-reproducible.

    Each value is rounded to a multiple of ``2**-frac_bits`` and the
    segments are summed as int64, which is associative: CUDA's atomics
    add in an order that changes from call to call, but integer sums do
    not depend on it.  The caller picks ``frac_bits`` so that no segment's
    sum reaches 2**62.  Returns (num_segments, C) float64.
    """
    scale = float(2 ** frac_bits)
    q = torch.round(values.double() * scale).to(torch.int64)
    sums = torch.zeros((num_segments, values.shape[1]), dtype=torch.int64,
                       device=values.device)
    return sums.index_add_(0, seg, q).double() / scale


class PillarFeatureNet(nn.Module):
    """Voxel feature encoder, point-granularity path.

    Decorates each point with its offset from the voxel point centroid (3)
    and from the pillar xy center (2), runs the single PFN layer, and
    appends ``num_points`` as the final output channel.  The centroid's
    sum is :func:`fixed_point_segment_sum`, so predict and the train step
    give the same bits on every call (float atomics would not).
    """

    def __init__(self, in_channels, feat_channels, voxel_size,
                 point_cloud_range, max_slots, dtype=torch.float32):
        super().__init__()
        chans = list(feat_channels)
        if len(chans) != 1:
            raise ValueError(
                "the point-granularity PFN runs single-layer stacks; deeper "
                "feat_channels take PillarFeatureNetBuffers")
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.dtype = dtype
        # a valid point lies inside the range, and a voxel sums at most
        # max_slots of them: the fraction bits that keep |sum| < 2**62
        int_bits = math.ceil(math.log2(
            max(abs(v) for v in self.point_cloud_range) + 1))
        self.frac_bits = 62 - int_bits - math.ceil(math.log2(max_slots + 1))
        if self.frac_bits < 24:
            raise ValueError(
                f"point_cloud_range {self.point_cloud_range} and "
                f"{max_slots} points per voxel leave {self.frac_bits} "
                f"fraction bits for the centroid's fixed-point sum; at "
                f"least 24 are needed")
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
        cnt = counts.clamp(min=1).double()
        centroid = (fixed_point_segment_sum(
            torch.where(pt_valid[:, None], xyz, 0.0), seg.long(), nseg,
            self.frac_bits) / cnt[:, None]).to(points.dtype)

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


class PillarFeatureNetBuffers(nn.Module):
    """Voxel feature encoder on the (V, M, C) buffers of
    ``ops/voxelize.voxelize_batch``: the JAX package's
    ``PillarFeatureNet`` without point arguments, for PFN stacks of any
    depth.  It computes :class:`PillarFeatureNet`'s function (same
    parameter tree ``pfn_{i}.linear`` / ``pfn_{i}.norm``); each non-last
    layer takes ``feat_channels[i] // 2`` units and doubles them by the
    pooled append."""

    def __init__(self, in_channels, feat_channels, voxel_size,
                 point_cloud_range, dtype=torch.float32):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.dtype = dtype
        chans = [int(c) for c in feat_channels]
        c = int(in_channels) + 5
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            units = ch - 1 if last else ch // 2
            self.add_module(f"pfn_{i}", PFNLayer(c, units, last, dtype))
            c = 2 * units
        self.num_layers = len(chans)

    def forward(self, voxels, num_points, coords, voxel_mask):
        """
        Args:
            voxels: (V, M, C) per-voxel point buffers (xyz + features).
            num_points: (V,) valid point counts.
            coords: (V, 3) int voxel coords as (z, y, x).
            voxel_mask: (V,) bool voxel validity.
        Returns:
            (V, feat_channels[-1]) features (last channel = num_points).
        """
        m = voxels.shape[1]
        dt = voxels.dtype
        npts = num_points.clamp(min=1).to(dt)
        mean = voxels[:, :, :3].sum(dim=1, keepdim=True) / npts[:, None,
                                                                 None]
        centroid_off = voxels[:, :, :3] - mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_off = vx / 2 + self.point_cloud_range[0]
        y_off = vy / 2 + self.point_cloud_range[1]
        px = voxels[:, :, 0] - (coords[:, 2].to(dt)[:, None] * vx + x_off)
        py = voxels[:, :, 1] - (coords[:, 1].to(dt)[:, None] * vy + y_off)
        feats = torch.cat([voxels, centroid_off, px[..., None],
                           py[..., None]], dim=-1).to(self.dtype)
        point_mask = (torch.arange(m, device=voxels.device)[None, :]
                      < num_points[:, None])
        feats = feats * point_mask[..., None].to(feats.dtype)
        for i in range(self.num_layers):
            feats = getattr(self, f"pfn_{i}")(feats, voxel_mask)
        out = torch.cat([feats, num_points.to(feats.dtype)[:, None]],
                        dim=-1)
        return out * voxel_mask[:, None].to(out.dtype)


def _lecun_normal(shape, fan_in):
    return torch.randn(shape) * (1.0 / math.sqrt(fan_in))


def zfold_operands(x, kernel, zb):
    """The operands of the z-folded subm conv.

    The D axis of the (B, D, H, W, C) grid ``x`` is cut into blocks of
    ``zb`` slices; each block and one halo slice on each side fold into
    the channels.  A banded weight built from the (3, 3, 3, C, Co)
    ``kernel`` computes the z taps inside a 3x3 2D conv: output sub-block
    a reads folded slices a..a+2 with the weights of taps dz = 0..2.

    Returns:
        ((B*dblk, H, W, (zb+2)*C) folded input,
         (3, 3, (zb+2)*C, zb*Co) banded weight), dblk = ceil(D / zb).
    """
    b, d, h, w, c = x.shape
    co = kernel.shape[-1]
    dblk = -(-d // zb)
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, dblk * zb - d + 1))
    xo = torch.stack([xp[:, k * zb:k * zb + zb + 2] for k in range(dblk)],
                     dim=1)
    xo = xo.permute(0, 1, 3, 4, 2, 5).reshape(b * dblk, h, w, (zb + 2) * c)
    kf = kernel.new_zeros((3, 3, (zb + 2) * c, zb * co))
    for a in range(zb):
        for dz in range(3):
            j = a + dz
            kf[:, :, j * c:(j + 1) * c, a * co:(a + 1) * co] = kernel[dz]
    return xo, kf


def zfold_unfold(y, b, d, zb):
    """(B*dblk, H, W, zb*Co) folded conv output -> (B, D, H, W, Co)."""
    n, h, w, cf = y.shape
    co = cf // zb
    y = y.reshape(b, n // b, h, w, zb, co).permute(0, 1, 4, 2, 3, 5)
    return y.reshape(b, n // b * zb, h, w, co)[:, :d]


def _ndhwc(x):
    """(B, C, D, H, W) -> (B, D, H, W, C); no copy for channels_last_3d
    memory, which the grid build and the kernels produce."""
    return x.permute(0, 2, 3, 4, 1)


def _ncdhw(x):
    """(B, D, H, W, C) -> (B, C, D, H, W) view (channels_last_3d)."""
    return x.permute(0, 4, 1, 2, 3)


class SparseMiddleExtractor(nn.Module):
    """Vertical encoder: per stage a 3x3x3 submanifold conv (active set
    unchanged) then a (3,1,1)-kernel (2,1,1)-stride sparse conv (active
    set dilated, z roughly halved), each followed by masked BN (eps 1e-5)
    and ReLU.  The remaining z levels fold into channels (C, D)-major, as
    the reference's ``view(N, C*D, H, W)`` of an NCDHW tensor.

    Parameters keep the JAX package's names: ``subm_{i}_kernel`` as
    (Cout, Cin, 3, 3, 3) and ``down_{i}_kernel`` as (Cout, Cout, 3, 1, 1).

    The knobs are the JAX package's ``SparseMiddleExtractor`` fields, with
    its gates (``models/layers.py``), so the same stages take the same
    kernels:

    * ``pallas_subm``: in eval mode, a stage with C <= 24, H % 8 == 0 and
      W >= 8 runs its subm conv through K10 (checked first);
    * ``zfold_convs`` and ``zfold_pallas``: a stage whose z block zb (the
      largest with (zb+2)*C <= 128) is at least 2 and whose folded widths
      (zb+2)*C and zb*Co are at most 128 runs its subm conv as the z-fold
      through K9, in train and eval mode.  ``zfold_convs`` alone is the
      same conv as ``F.conv3d`` (the JAX package's XLA fold), and so is
      the folded down conv;
    * ``fused_stages``: in eval mode, a stage whose fused z block
      (:meth:`_fused_zb`) is nonzero runs whole through K8;
    * ``decompose_convs`` (bool, or the number of leading stages) keeps a
      stage off the z-fold and K8, as in the JAX package; its z-shifted 2D
      convs compute ``F.conv3d``'s conv.
    """

    # fills one halo row on each side of H (``x``'s dim 3) from the
    # neighbouring ranks, zeros at the global edges, when H is split over
    # ranks (``parallel/data_parallel.py``); every subm conv then runs as
    # ``F.conv3d`` with no padding in H, and K8-K10 are not used
    halo = None

    def __init__(self, in_channels, out_channels, dtype=torch.float32,
                 decompose_convs=False, pallas_subm=False, zfold_convs=False,
                 zfold_pallas=False, fused_stages=False):
        super().__init__()
        self.out_channels = tuple(int(c) for c in out_channels)
        self.dtype = dtype
        self.decompose_convs = decompose_convs
        self.pallas_subm = bool(pallas_subm)
        self.zfold_convs = bool(zfold_convs)
        self.zfold_pallas = bool(zfold_pallas)
        self.fused_stages = bool(fused_stages)
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

    def _decompose_stage(self, stage):
        if isinstance(self.decompose_convs, bool):
            return self.decompose_convs
        return stage < int(self.decompose_convs)

    @staticmethod
    def _zfold_block(c_in, d):
        """The z block of the subm z-fold: the largest zb with
        (zb+2)*c_in <= 128, at most d."""
        return min(max(1, 128 // c_in - 2), d)

    @staticmethod
    def _fused_zb(c, ch, d):
        """The JAX fused stage's z block: even zb with (zb+2)*c <= 128 and
        zb*ch <= 128; 0 = the stage does not take K8."""
        zb = min(128 // c - 2, 128 // ch)
        zb -= zb % 2
        if zb < 2 or d < 3:
            return 0
        return zb

    def _subm_conv3d_zfold(self, x, kernel, zb):
        """3x3x3 SAME conv of NCDHW ``x`` as the z-folded 3x3 2D conv
        (K9); ``kernel`` in the port's (Co, C, 3, 3, 3) layout."""
        b, _, d = x.shape[:3]
        xo, kf = zfold_operands(_ndhwc(x), kernel.permute(2, 3, 4, 1, 0), zb)
        return _ncdhw(zfold_unfold(conv2d_3x3(xo, kf), b, d, zb))

    def _subm_conv3d(self, x, i):
        """Stage ``i``'s 3x3x3 SAME subm conv of NCDHW ``x``."""
        kernel = getattr(self, f"subm_{i}_kernel")
        if self.halo is not None:
            return F.conv3d(self.halo(x, 3), kernel.to(self.dtype),
                            padding=(1, 0, 1))
        _, c, d, h, w = x.shape
        co = kernel.shape[0]
        if (self.pallas_subm and not self.training and c <= 24
                and h % 8 == 0 and w >= 8):
            return _ncdhw(subm_conv3d(_ndhwc(x),
                                      kernel.permute(2, 3, 4, 1, 0)))
        zb = self._zfold_block(c, d)
        if (self.zfold_convs and self.zfold_pallas
                and not self._decompose_stage(i) and zb >= 2
                and (zb + 2) * c <= 128 and zb * co <= 128):
            return self._subm_conv3d_zfold(x, kernel, zb)
        return F.conv3d(x, kernel.to(self.dtype), padding=1)

    def fused_stage_args(self, i):
        """K8's weights for stage ``i`` in the JAX layouts: the
        (3, 3, 3, C, Co) subm and (3, Co, Co) down kernels, and the eval
        affines a_s, b_s, a_d, b_d of the two batch norms."""
        a_s, b_s = getattr(self, f"subm_bn_{i}").eval_affine()
        a_d, b_d = getattr(self, f"down_bn_{i}").eval_affine()
        kd = getattr(self, f"down_{i}_kernel")[:, :, :, 0, 0]
        return (getattr(self, f"subm_{i}_kernel").permute(2, 3, 4, 1, 0),
                kd.permute(2, 1, 0), a_s, b_s, a_d, b_d)

    def stage(self, i, x, mask):
        """Stage ``i`` on NCDHW ``x`` of the compute type and its
        (B, 1, D, H, W) mask -> (x, mask) of the next stage."""
        ch = self.out_channels[i]
        if (self.fused_stages and not self.training and self.halo is None
                and not self._decompose_stage(i)
                and self._fused_zb(x.shape[1], ch, x.shape[2])):
            y = fused_stage(_ndhwc(x), mask[:, 0], *self.fused_stage_args(i))
            return _ncdhw(y), F.max_pool3d(mask, (3, 1, 1), (2, 1, 1))
        x = self._subm_conv3d(x, i)
        x = x * mask
        x = F.relu(getattr(self, f"subm_bn_{i}")(x, mask))

        wd = getattr(self, f"down_{i}_kernel").to(self.dtype)
        x = F.conv3d(x, wd, stride=(2, 1, 1))
        mask = F.max_pool3d(mask, (3, 1, 1), (2, 1, 1))
        x = F.relu(getattr(self, f"down_bn_{i}")(x, mask))
        return x, mask

    def forward(self, grid, mask):
        """
        Args:
            grid: (B, C, D, H, W) scattered voxel features.
            mask: (B, 1, D, H, W) activity mask.
        Returns:
            (B, C_out * D_final, H, W) pseudo-image.
        """
        x = grid.to(self.dtype)
        mask = mask.to(self.dtype)
        for i in range(len(self.out_channels)):
            x, mask = self.stage(i, x, mask)
        b, c, d, h, w = x.shape
        return x.reshape(b, c * d, h, w)


class SubmanifoldSparseRPN(nn.Module):
    """2D RPN over the pseudo-image: dense 3x3 convs under a fixed
    nonzero-pixel mask, each with masked BN (eps 1e-3) and ReLU."""

    # as ``SparseMiddleExtractor.halo``, on H = ``x``'s dim 2
    halo = None

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
            if self.halo is None:
                x = F.conv2d(x, w, padding=1)
            else:
                x = F.conv2d(self.halo(x, 2), w, padding=(0, 1))
            x = x * mask
            x = F.relu(getattr(self, f"bn_{li}")(x, mask))
        return x


class BackboneDWS(nn.Module):
    """SECOND-style strided 2D backbone (``use_dense_backbone``): per
    stage a 3x3 conv at the stage's stride then ``layer_nums`` 3x3 convs,
    each with :class:`BatchNorm` (eps 1e-3) and ReLU.  Each conv takes its
    input width from the layer before it.  Returns every stage's
    output."""

    # as ``SubmanifoldSparseRPN.halo``: with H split over ranks, each 3x3
    # conv, strided ones included, convolves this rank's rows and one halo
    # row on each side with no padding in H.  A slab that starts on a row
    # the stride keeps gets the same rows as the unsplit conv
    halo = None

    def __init__(self, in_channels, out_channels, layer_nums, layer_strides,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.total_stride = math.prod(int(s) for s in layer_strides)
        self.stage_sizes = []
        c = int(in_channels)
        li = 0
        for ch, num, stride in zip(out_channels, layer_nums, layer_strides):
            for j in range(1 + int(num)):
                self.add_module(f"conv_{li}", nn.Conv2d(
                    c, int(ch), 3, stride=int(stride) if j == 0 else 1,
                    padding=1, bias=False))
                self.add_module(f"bn_{li}", BatchNorm(int(ch), eps=1e-3,
                                                      momentum=0.01))
                c = int(ch)
                li += 1
            self.stage_sizes.append(1 + int(num))

    def forward(self, x):
        """(B, C, H, W) -> list of each stage's (B, C_i, H_i, W_i)."""
        x = x.to(self.dtype)
        outs = []
        li = 0
        for size in self.stage_sizes:
            for _ in range(size):
                conv = getattr(self, f"conv_{li}")
                w = conv.weight.to(self.dtype)
                if self.halo is None:
                    x = F.conv2d(x, w, stride=conv.stride, padding=1)
                else:
                    x = F.conv2d(self.halo(x, 2), w, stride=conv.stride,
                                 padding=(0, 1))
                x = F.relu(getattr(self, f"bn_{li}")(x))
                li += 1
            outs.append(x)
        return outs


class BackboneUPS(nn.Module):
    """SECONDFPN-style neck: per scale a transposed conv with kernel =
    stride (``deconv_{i}``, its weight (in, out, kh, kw)), :class:`BatchNorm`
    and ReLU, the scales concatenated on channels.  Each transposed conv
    takes its input width from the backbone stage it reads."""

    def __init__(self, in_channels, out_channels, upsample_strides,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_scales = len(out_channels)
        for i, (c, ch, s) in enumerate(zip(in_channels, out_channels,
                                           upsample_strides)):
            if int(s) < 1:
                raise ValueError(f"neck upsample_strides must be >= 1, got "
                                 f"{s}")
            self.add_module(f"deconv_{i}", nn.ConvTranspose2d(
                int(c), int(ch), int(s), stride=int(s), bias=False))
            self.add_module(f"bn_{i}", BatchNorm(int(ch), eps=1e-3,
                                                 momentum=0.01))

    def forward(self, xs):
        """list of (B, C_i, H_i, W_i) -> (B, sum(out_channels), H, W)."""
        ups = []
        for i, x in enumerate(xs[:self.num_scales]):
            deconv = getattr(self, f"deconv_{i}")
            x = F.conv_transpose2d(x.to(self.dtype),
                                   deconv.weight.to(self.dtype),
                                   stride=deconv.stride)
            ups.append(F.relu(getattr(self, f"bn_{i}")(x)))
        return torch.cat(ups, dim=1)


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


class MLP(nn.Module):
    """Foreground/background point classifier: five blocks of Linear,
    BatchNorm1d, ReLU and dropout, then a Linear to one logit and a
    sigmoid.  Module names follow the JAX package's flax tree
    (``dense_i``, ``bn_i``, ``out``), so ``models/weights.py`` carries its
    variables; the batch norms take flax's epsilon (1e-5) and its
    momentum (0.99 of the old statistics kept)."""

    def __init__(self, input_channels=37, hidden=(100, 500, 250, 100, 25),
                 dropout=0.2):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.dropout = float(dropout)
        width = int(input_channels)
        for i, h in enumerate(self.hidden):
            self.add_module(f"dense_{i}", nn.Linear(width, h))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(h, eps=1e-5,
                                                      momentum=0.01))
            width = h
        self.out = nn.Linear(width, 1)

    def forward(self, x):
        """(N, input_channels) float32 -> (N, 1) probabilities."""
        for i in range(len(self.hidden)):
            x = getattr(self, f"dense_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x))
            x = F.dropout(x, self.dropout, self.training)
        return torch.sigmoid(self.out(x))
