"""Plain PyTorch reference of the PointPillars detector the benchmark
measures, the architecture of a configuration that names none (the
contract it keeps: :mod:`portbench.reference`): voxelization, the pillar
feature net, the dense grid, the masked vertical encoder, the submanifold
RPN or the strided backbone and FPN neck, the anchor head, decode, greedy
NMS, the training losses with their target assignment, and clipped AdamW.

Everything runs in float32 (the caller turns TF32 off), one cloud at a
time, with no kernel of the program and nothing the program made: the
weights come from the same raw file or generator, the anchors and every
table are derived here again.  Parameters are a dict keyed by the
program's state-dict names, in PyTorch layouts; the arithmetic is written
out here.

``quant``: every convolution and linear layer passes its two operands
through ``quant(x)``, and every tensor the network hands on (each
convolution's output and each batch norm's) passes through it too: the
identity for the reference, a lower precision for the control of
``correct``, which so computes in that precision wherever the program
computes in its own.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# this architecture's work, counted dense from the configuration's shapes
from portbench.harness.flops import encoder_bytes, forward_flops  # noqa: F401
from portbench.reference import geometry


def identity(x):
    return x


class Spec:
    """The sizes the reference needs from a configuration dict (the
    benchmark's ``configs/<name>.json`` ``model`` section)."""

    def __init__(self, cfg):
        self.pcr = [float(v) for v in cfg["point_cloud_range"]]
        vox = cfg["voxelize"]
        self.voxel_size = [float(v) for v in vox["voxel_size"]]
        self.max_slots = int(vox["max_voxel_points"])
        self.grid = [int(round((self.pcr[3 + i] - self.pcr[i])
                               / self.voxel_size[i])) for i in range(3)]
        tpu = cfg["tpu"]
        self.max_voxels = min(int(vox["max_voxels"]),
                              int(tpu["max_voxels_static"]))
        self.max_det = int(tpu["max_detections"])
        self.pfn_units = int(cfg["voxel_encoder"]["feat_channels"][-1]) - 1
        self.middle = [int(c) for c in cfg["vertical_encoder"]["out_channels"]]
        bb = cfg["backbone"]
        self.rpn_channels = [int(c) for c in bb["out_channels"]]
        self.layer_nums = [int(c) for c in bb["layer_nums"]]
        self.layer_strides = [int(c) for c in bb.get("layer_strides",
                                                     [2, 2, 2])]
        self.dense_backbone = bool(cfg.get("use_dense_backbone", False))
        neck = cfg.get("neck") or {}
        self.neck_channels = [int(c) for c in neck.get("out_channels", [])]
        self.neck_strides = [int(c) for c in neck.get("upsample_strides",
                                                      [])]
        head = cfg["head"]
        self.nms_pre = int(head["nms_pre"])
        self.score_thr = float(head["score_thr"])
        self.nms_thresh = float(head["nms_thresh"])
        self.sizes = np.asarray(head["sizes"], np.float32).reshape(-1, 3)
        self.rotations = np.asarray(head["rotations"],
                                    np.float32).reshape(-1, 3)
        self.anchor_range = [float(v) for v in head["ranges"][0]]
        self.iou_thr = [float(v) for v in head["iou_thr"][0]]
        self.num_anchors = len(self.sizes) * len(self.rotations)
        loss = cfg["loss"]
        self.focal = loss["focal"]
        self.smooth_l1 = loss["smooth_l1"]
        self.dir_weight = float(loss["cross_entropy"]["loss_weight"])
        gz, gy, gx = self.grid[2], self.grid[1], self.grid[0]
        if self.dense_backbone:
            factor = math.prod(self.layer_strides) // self.neck_strides[-1]
            self.featmap = (gy // factor, gx // factor)
        else:
            self.featmap = (gy, gx)
        self.depth_out = gz
        for _ in self.middle:
            self.depth_out = (self.depth_out - 3) // 2 + 1


# ---------------------------------------------------------------------------
# voxelization and the pillar feature net
# ---------------------------------------------------------------------------
def voxelize(points, n, spec):
    """One padded (P, 4) float32 cloud with ``n`` valid rows ->
    (voxels (V, M, 4) with each voxel's kept points in its first slots,
    counts (V,), coords (V, 3) as (z, y, x), valid (V,) bool).

    A point lies in cell floor((xyz - lo) / voxel size) if that is inside
    the grid.  Each cell keeps its M points of highest reflectance (the
    lower row first among equal ones); cells are numbered in (z, y, x)
    raster order and the V lowest-numbered occupied cells are kept.
    """
    dev = points.device
    gx, gy, gz = spec.grid
    p = points.shape[0]
    lo = torch.tensor(spec.pcr[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(spec.voxel_size, dtype=torch.float32, device=dev)
    c3 = torch.floor((points[:, :3] - lo) / vs).to(torch.int64)
    top = torch.tensor([gx, gy, gz], device=dev)
    ok = ((torch.arange(p, device=dev) < n)
          & ((c3 >= 0) & (c3 < top)).all(-1)
          & torch.isfinite(points[:, :3]).all(-1))
    rows = torch.nonzero(ok)[:, 0]
    cell = (c3[rows, 2] * gy + c3[rows, 1]) * gx + c3[rows, 0]
    # order by (cell, -reflectance, row): one lexicographic sort
    o = torch.argsort(-points[rows, 3], stable=True)
    o = o[torch.argsort(cell[o], stable=True)]
    rows, cell = rows[o], cell[o]
    ucell, counts = torch.unique_consecutive(cell, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    vid = torch.repeat_interleave(torch.arange(len(ucell), device=dev),
                                  counts)
    rank = torch.arange(len(cell), device=dev) - starts[vid]
    v, m = spec.max_voxels, spec.max_slots
    keep = (rank < m) & (vid < v)
    voxels = torch.zeros((v, m, points.shape[1]), dtype=torch.float32,
                         device=dev)
    voxels[vid[keep], rank[keep]] = points[rows[keep]]
    nv = min(len(ucell), v)
    cnt = torch.zeros((v,), dtype=torch.int64, device=dev)
    cnt[:nv] = counts[:nv].clamp(max=m)
    coords = torch.full((v, 3), -1, dtype=torch.int64, device=dev)
    uc = ucell[:nv]
    coords[:nv] = torch.stack([uc // (gx * gy), (uc // gx) % gy, uc % gx],
                              -1)
    valid = torch.arange(v, device=dev) < nv
    return voxels, cnt, coords, valid


def batch_norm(x, mask, p, prefix, eps, train, dims):
    """Batch norm of ``x`` over ``dims``; train mode takes the mean and
    biased variance of the sites where ``mask`` (broadcastable) is 1,
    eval mode the running statistics.  The output is multiplied by the
    mask."""
    w, b = p[prefix + ".weight"], p[prefix + ".bias"]
    shape = [1] * x.dim()
    shape[1] = -1
    if train:
        cnt = torch.clamp(mask.expand_as(x[:, :1]).sum(), min=1.0)
        mean = (x * mask).sum(dim=dims) / cnt
        var = (((x - mean.view(shape)) ** 2) * mask).sum(dim=dims) / cnt
    else:
        mean, var = p[prefix + ".running_mean"], p[prefix + ".running_var"]
    y = ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + eps)
         * w.view(shape) + b.view(shape))
    return y * mask


def pillar_features(voxels, cnt, coords, valid, p, spec, train, quant):
    """(V, 20) features: the PFN layer (linear, batch norm over every slot
    of the valid voxels, padding slots as zeros, ReLU, max over the slots)
    and the point count."""
    v, m, _ = voxels.shape
    slot_ok = (torch.arange(m, device=voxels.device)[None] < cnt[:, None])
    npts = cnt.clamp(min=1).to(torch.float32)
    xyz = voxels[..., :3]
    centroid = xyz.sum(1, keepdim=True) / npts[:, None, None]
    vx, vy = spec.voxel_size[0], spec.voxel_size[1]
    px = voxels[..., 0] - (coords[:, 2:3].float() * vx + vx / 2
                           + spec.pcr[0])
    py = voxels[..., 1] - (coords[:, 1:2].float() * vy + vy / 2
                           + spec.pcr[1])
    feats = torch.cat([voxels, xyz - centroid, px[..., None], py[..., None]],
                      -1) * slot_ok[..., None]
    y = quant(quant(feats) @ quant(p["voxel_encoder.pfn_0.linear.weight"]).t())
    # (V*M, C) rows; every slot of a valid voxel counts, padding as 0
    rows = y.reshape(v * m, -1)
    rmask = valid[:, None].expand(v, m).reshape(v * m, 1).float()
    y = quant(batch_norm(rows, rmask, p, "voxel_encoder.pfn_0.norm", 1e-3,
                         train, (0,)))
    pooled = F.relu(y).reshape(v, m, -1).amax(1)
    out = torch.cat([pooled, cnt.float()[:, None]], -1)
    return out * valid[:, None]


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------
def encoder(feats, coords, valid, p, spec, train, quant):
    """(1, C * D', H, W) pseudo-image of the masked dense vertical encoder
    (per stage a 3x3x3 conv, masked, batch norm, ReLU, then a (3, 1, 1)
    conv at stride (2, 1, 1) with the mask dilated alike, batch norm,
    ReLU; eps 1e-5)."""
    gx, gy, gz = spec.grid
    c = feats.shape[1]
    flat = ((coords[:, 0] * gy + coords[:, 1]) * gx + coords[:, 2])[valid]
    grid = torch.zeros((gz * gy * gx, c), dtype=torch.float32,
                       device=feats.device)
    grid[flat] = feats[valid]
    x = grid.t().reshape(1, c, gz, gy, gx)
    mask = torch.zeros((gz * gy * gx,), dtype=torch.float32,
                       device=feats.device)
    mask[flat] = 1.0
    mask = mask.reshape(1, 1, gz, gy, gx)
    dims = (0, 2, 3, 4)
    pre = "pseudoimage_generator."

    def stage(i, x, mask):
        x = quant(F.conv3d(quant(x), quant(p[f"{pre}subm_{i}_kernel"]),
                           padding=1)) * mask
        x = F.relu(quant(batch_norm(x, mask, p, f"{pre}subm_bn_{i}", 1e-5,
                                    train, dims)))
        x = quant(F.conv3d(quant(x), quant(p[f"{pre}down_{i}_kernel"]),
                           stride=(2, 1, 1)))
        mask = F.max_pool3d(mask, (3, 1, 1), (2, 1, 1))
        return F.relu(quant(batch_norm(x, mask, p, f"{pre}down_bn_{i}",
                                       1e-5, train, dims))), mask

    for i in range(len(spec.middle)):
        if torch.is_grad_enabled():
            # the same arithmetic, its activations rebuilt in the backward
            # so that a full-size float32 step fits beside the program
            x, mask = checkpoint(stage, i, x, mask, use_reentrant=False)
        else:
            x, mask = stage(i, x, mask)
    b, c, d, h, w = x.shape
    return x.reshape(b, c * d, h, w)


def rpn(x, p, spec, train, quant):
    """The submanifold RPN: 3x3 convs under the pseudo-image's nonzero
    pixels, each masked, batch norm (eps 1e-3) and ReLU."""
    mask = (x != 0).any(dim=1, keepdim=True).float()
    n = sum(1 + k for k in spec.layer_nums)
    for li in range(n):
        x = quant(F.conv2d(quant(x),
                           quant(p[f"sparse_rpn.conv_{li}.weight"]),
                           padding=1)) * mask
        x = F.relu(quant(batch_norm(x, mask, p, f"sparse_rpn.bn_{li}", 1e-3,
                                    train, (0, 2, 3))))
    return x


def backbone_neck(x, p, spec, train, quant):
    """The strided backbone (per stage a 3x3 conv at the stage's stride
    and ``layer_nums`` more, each with batch norm over every site, eps
    1e-3, and ReLU) and the FPN neck (per scale a transposed conv of
    kernel = stride, batch norm, ReLU; the scales concatenated)."""
    one = torch.ones_like(x[:, :1])
    outs, li = [], 0
    for num, stride in zip(spec.layer_nums, spec.layer_strides):
        for j in range(1 + num):
            x = quant(F.conv2d(quant(x),
                               quant(p[f"backbone.conv_{li}.weight"]),
                               stride=stride if j == 0 else 1, padding=1))
            x = F.relu(quant(batch_norm(
                x, one[..., :x.shape[2], :x.shape[3]], p,
                f"backbone.bn_{li}", 1e-3, train, (0, 2, 3))))
            li += 1
        outs.append(x)
    ups = []
    for i, s in enumerate(spec.neck_strides):
        y = quant(F.conv_transpose2d(quant(outs[i]),
                                     quant(p[f"neck.deconv_{i}.weight"]),
                                     stride=s))
        ups.append(F.relu(quant(batch_norm(y, torch.ones_like(y[:, :1]), p,
                                           f"neck.bn_{i}", 1e-3, train,
                                           (0, 2, 3)))))
    return torch.cat(ups, 1)


def head(x, p, quant):
    """(cls, reg, dirs) of the 1x1 head, each (H*W*A, C) in the flat
    anchor order (cell-major, then the cell's anchors)."""
    outs = []
    for name, width in (("conv_cls", 1), ("conv_reg", 9), ("conv_dir", 6)):
        y = quant(F.conv2d(quant(x), quant(p[f"bbox_head.{name}.weight"]),
                           p[f"bbox_head.{name}.bias"]))
        outs.append(y[0].permute(1, 2, 0).reshape(-1, width))
    return tuple(outs)


def forward(batch_row, p, spec, train=False, quant=identity):
    """The network on one cloud: ``batch_row`` = (points (P, 4), n) ->
    (cls (N, 1), reg (N, 9), dirs (N, 6)) over the N anchors."""
    pts, n = batch_row
    voxels, cnt, coords, valid = voxelize(pts, n, spec)
    feats = pillar_features(voxels, cnt, coords, valid, p, spec, train,
                            quant)
    x = encoder(feats, coords, valid, p, spec, train, quant)
    if spec.dense_backbone:
        x = backbone_neck(x, p, spec, train, quant)
    else:
        x = rpn(x, p, spec, train, quant)
    return head(x, p, quant)


# ---------------------------------------------------------------------------
# anchors, decode, NMS
# ---------------------------------------------------------------------------
def anchors(spec, device):
    """(H*W*S*R, 9) anchors: cell centres from endpoint-inclusive
    linspaces over the anchor range (float32), crossed with the sizes and
    the rotation triples, in (y, x, size, rotation) order."""
    h, w = spec.featmap
    r = spec.anchor_range
    ys = np.linspace(r[1], r[4], h, dtype=np.float32)
    xs = np.linspace(r[0], r[3], w, dtype=np.float32)
    z0 = np.float32(np.linspace(r[2], r[5], 1, dtype=np.float32)[0])
    s, rr = len(spec.sizes), len(spec.rotations)
    out = np.zeros((h, w, s, rr, 9), np.float32)
    out[..., 0] = xs[None, :, None, None]
    out[..., 1] = ys[:, None, None, None]
    out[..., 2] = z0
    out[..., 3:6] = spec.sizes[None, None, :, None, :]
    out[..., 6:9] = spec.rotations[None, None, None, :, :]
    return torch.from_numpy(out.reshape(-1, 9)).to(device)


def decode(anc, deltas):
    """Boxes from anchors and deltas: xy by the anchor's BEV diagonal, z
    by its height (bottom to centre and back), log sizes, added angles."""
    diag = torch.sqrt(anc[:, 3] ** 2 + anc[:, 4] ** 2)
    za = anc[:, 2] + anc[:, 5] / 2
    dz = torch.exp(deltas[:, 5]) * anc[:, 5]
    return torch.stack([
        deltas[:, 0] * diag + anc[:, 0], deltas[:, 1] * diag + anc[:, 1],
        deltas[:, 2] * anc[:, 5] + za, torch.exp(deltas[:, 3]) * anc[:, 3],
        torch.exp(deltas[:, 4]) * anc[:, 4], dz,
        deltas[:, 6] + anc[:, 6], deltas[:, 7] + anc[:, 7],
        deltas[:, 8] + anc[:, 8]], -1)


def encode(anc, gt):
    """The deltas that :func:`decode` turns back into ``gt``."""
    diag = torch.sqrt(anc[:, 3] ** 2 + anc[:, 4] ** 2)
    za = anc[:, 2] + anc[:, 5] / 2
    zg = gt[:, 2] + gt[:, 5] / 2
    return torch.stack([
        (gt[:, 0] - anc[:, 0]) / diag, (gt[:, 1] - anc[:, 1]) / diag,
        (zg - za) / anc[:, 5], torch.log(gt[:, 3] / anc[:, 3]),
        torch.log(gt[:, 4] / anc[:, 4]), torch.log(gt[:, 5] / anc[:, 5]),
        gt[:, 6] - anc[:, 6], gt[:, 7] - anc[:, 7], gt[:, 8] - anc[:, 8]],
        -1)


def top_lowest_index(values, k):
    """The k largest values' indices, in descending value order, the lower
    index first among equal values."""
    order = torch.argsort(-values.double(), stable=True)
    return order[:k]


def greedy_nms(boxes, scores, score_thr, overlap):
    """Greedy NMS: candidates above ``score_thr`` in descending score
    order (lower index first among equal scores); each is kept unless a
    kept one overlaps it.  ``overlap`` (N, N) bool.  Returns (N,) bool."""
    n = boxes.shape[0]
    order = torch.argsort(-scores.double(), stable=True).tolist()
    ok = (scores > score_thr).tolist()
    ov = overlap.cpu().numpy()
    keep = np.zeros(n, bool)
    kept = []
    for i in order:
        if not ok[i]:
            continue
        if kept and ov[i, kept].any():
            continue
        keep[i] = True
        kept.append(i)
    return torch.from_numpy(keep).to(boxes.device)


def overlap_matrix(boxes, nms_thresh):
    """(N, N) bool suppression: any overlap (the separating-axis test) at
    or below an IoU threshold of 1e-4, else IoU above the threshold."""
    if nms_thresh <= 1e-4:
        return geometry.boxes_overlap(boxes, boxes)
    n = boxes.shape[0]
    b1 = boxes[:, None].expand(n, n, 9).reshape(-1, 9)
    b2 = boxes[None].expand(n, n, 9).reshape(-1, 9)
    return geometry.iou_aligned(b1, b2).reshape(n, n) > nms_thresh


def recover_rotation(boxes, bins):
    """Angles wrapped into [-pi, 0), then turned by pi where the direction
    bin is 1, per axis."""
    rot = boxes[:, 6:9]
    rot = rot - torch.floor(rot / math.pi + 1.0) * math.pi
    return torch.cat([boxes[:, :6], rot + math.pi * bins.float()], -1)


def detections(outs, anc, spec):
    """Decode + NMS of one cloud's head outputs -> dict of ``bbox`` (K,
    9), ``score`` (K,), ``label`` (K,), ``valid`` (K,) with K the
    configuration's ``max_detections``, kept boxes first by score; and
    what the output check measures the program's boxes against: every
    anchor's ``logit``, ``reg`` and ``anchor``, and the ``cut_logit`` of
    the ``nms_pre``-th candidate.
    """
    cls, reg, dirs = outs
    top = top_lowest_index(cls[:, 0], min(spec.nms_pre, len(cls)))
    raw = decode(anc[top], reg[top])
    scores = torch.sigmoid(cls[top, 0])
    bins = dirs[top].reshape(-1, 3, 2).argmax(-1)
    keep = greedy_nms(raw, scores, spec.score_thr,
                      overlap_matrix(raw, spec.nms_thresh))
    boxes = recover_rotation(raw, bins)
    kept_scores = torch.where(keep, scores, torch.full_like(scores, -1.0))
    k = min(spec.max_det, spec.nms_pre)
    sel = top_lowest_index(kept_scores, k)
    return {"bbox": boxes[sel], "score": kept_scores[sel],
            "label": torch.zeros_like(sel), "valid": kept_scores[sel] > 0,
            "logit": cls[:, 0], "reg": reg, "anchor": anc,
            "cut_logit": cls[top[-1], 0]}


def predict(points, n, p, spec, anc, quant=identity):
    """Eval-mode forward, decode and NMS of one cloud."""
    with torch.no_grad():
        return detections(forward((points, n), p, spec, False, quant), anc,
                          spec)


def param_shapes(spec):
    """{state-dict name: shape} of every parameter and running statistic
    of the network a configuration describes."""
    out = {}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = (c,)

    out["voxel_encoder.pfn_0.linear.weight"] = (spec.pfn_units, 9)
    bn("voxel_encoder.pfn_0.norm", spec.pfn_units)
    c = spec.pfn_units + 1
    pre = "pseudoimage_generator."
    for i, ch in enumerate(spec.middle):
        out[f"{pre}subm_{i}_kernel"] = (ch, c, 3, 3, 3)
        bn(f"{pre}subm_bn_{i}", ch)
        out[f"{pre}down_{i}_kernel"] = (ch, ch, 3, 1, 1)
        bn(f"{pre}down_bn_{i}", ch)
        c = ch
    c *= spec.depth_out
    li = 0
    stage_out = []
    for ch, num in zip(spec.rpn_channels, spec.layer_nums):
        for _ in range(1 + num):
            name = "backbone" if spec.dense_backbone else "sparse_rpn"
            out[f"{name}.conv_{li}.weight"] = (ch, c, 3, 3)
            bn(f"{name}.bn_{li}", ch)
            c = ch
            li += 1
        stage_out.append(ch)
    if spec.dense_backbone:
        for i, (ch, s) in enumerate(zip(spec.neck_channels,
                                        spec.neck_strides)):
            out[f"neck.deconv_{i}.weight"] = (stage_out[i], ch, s, s)
            bn(f"neck.bn_{i}", ch)
        c = sum(spec.neck_channels)
    a = spec.num_anchors
    for name, width in (("conv_cls", 1), ("conv_reg", 9), ("conv_dir", 6)):
        out[f"bbox_head.{name}.weight"] = (a * width, c, 1, 1)
        out[f"bbox_head.{name}.bias"] = (a * width,)
    return out


def _round_fp8(x, dtype, top):
    """``x`` rounded through ``dtype`` with one scale for the tensor (its
    largest magnitude to the format's largest, ``top``), and back."""
    amax = x.abs().amax().clamp(min=1e-30)
    return (x * (top / amax)).to(dtype).to(x.dtype) * (amax / top)


class _FP8(torch.autograd.Function):
    """Operands in float8 e4m3, their gradients in float8 e5m2: the
    forward and backward formats of float8 training."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, 57344.0)


def fp8(x):
    """The control's rounding of a convolution's or linear layer's operand,
    one precision below bfloat16: the operand through float8 e4m3, and its
    gradient, in a backward, through float8 e5m2, each with one scale for
    the tensor."""
    return _FP8.apply(x)
