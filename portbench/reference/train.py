"""Plain PyTorch reference of one training step: the train-mode forward
of the configuration's architecture (``arch.forward``, see
:mod:`portbench.reference`), the target assignment, the three
losses, the backward, and AdamW after each gradient element is clipped
to ``[-clip, clip]``.

The assignment is the plain definition, evaluated exactly: an anchor's
overlap with a ground-truth box is their exact 3D IoU (the two boxes
rotated), computed for every pair whose axis-aligned envelopes meet (any
other pair has IoU 0).  An anchor is positive when its largest IoU
reaches the class's positive threshold, or when it reaches the largest
IoU of some box and that is at least the negative threshold; negative
when its largest IoU is below the negative threshold and it is not
positive; its target is the box of its largest IoU, the lowest box index
among equal ones.
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference import geometry

# GT boxes per slab of the pair search
_GT_SLAB = 8


def assign(anc, gt, spec):
    """Targets of one cloud: ``gt`` (G, 9) valid boxes -> dict of
    ``pos``, ``neg`` (N,) bool, ``best`` (N,) int64 and ``num_pos``."""
    n, dev = anc.shape[0], anc.device
    pos_thr, neg_thr = spec.iou_thr[1], spec.iou_thr[0]
    best_iou = torch.zeros((n,), dtype=torch.float32, device=dev)
    best = torch.zeros((n,), dtype=torch.int64, device=dev)
    a_lo, a_hi = geometry.aabb(anc)
    pairs = []
    g_lo, g_hi = geometry.aabb(gt)
    for g in range(gt.shape[0]):
        near = ((a_lo < g_hi[g]) & (a_hi > g_lo[g])).all(-1)
        idx = torch.nonzero(near)[:, 0]
        iou = geometry.iou_aligned(gt[g].expand(len(idx), 9), anc[idx])
        # boxes in index order: a later box takes an anchor only when
        # strictly better, so ties go to the lower index
        better = iou > best_iou[idx]
        best_iou[idx[better]] = iou[better]
        best[idx[better]] = g
        pairs.append((idx, iou))
    pos = best_iou >= pos_thr
    for idx, iou in pairs:
        row_max = iou.max() if len(iou) else torch.zeros((), device=dev)
        if row_max >= neg_thr:
            pos[idx[(iou >= row_max) & (iou > 0)]] = True
    neg = (best_iou < neg_thr) & ~pos
    return {"pos": pos, "neg": neg, "best": best,
            "num_pos": pos.sum()}


def losses(arch, outs, anc, gt, spec):
    """The five losses of one cloud, each summed and divided by
    max(positives, 1): sigmoid focal loss over positives and negatives,
    smooth L1 over the positives' deltas (angles by the sine of their
    difference), and the 2-bin direction cross-entropy per rotation axis
    over the positives."""
    cls, reg, dirs = outs
    t = assign(anc, gt, spec)
    pos, neg = t["pos"].float(), t["neg"].float()
    avg = torch.clamp(t["num_pos"].float(), min=1.0)

    f = spec.focal
    target = t["pos"].float()[:, None]
    p = torch.sigmoid(cls)
    pt = (1 - p) * target + p * (1 - target)
    fw = (f["alpha"] * target + (1 - f["alpha"]) * (1 - target)) \
        * pt ** f["gamma"]
    bce = F.binary_cross_entropy_with_logits(cls, target, reduction="none")
    loss_cls = (bce * fw * (pos + neg)[:, None]).sum() * f["loss_weight"] \
        / avg

    tgt_box = torch.where(t["pos"][:, None], gt[t["best"]], anc)
    tgt = arch.encode(anc, tgt_box)
    pred = torch.cat([reg[:, :6], torch.sin(reg[:, 6:]) *
                      torch.cos(tgt[:, 6:])], -1)
    want = torch.cat([tgt[:, :6], torch.cos(reg[:, 6:]) *
                      torch.sin(tgt[:, 6:])], -1)
    beta = spec.smooth_l1["beta"]
    d = (pred - want).abs()
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    loss_bbox = (sl1 * pos[:, None]).sum() * spec.smooth_l1["loss_weight"] \
        / avg

    rot = gt[t["best"]][:, 6:9]
    wrapped = rot - torch.floor(rot / (2 * math.pi)) * 2 * math.pi
    bins = torch.remainder(torch.floor(wrapped / math.pi).long(), 2)
    logp = F.log_softmax(dirs.reshape(-1, 3, 2), dim=-1)
    ce = -logp.gather(-1, bins[..., None])[..., 0]           # (N, 3)
    dir_loss = (ce * pos[:, None]).sum(0) * spec.dir_weight / avg
    return ({"loss_cls": loss_cls, "loss_bbox": loss_bbox,
             "loss_dir_x": dir_loss[0], "loss_dir_y": dir_loss[1],
             "loss_dir_z": dir_loss[2]}, t["num_pos"])


class AdamW:
    """AdamW (decoupled weight decay applied first) over a dict of float32
    parameters, each gradient element clipped to ``[-clip, clip]``
    first."""

    def __init__(self, params, lr, betas, weight_decay, clip, eps=1e-8):
        self.lr, self.betas, self.wd, self.clip, self.eps = (
            lr, betas, weight_decay, clip, eps)
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k].clamp(-self.clip, self.clip)
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train_step(arch, params, stats, opt, points, n, gt, anc, spec, quant):
    """One step of the architecture ``arch`` on one cloud: ``params``
    (trainable, float32) are updated in place; ``stats`` holds the running
    statistics, which the train-mode forward does not read.  Returns ({loss
    name: float}, num_pos, {name: the clipped gradient the optimizer
    took})."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    outs = arch.forward((points, n), {**stats, **leaves}, spec, True, quant)
    parts, num_pos = losses(arch, outs, anc, gt, spec)
    total = sum(parts.values())
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g)
             for (k, v), g in zip(leaves.items(), grads)}
    opt.step(params, grads)
    return ({k: float(v.detach()) for k, v in parts.items()}, int(num_pos),
            {k: g.clamp(-opt.clip, opt.clip) for k, g in grads.items()})
