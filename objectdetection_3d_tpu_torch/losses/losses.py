"""Detection losses with padding-mask weights.

Port of the JAX package's ``losses/losses.py``.  An optional elementwise
``weight`` doubles as the padding mask.  Reduction contract:

* ``avg_factor`` given -> ``sum(loss) / avg_factor``;
* ``avg_factor`` None  -> ``mean(loss)``.
"""

import torch
import torch.nn.functional as F


def one_hot(index, classes):
    """(N,) int labels -> (N, classes) float one-hot; label == classes ->
    all zeros (background)."""
    out_idx = torch.arange(classes, device=index.device)[None, :]
    return (index[:, None] == out_idx).to(torch.float32)


def _reduce(loss, avg_factor):
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor


class FocalLoss:
    """Sigmoid focal loss."""

    def __init__(self, gamma=2.0, alpha=0.25, loss_weight=1.0):
        self.gamma = gamma
        self.alpha = alpha
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """
        Args:
            pred: (N, C) logits (or (N,) single-logit).
            target: (N,) int labels when pred is 2D (label == C means
                background / all-zero target), else (N,) float targets.
            weight: optional elementwise/broadcastable mask-weight.
        """
        pred_sigmoid = torch.sigmoid(pred)
        if pred.dim() > 1:
            target = one_hot(target, pred.shape[-1])
        target = target.to(pred.dtype)

        pt = (1 - pred_sigmoid) * target + pred_sigmoid * (1 - target)
        focal_weight = (self.alpha * target + (1 - self.alpha)
                        * (1 - target)) * pt ** self.gamma
        # numerically stable BCE-with-logits
        bce = (torch.clamp(pred, min=0) - pred * target
               + torch.log1p(torch.exp(-pred.abs())))
        loss = bce * focal_weight
        if weight is not None:
            loss = loss * weight
        loss = loss * self.loss_weight
        return _reduce(loss, avg_factor)


class SmoothL1Loss:
    """Piecewise smooth-L1."""

    def __init__(self, beta=1.0, loss_weight=1.0):
        self.beta = beta
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        diff = (pred - target).abs()
        loss = torch.where(diff < self.beta, 0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        if weight is not None:
            loss = loss * weight
        loss = loss * self.loss_weight
        return _reduce(loss, avg_factor)


class CrossEntropyLoss:
    """Softmax cross-entropy over discrete bins."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, weight=None, avg_factor=None):
        logp = F.log_softmax(cls_score, dim=-1)
        label_clipped = torch.clamp(label.long(), 0, cls_score.shape[-1] - 1)
        sel = (label_clipped[..., None] == torch.arange(
            cls_score.shape[-1], device=cls_score.device)).to(logp.dtype)
        loss = -(logp * sel).sum(dim=-1)
        if weight is not None:
            loss = loss * weight
        loss = loss * self.loss_weight
        return _reduce(loss, avg_factor)
