"""Greedy multiclass NMS over a fixed-size candidate buffer.

Port of the JAX package's ``ops/nms.py``: the same keep set as the
reference's while-loop NMS, computed as a fixpoint in original index
space.

The fixpoint is a ``while_loop`` operator (``torch.ops.higher_order``),
so ``torch.export`` takes it as one node with its cond and body graphs
and the exported predict has no data-dependent control flow in Python.
Eager mode runs the same operator, whose loop reads its condition on the
host once per round (on CUDA a sync per round, as the Python loop did;
the counter ``nms.rounds`` counts the reads while a profiler records); a
predict free of host syncs, which a CUDA graph would need, is not built
yet.  The operator is called directly, with the suppression matrix
as an additional input: the public ``while_loop`` function compiles its
arguments with ``torch.compile`` on every eager call.

Tie order: within a class, candidates are ranked by a *stable* descending
sort of their scores, so among exactly equal scores the lower candidate
index ranks first (``jnp.argsort`` is stable too).  The candidates
themselves come from the detector's top-k, which also takes the lowest
anchor index first among equal logits (see ``models/detector.py``).
"""

import torch

from objectdetection_3d_tpu_torch.ops.boxes import (
    iou_aabb_2d,
    rotated_corners_2d_envelope,
)
from objectdetection_3d_tpu_torch.ops.iou3d import iou3d, obb_intersect
from objectdetection_3d_tpu_torch.profiling import count

# at or below this threshold "iou > thr" means "any overlap", which the
# exact SAT intersection test decides
_SAT_THRESH = 1e-4


def _keep_cond(it, kept, prev, s_upper, valid):
    count("nms.rounds")
    return (it < valid.shape[0]) & (kept != prev).any()


def _keep_body(it, kept, prev, s_upper, valid):
    blocked = (s_upper & kept[:, None]).any(dim=0)
    # the carried outputs may not alias the inputs
    return it + 1, valid & ~blocked, kept.clone()


def _greedy_keep(suppress, valid, rank):
    """Greedy suppression as a fixpoint iteration.

    Box j is kept iff it is valid and no kept higher-ranked box suppresses
    it.  Iterating ``kept <- valid & ~any(S_upper & kept)`` from
    ``kept = valid`` reaches the unique fixpoint within the longest
    suppression chain; the loop is capped at N iterations.
    """
    s_upper = (suppress
               & (rank[:, None] < rank[None, :])
               & valid[:, None])
    it = torch.zeros((), dtype=torch.int64, device=valid.device)
    _, kept, _ = torch.ops.higher_order.while_loop(
        _keep_cond, _keep_body, (it, valid.clone(), ~valid),
        (s_upper, valid))
    return kept


def multiclass_nms(boxes, scores, score_thr, iou_thr, nms_dim=3,
                   valid_mask=None):
    """Per-class greedy NMS.

    Args:
        boxes: (N, 9) decoded boxes.
        scores: (N, C) per-class scores (already sigmoided).
        score_thr: scalar score threshold.
        iou_thr: scalar IoU suppression threshold.
        nms_dim: 3 -> rotated-3D IoU (the SAT test at or below 1e-4,
            the exact clipper above); 2 -> rotated-corner AABB envelope
            IoU.
        valid_mask: optional (N,) bool of candidate validity.
    Returns:
        (N, C) bool keep matrix.
    """
    n, num_classes = scores.shape
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=boxes.device)

    if nms_dim == 3 and float(iou_thr) <= _SAT_THRESH:
        suppress = obb_intersect(boxes, boxes)
    elif nms_dim == 3:
        suppress = iou3d(boxes, boxes) > iou_thr
    else:
        env = rotated_corners_2d_envelope(boxes)
        suppress = iou_aabb_2d(env, env) > iou_thr

    keep = []
    idx = torch.arange(n, dtype=torch.int64, device=boxes.device)
    for c in range(num_classes):
        cls_scores = scores[:, c]
        valid = (cls_scores > score_thr) & valid_mask
        key = torch.where(valid, cls_scores,
                          torch.full_like(cls_scores, float("-inf")))
        order = torch.argsort(-key, stable=True)
        rank = torch.empty_like(idx).scatter_(0, order, idx)
        keep.append(_greedy_keep(suppress, valid, rank))
    return torch.stack(keep, dim=1)
