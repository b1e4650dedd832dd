"""Precision / recall evaluation of batched detections.

The port's copy of the JAX package's ``metrics.py``, with the same
matching rules:

* a prediction is a true positive iff its IoU with some target reaches
  ``min_overlap`` AND it is the best-matching (arg-max IoU) prediction of at
  least one target; every other above-threshold match counts as a false
  positive,
* false negatives are targets whose column never reaches ``min_overlap``,
* precision / recall are reported in percent per class.

IoU is the exact rotated-3D IoU for ``eval_dim == 3`` (the port's
``ops/iou3d.iou3d``, the clipper of the JAX package's Pallas body) and the
rotated-corner-envelope AABB IoU for ``eval_dim == 2``.  The JAX package's
metrics use its XLA clipper instead, so ROADMAP C4 applies: a pair of
boxes that only touch can clip to ~1e-7 in one clipper and to 0 in the
other.  No threshold in use lies that close to 0.  The pairwise IoU pads
its inputs to power-of-two buckets, as the JAX package does.
"""

import numpy as np
import torch

from objectdetection_3d_tpu_torch.ops.boxes import (
    iou_aabb_2d,
    rotated_corners_2d_envelope,
    validate_boxes,
)
from objectdetection_3d_tpu_torch.ops.iou3d import iou3d


def _bucket(n, minimum=16):
    b = minimum
    while b < n:
        b *= 2
    return b


class MetricEvaluator:
    """Batched precision/recall evaluator; the pairwise IoU runs on
    ``device`` (the CPU unless given)."""

    def __init__(self, eval_dim=3, device="cpu"):
        self.eval_dim = eval_dim
        self.device = torch.device(device)

    def _overlap(self, pred_boxes, target_boxes):
        """Padded pairwise IoU -> (P, T) numpy."""
        p, t = len(pred_boxes), len(target_boxes)
        if p == 0 or t == 0:
            return np.zeros((p, t), np.float32)
        pb = _bucket(p)
        tb = _bucket(t)
        pp = np.zeros((pb, 9), np.float32)
        pp[:p] = pred_boxes
        tt = np.zeros((tb, 9), np.float32)
        tt[:t] = target_boxes
        pp = torch.from_numpy(pp).to(self.device)
        tt = torch.from_numpy(tt).to(self.device)
        with torch.no_grad():
            if self.eval_dim == 3:
                iou = iou3d(pp, tt)
            else:
                iou = iou_aabb_2d(rotated_corners_2d_envelope(pp),
                                  rotated_corners_2d_envelope(tt))
        return iou.cpu().numpy()[:p, :t]

    @staticmethod
    def filter_data(data, labels):
        """Select entries whose label is in ``labels``."""
        lab = np.asarray(data["label"])
        cond = np.isin(lab, [l for l in labels if l is not None])
        idx = np.where(cond)[0]
        return {k: np.asarray(v)[idx] for k, v in data.items()}, idx

    def precision_recall_evaluation(self, pred, target, classes,
                                    min_overlap=(0.1,)):
        """Per-cloud detection quantities.

        Returns:
            detection: (num_classes, P, 3) of (score, tp, fp) rows
            fns: (num_classes, 1) false-negative counts
        """
        pred, _ = self.filter_data(pred, classes)
        target, _ = self.filter_data(target, classes)

        detection = np.zeros((len(classes), len(pred["bbox"]), 3),
                             np.float32)
        fns = np.zeros((len(classes), 1), np.int64)

        if pred["bbox"].shape[0] == 0:
            for i, label in enumerate(classes):
                fns[i] = len(self.filter_data(target, [label])[1])
            return detection, fns

        overlap = self._overlap(pred["bbox"], target["bbox"])

        for i, label in enumerate(classes):
            _, pred_idx_l = self.filter_data(pred, [label])
            _, target_idx_l = self.filter_data(target, [label])
            overlap_label = overlap[np.ix_(pred_idx_l, target_idx_l)] \
                if len(target_idx_l) else overlap[pred_idx_l][:, :0]

            if len(pred_idx_l) > 0:
                if overlap_label.shape[1] > 0:
                    false_positive = (
                        overlap_label < min_overlap[i]).all(axis=1)
                    match_cond = np.any(
                        overlap_label >= min_overlap[i], axis=-1)
                else:
                    false_positive = np.ones(len(pred_idx_l), bool)
                    match_cond = np.zeros(len(pred_idx_l), bool)
                # every match starts as a false positive ...
                false_positive = false_positive.astype(np.float32)
                false_positive[match_cond] = 1

                true_positive = np.zeros((len(pred_idx_l),), np.float32)
                if len(target_idx_l) > 0:
                    max_idx = np.argmax(overlap_label, axis=0)
                    max_cond = np.isin(np.arange(overlap_label.shape[0]),
                                       max_idx)
                else:
                    max_cond = np.zeros(len(pred_idx_l), bool)

                # ... and only the best match of a target becomes a TP
                global_cond = np.logical_and(max_cond, match_cond)
                true_positive[global_cond] = 1
                false_positive[global_cond] = 0

                if overlap_label.shape[1] > 0:
                    fns[i] = np.sum(
                        np.all(overlap_label < min_overlap[i], axis=0))
                else:
                    fns[i] = 0

                scores = np.asarray(pred["score"])[pred_idx_l]
                detection[i, pred_idx_l] = np.stack(
                    [scores, true_positive, false_positive], axis=-1)
            else:
                fns[i] = len(target_idx_l)

        return detection, fns

    def evaluate(self, pred, target, classes, min_overlap, validate=False):
        """Aggregate precision/recall over a list of clouds.

        Args:
            pred: list of dicts {'bbox' (P,9), 'label' (P,), 'score' (P,)}.
            target: list of dicts {'bbox' (T,9), 'label' (T,)}.
            classes: list of class ids.
            min_overlap: list of IoU thresholds (len 1 or len(classes)).
            validate: host-side degenerate-box checks on every cloud's
                pred/target boxes before any IoU (``validate_boxes``,
                which raises ``ValueError``).
        Returns:
            (precision, recall): (num_classes, 1) arrays in percent.
        """
        if validate:
            for group in (pred, target):
                for cloud in group:
                    validate_boxes(cloud["bbox"])
        if len(min_overlap) != len(classes):
            if len(min_overlap) != 1:
                raise ValueError("min_overlap needs one threshold, or one "
                                 "per class")
            min_overlap = list(min_overlap) * len(classes)

        cnt = 0
        box_cnts = [0]
        for p in pred:
            cnt += len(self.filter_data(p, classes)[1])
            box_cnts.append(cnt)

        detection = np.zeros((len(classes), box_cnts[-1], 3), np.float32)
        fns = np.zeros((len(classes), 1), np.int64)
        for i in range(len(pred)):
            d, f = self.precision_recall_evaluation(
                pred=pred[i], target=target[i], classes=classes,
                min_overlap=min_overlap)
            detection[:, box_cnts[i]:box_cnts[i + 1]] = d
            fns += f

        recall = np.zeros((len(classes), 1), np.float64)
        precision = np.zeros((len(classes), 1), np.float64)
        for i in range(len(classes)):
            tp = detection[i, :, 1].sum()
            fp = detection[i, :, 2].sum()
            with np.errstate(invalid="ignore", divide="ignore"):
                recall[i] = 100 * tp / (tp + fns[i])
                precision[i] = 100 * tp / (tp + fp)
        return precision, recall
