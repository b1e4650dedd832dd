"""The numbers the output check compares, each a gap between what the
program's timed path produced and what the plain reference computes from
the same inputs and weights.  Their limits are data, one file per cell
(``portbench/limits/<cell>.json``); ``PERF.md`` gives the readings each
limit was set from."""

import math

import numpy as np
import torch


# program box x anchor x delta elements searched per chunk
_SEARCH_ELEMENTS = 6e8
# box sizes (m) below this read as this in the box gap
_MIN_SIZE = 1e-6
# the five losses of a step, summed to its total
LOSS_KEYS = ("loss_cls", "loss_bbox", "loss_dir_x", "loss_dir_y",
             "loss_dir_z")


def _wrap_pi(a):
    """Angles modulo pi, into [-pi/2, pi/2)."""
    return a - torch.floor(a / math.pi + 0.5) * math.pi


def gap_matrix(boxes, anchors, reg):
    """(P, A) gaps of P program boxes against A anchors' reference boxes,
    measured in the regression's own terms: the box's deltas against the
    anchor (xy over its BEV diagonal, the centre z over its height, log
    sizes, each size held at least ``_MIN_SIZE``, so that sizes that
    underflow on both sides agree) and its angles modulo pi (the direction
    bins are not compared), each less the reference's delta and over
    max(1, |reference delta|); the largest of the nine."""
    diag = torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2)
    za = anchors[:, 2] + anchors[:, 5] / 2
    ref_size = torch.log(torch.clamp(torch.exp(reg[:, 3:6]) * anchors[:, 3:6],
                                     min=_MIN_SIZE))
    p = boxes[:, None, :]
    g = torch.cat([torch.stack([
        (p[..., 0] - anchors[:, 0]) / diag - reg[:, 0],
        (p[..., 1] - anchors[:, 1]) / diag - reg[:, 1],
        (p[..., 2] - za) / anchors[:, 5] - reg[:, 2]], -1),
        torch.log(torch.clamp(p[..., 3:6], min=_MIN_SIZE)) - ref_size,
        _wrap_pi(p[..., 6:9] - anchors[:, 6:9] - reg[:, 6:9])], -1)
    return (g.abs() / torch.clamp(reg.abs(), min=1.0)).amax(-1)


def anchor_search(boxes, anchors, reg):
    """For each program box (P, 9), the anchor whose reference box is
    nearest by :func:`gap_matrix`: (gaps (P,), anchor indices (P,))."""
    gaps, idx = [], []
    chunk = max(1, int(_SEARCH_ELEMENTS // (9 * len(anchors))))
    for lo in range(0, len(boxes), chunk):
        best = gap_matrix(boxes[lo:lo + chunk], anchors, reg).min(1)
        gaps.append(best.values)
        idx.append(best.indices)
    if not gaps:
        return boxes.new_zeros((0,)), torch.zeros(
            (0,), dtype=torch.int64, device=boxes.device)
    return torch.cat(gaps), torch.cat(idx)


def cloud_numbers(prog, ref):
    """Gaps between one cloud's program detections and the reference's
    head: ``box_gap`` (the worst program box against the nearest
    reference box of any anchor), ``score_gap`` (its score against that
    anchor's), ``rank_gap`` (how far below the reference's candidate cut
    that anchor's logit lies, over max(1, |cut|)); and both sides' counts
    of detections (``kept``, ``detections``)."""
    dev = ref["logit"].device
    v = np.asarray(prog["valid"], bool).reshape(-1)
    pb = torch.as_tensor(np.asarray(prog["bbox"], np.float32).reshape(
        -1, 9)[v], device=dev)
    ps = torch.as_tensor(np.asarray(prog["score"], np.float32).reshape(
        -1)[v], device=dev)
    out = {"detections": int(ref["valid"].sum()), "kept": len(pb)}
    gaps, idx = anchor_search(pb, ref["anchor"], ref["reg"])
    logit = ref["logit"][idx]
    cut = ref["cut_logit"]
    out["box_gap"] = float(gaps.max()) if len(gaps) else 0.0
    out["score_gap"] = (float((ps - torch.sigmoid(logit)).abs().max())
                        if len(ps) else 0.0)
    out["rank_gap"] = (float(torch.clamp(
        (cut - logit) / torch.clamp(cut.abs(), min=1.0), min=0.0).max())
        if len(ps) else 0.0)
    return out


def count_gap(kept, detections):
    """How far the program's count of detections lies from the
    reference's, over the reference's: a program that drops detections,
    or keeps boxes that NMS should have removed, reads high."""
    return abs(kept - detections) / max(detections, 1)


def plot_numbers(dets, ref):
    """Gaps between a plot's merged program detections (tiled inference's
    list of dicts) and the reference's tiles: each program box is
    searched against every anchor of every tile, in that tile's frame;
    ``box_gap``, ``score_gap`` and ``rank_gap`` as for one cloud,
    ``count_gap`` of the merged counts."""
    tiles = ref["tiles"]
    dev = tiles[0]["logit"].device
    pb = torch.as_tensor(np.asarray([d["bbox"] for d in dets],
                                    np.float32).reshape(-1, 9), device=dev)
    ps = torch.as_tensor(np.asarray([d["score"] for d in dets],
                                    np.float32), device=dev)
    # a box that several tiles saw is judged by the tile that explains it
    # best: the larger of its box gap and its score gap is least there
    crit = torch.full((len(pb),), math.inf, device=dev)
    best = torch.zeros_like(crit)
    score = torch.zeros_like(crit)
    rank = torch.zeros_like(crit)
    for t in tiles:
        local = torch.cat([pb[:, :3] - t["shift"], pb[:, 3:]], -1)
        gaps, idx = anchor_search(local, t["anchor"], t["reg"])
        logit = t["logit"][idx]
        s = torch.sigmoid(logit)
        c = torch.maximum(gaps, (ps - s).abs())
        better = c < crit
        r = torch.nonzero(better)[:, 0]
        crit[r] = c[better]
        best[r] = gaps[better]
        score[r] = s[better]
        cut = t["cut_logit"]
        rank[r] = torch.clamp((cut - logit[better])
                              / torch.clamp(cut.abs(), min=1.0), min=0.0)
    n_ref = len(ref["bbox"])
    return {"count_gap": count_gap(len(pb), n_ref),
            "box_gap": float(best.max()) if len(pb) else 0.0,
            "score_gap": float((ps - score).abs().max()) if len(pb) else 0.0,
            "rank_gap": float(rank.max()) if len(pb) else 0.0,
            "detections": n_ref, "kept": len(pb)}


def predict_numbers(prog, ref):
    """{name: worst gap over the compared clouds}, and ``count_gap`` of
    their summed counts; ``prog`` and ``ref`` map a pool index to one
    cloud's detections."""
    if not ref or not set(ref) <= set(prog):
        return {"clouds_missing": float(len(set(ref) - set(prog)) or 1)}
    per = [cloud_numbers(prog[k], ref[k]) for k in sorted(ref)]
    out = {key: max(p[key] for p in per)
           for key in ("box_gap", "score_gap", "rank_gap")}
    for key in ("detections", "kept"):
        out[key] = sum(p[key] for p in per)
    out["count_gap"] = count_gap(out["kept"], out["detections"])
    out["clouds"] = len(per)
    return out


def leaf_gaps(prog, ref, floor_share=1e-3):
    """{leaf: the gap between its two norms}: |prog - ref| over the larger
    of the reference leaf's norm and the median leaf's, and the leaves
    left out: those whose reference norm is under ``floor_share`` of the
    median leaf's.  A leaf the program lacks reads 0."""
    med = float(np.median(np.asarray(list(ref.values()))))
    skipped = [k for k in ref if ref[k] < floor_share * med]
    return ({k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
             for k in ref if k not in skipped}, skipped)


def _total(losses):
    return sum(losses[k] for k in LOSS_KEYS)


def _loss_gap(a, b):
    return abs(_total(a) - _total(b)) / max(abs(_total(b)), 1e-12)


def train_numbers(prog, ref):
    """Gaps of the first steps: ``loss_gap``, the worst step's total loss
    (relative); ``grad_gap_median`` and ``change_gap_median``, the median
    leaf's gap of the first clipped gradient's norm and of the
    parameters' change after the steps."""
    p_loss, p_grad, p_change = prog
    r_loss, r_grad, r_change = ref
    grads, skipped = leaf_gaps(p_grad, r_grad)
    changes, _ = leaf_gaps(
        {k: v for k, v in p_change.items() if k not in skipped},
        {k: v for k, v in r_change.items() if k not in skipped})
    return {"loss_gap": max(_loss_gap(a, b) for a, b in zip(p_loss, r_loss)),
            "grad_gap_median": float(np.median(list(grads.values()))),
            "change_gap_median": float(np.median(list(changes.values()))),
            "_skipped": len(skipped)}


def last_step_numbers(prog, ref):
    """``last_change_gap``: the worst leaf's gap of the parameters'
    change over one step from the state the measured window left, both
    sides from the same parameters and optimizer state (leaves whose
    reference gradient is under a thousandth of the median leaf's left
    out)."""
    r_grad, r_change = ref
    _, skipped = leaf_gaps(r_grad, r_grad)
    changes, _ = leaf_gaps(
        {k: v for k, v in prog.items() if k not in skipped},
        {k: v for k, v in r_change.items() if k not in skipped})
    return {"last_change_gap": max(changes.values()),
            "_last_change_leaf": max(changes, key=changes.get),
            "_last_skipped": len(skipped)}
