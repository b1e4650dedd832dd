#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--quick]

``--quick`` runs phases 1-2, then K10 on cloud 0's stage 0-1 inputs, K1
on clouds 0-3, K3/K4 on cloud 0's GT chunks 0-1 and K5 on both of its
inputs against their plain versions, timed as in phases 3, 7 and 10, and
stops: the short first call after a kernel change.

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit from ``nvidia-smi``;
2. build: compiles every CUDA kernel of the path from ``csrc/`` (one
   ``nvcc`` per source, all started together) and prints the build time;
3. kernels: at flagship shapes, each kernel against its plain PyTorch
   version on the same inputs, bit-exact, with both timed by CUDA events
   (K1 at B = 1 and B = 4, also replayed from a CUDA graph; K2 in bf16
   and float32);
4. voxelizer: the kernel path on the card against the plain path on the
   CPU for one cloud, every output exact;
5. predict: the flagship ``PointPillars`` (100x400x400 grid, 12 anchors per
   cell, bf16) with the trained ``artifacts/overfit_ckpt.npz`` on four
   100k-point clouds; outputs must be finite and every kernel of the path
   must have launched;
6. float32: one cloud again in float32 (TF32 off), and how many of its
   detections the bf16 run matches (information, not a gate);
7. assignment kernels: K3 and K4 bit-exact, K6 and K7 within 1e-5 of
   IoU, each against its plain version on cloud 0's real assignment
   inputs (128 padded GT boxes, 1.92 M anchors, K = 512), both timed
   (K3 on GT chunk 0, with 12 trees, and on chunk 1, whose 16 rows are
   all padding, and over the step's 8 chunks back to back; K4 on both
   chunks under each row's own containment maximum and under the row
   maxima and rescue flags of cloud 0's flagship assignment, with the
   live (GT, combo) pairs counted, and over the assignment's 8 chunks);
   every pair that the plain separating-plane test clears is exactly 0
   from K6/K7 and from their plain versions, and their bounds count the
   least work of these pairs: the test, and the clip of what it leaves
   by the plain clipper's live ring counts (beside the bound of clipping
   every pair on the TPU body's fixed schedule);
8. assignment: the flagship assignment of cloud 0 through the kernels
   and through their plain versions, both on the card: masks, labels,
   direction targets and ``best_gt`` under ``pos_mask`` equal, and
   ``num_pos`` > 0; then again with ``assign_exact_anchor_tier: false``:
   equal, K7 not launched, and no more positives than the default;
9. train: the flagship (bf16, B = 1) from the trained npz with AdamW (lr
   1e-3, betas (0.95, 0.99), weight decay 0.01, gradient value clip 2.0):
   one warm-up step, then 3 timed steps on clouds 1-3; every loss finite,
   ``num_pos`` > 0, parameters and running statistics changed, and all
   six kernels launched during the timed steps; then one more step of
   the same step function under ``torch.profiler``, its device time split
   by the step's own phase ranges (forward, assignment, loss + backward,
   optimizer);
10. encoder kernels: K10 (stages 0-1), K9 (stages 0-2, forward, and the
    backward's dx and dw), K8 (stages 0-2) on cloud 0's real stage inputs
    with the npz weights, each against its plain version in float32
    (TF32 off; within 1e-3 of the largest element) and in bf16 (within
    1e-2), timed beside its bound and cuDNN's conv (K9 per stage and
    direction, with its share of the bound; K10 per stage beside K8 on
    the same stage); and K5 on 1.92 M
    aligned pairs, each flagship anchor against a random tree of cloud 0
    (the drive) and against a jittered copy of itself (dense), within
    1e-5 of the volume scale and exactly 0 wherever the plain
    separating-plane test clears both directions, timed in a CUDA graph
    and eager beside its bound, then driven once as the JAX package's
    ``tools/profile_assign.py`` drives it;
11. predict under the lowering knobs: four clouds with ``fused_stages``
    (K8 exactly 3 launches per cloud) and four with ``pallas_subm_conv``
    and ``zfold_pallas`` (K10 2 and K9 1 per cloud), outputs finite,
    and whether K10's inputs there are contiguous (its wrapper's
    ``contiguous()`` then copies nothing);
    cloud 0 in float32 under each knob set, whose pseudo-image must lie
    within 1e-3 of the largest element of the default path's; the bf16
    detections' agreement with the default path (information);
12. train with ``zfold_pallas``: one warm-up step, then 2 timed steps;
    losses finite, ``num_pos`` > 0, every parameter and running statistic
    changed, K9 exactly 3 forward and 3 dx launches per step.

The last lines are the ``kernels`` JSON line (all ten kernels), the card
line and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from objectdetection_3d_tpu_torch.timing import (
    cuda_ms,
    graph_ms,
    kernel_split_ms,
)

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "artifacts", "overfit_ckpt.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# float32 operations (arithmetic, compares, min/max) counted from the
# kernel bodies: per (GT, anchor) pair of K3 and of K4
K3_OPS_PER_PAIR = 128
K4_OPS_PER_PAIR = 53
# K4's work on the pairs it does not skip: per (cell, live (GT, combo))
# the three in_a tests (sum, abs, compare) where the anchor can fit, the
# three in_b tests (two differences, abs, compare) where the GT can; per
# (GT, cell) the cell centre on the GT's axes, per (cell, combo) on the
# combo's (9 products, 6 sums each)
K4_IN_A_OPS = 9
K4_IN_B_OPS = 12
K4_BASE_OPS = 18
K4_COV_OPS = 15
# K5-K7's clip on the TPU body's fixed ring schedule, every pair clipped:
# 12 polygons, per plane slot 23 ops over the 49 slots of the schedule, 16
# per fan triangle, and 560 for the two boxes' corners, planes and the IoU
# (``bound_all_pairs_ms``)
CLIP_OPS_PER_PAIR = 12 * (49 * 23 + 10 * 16) + 560
# The least work of K5-K7 on this run's pairs (``bound_ms``), counted from
# csrc/iou3d_clip.cu with a sine-cosine pair as one operation: a box's
# frame (3 sine-cosine pairs, the 21 of its rotation, the 51 of its six
# planes); per pair the extent test of both directions (18 per axis for the
# centres and half sizes, 10 per axis pair for the extents, 13 per plane),
# which decides a far pair; per open direction (one the plain test does
# not clear) its box's 8 corners (23 each) and the sums of its 6 face
# totals; and, from the plain clipper's own ring counts on these pairs
# (``ops/iou3d.clip_work``), per live ring vertex entering a plane 8 (its
# plane value and two compares), per crossing point kept 15 (the guarded
# quotient, its clamp, the point) and per fan triangle 16.  K6/K7 add
# their IoU per listed pair.  The corner test that K5-K7 run where the
# extent test does not decide is not counted, so this is a lower count.
FRAME_OPS = 3 + 21 + 51
EXTENT_OPS = 3 * 18 + 9 * 10 + 2 * 6 * 13
DIRECTION_OPS = 8 * 23 + 6
SLOT_OPS = 8
CROSSING_OPS = 15
FAN_OPS = 16
IOU_OPS = 11


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def kernel_label(name):
    """A profiler kernel name without its return type and namespace."""
    for noise in ("void ", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:28]


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the card's peak for their type (float32
    unless given)."""
    by_bytes = bytes_ms(nbytes)
    by_ops = ops / ops_per_s * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"


def clip_ops(boxes1, boxes2, cleared):
    """(operations, open directions): the least float32 work of the clip
    of aligned pairs on the directions ``cleared`` leaves open, from the
    plain clipper's ring counts (the test's work apart)."""
    from objectdetection_3d_tpu_torch.ops.iou3d import clip_work

    work = clip_work(boxes1, boxes2, cleared)
    ops = (DIRECTION_OPS * work["directions"] + SLOT_OPS * work["slots"]
           + CROSSING_OPS * work["crossings"] + FAN_OPS * work["triangles"])
    return ops, work["directions"]


def centre_matches(out_a, out_b):
    """How many of ``out_a``'s valid detections of item 0 have one of
    ``out_b``'s within 0.5 m in xy."""
    ca = out_a["bbox"][0][out_a["valid"][0]][:, :2]
    cb = out_b["bbox"][0][out_b["valid"][0]][:, :2]
    if not (len(ca) and len(cb)):
        return 0
    return int((torch.cdist(ca, cb).min(dim=1).values < 0.5).sum())


CONV_GATES = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def gated(label, pairs):
    """Hold each (got, want) of ``pairs`` {dtype: [(got, want), ...]}
    within CONV_GATES[dtype] of want's largest element; returns the bf16
    max abs error and prints both types' relative errors."""
    out = {}
    for dt, items in pairs.items():
        worst = 0.0
        for got, want in items:
            err = max_abs_err(got, want)
            scale = float(want.double().abs().max())
            if not err <= CONV_GATES[dt] * scale:
                raise AssertionError(f"{label} ({dt}) differs from its "
                                     f"plain version by {err} (scale "
                                     f"{scale})")
            worst = max(worst, err / scale)
            out[dt] = max(out.get(dt, 0.0), err)
        print(f"  {label} {str(dt)[6:]}: max rel err {worst:.3g}",
              flush=True)
    return out[torch.bfloat16]


def stage_inputs(model, batch, stages):
    """Cloud ``batch``'s vertical-encoder inputs (x NCDHW, mask) of the
    first ``stages`` stages, through the model's own stages."""
    enc = model.net.pseudoimage_generator
    seen = {}
    hook = enc.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("args", args))
    try:
        model.predict(batch)
    finally:
        hook.remove()
    grid, mask = seen["args"]
    x, mask = grid.to(enc.dtype), mask.to(enc.dtype)
    out = []
    with torch.inference_mode():
        for i in range(stages):
            out.append((x, mask))
            x, mask = enc.stage(i, x, mask)
    return out


def subm_conv_stages(enc, ins):
    """K10 on the subm convs of stages 0 and 1, on cloud 0's real stage
    inputs ``ins``: each held against its plain version in float32 (TF32
    off) and bf16, then timed beside its bound and cuDNN's conv.  Returns
    the per-stage rows."""
    import torch.nn.functional as F

    from objectdetection_3d_tpu_torch.ops.pallas_conv import (
        subm_conv3d,
        subm_conv3d_plain,
    )

    rows = []
    for i in (0, 1):
        x, _ = ins[i]
        xn = x.permute(0, 2, 3, 4, 1)
        kern = getattr(enc, f"subm_{i}_kernel").detach()
        k5 = kern.permute(2, 3, 4, 1, 0)
        pairs = {}
        for dt in (torch.float32, torch.bfloat16):
            xi = xn.to(dt)
            pairs[dt] = [(subm_conv3d(xi, k5), subm_conv3d_plain(xi, k5))]
        torch.cuda.synchronize()
        err = gated(f"K10 stage {i}", pairs)
        del pairs
        b, d, h, w, c = xn.shape
        co = k5.shape[-1]
        klib = kern.to(x.dtype)
        b_ms, b_by = bound(2 * b * d * h * w * (c + co) + 54 * c * co,
                           2 * 27 * c * co * b * d * h * w,
                           BF16_TC_OPS_PER_S)
        ms = cuda_ms(lambda: subm_conv3d(xn, k5), 10)
        rows.append({
            "stage": i, "shape": [b, d, h, w, c, co], "max_abs_err": err,
            "ms": ms,
            "plain_ms": cuda_ms(lambda: subm_conv3d_plain(xn, k5), 1),
            "library_ms": cuda_ms(lambda: F.conv3d(x, klib, padding=1), 10),
            "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
            # the wrapper's x.contiguous() copies nothing when this holds
            "input_contiguous": xn.is_contiguous()})
    return rows


def geometry_kernels(model, geom, gt_mask, batch):
    """K3 and K4 on cloud 0's flagship tables (``geometry_tier``'s
    ``geom``): K3 bit-exact on chunk 0 (12 trees and 4 masked rows) and
    chunk 1 (16 masked rows) and timed on both and on the step's 8 chunks
    back to back; K4 as :func:`rescue_entry` says (``batch`` is cloud 0).
    Returns their kernel entries."""
    from objectdetection_3d_tpu_torch.ops.assign_geometry import (
        chunk_geometry,
        chunk_geometry_plain,
    )
    from objectdetection_3d_tpu_torch.scene import MAX_GT

    combo, cells = model.combo_tab, model.anchor_layout[0]
    n_cell, m_combo = cells.shape[0], combo.shape[1]
    n_anchor = n_cell * m_combo
    chunk_args = [(ftab, gid.int(), tabs, combo, cells, MAX_GT)
                  for (ftab, tabs), gid in zip(geom["tables"],
                                               geom["chunks"])]
    timed = {}
    for c in (0, 1):
        args = chunk_args[c]
        got = chunk_geometry(*args)
        want = chunk_geometry_plain(*args)
        torch.cuda.synchronize()
        for key in want:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"chunk_geometry output {key!r} differs "
                                     f"from its plain version on chunk {c}")
        real = int((args[0][:, 16] > 0).sum())
        gch = args[0].shape[0]
        # tables and cells read once; key, 9 per-anchor outputs, rmax
        # written; the pair geometry of the chunk's unmasked rows
        nbytes = 4 * (n_cell * 3 + gch * 18 + 12 * gch * m_combo
                      + 16 * m_combo + gch * n_anchor + 9 * n_anchor
                      + gch * n_cell)
        b_ms, b_by = bound(nbytes, K3_OPS_PER_PAIR * real * n_anchor)
        timed[c] = {"ms": graph_ms(lambda: chunk_geometry(*args), 10),
                    "eager_ms": cuda_ms(lambda: chunk_geometry(*args), 20),
                    "bound_ms": b_ms, "bound_by": b_by, "rows": real,
                    "inside": int((got["cm"] > 0).sum())}
        del got, want
    entry = {
        "name": "chunk_geometry", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/assign_geometry.cu",
        "replaces": "objectdetection_3d_tpu/ops/assign_geometry.py:358",
        "max_abs_err": 0.0, "ms": timed[0]["ms"],
        "eager_ms": timed[0]["eager_ms"],
        "plain_ms": cuda_ms(lambda: chunk_geometry_plain(*chunk_args[0]), 3),
        "bound_ms": timed[0]["bound_ms"], "bound_by": timed[0]["bound_by"],
        "library_ms": None, "share": timed[0]["bound_ms"] / timed[0]["ms"],
        "ms_padding_chunk": timed[1]["ms"],
        "eager_ms_padding_chunk": timed[1]["eager_ms"],
        "bound_padding_chunk_ms": timed[1]["bound_ms"],
        "k3_step_ms": graph_ms(lambda: [chunk_geometry(*a)
                                        for a in chunk_args], 2),
        "k3_step_eager_ms": cuda_ms(lambda: [chunk_geometry(*a)
                                             for a in chunk_args], 10),
        "chunks_per_step": len(chunk_args)}
    k4 = rescue_entry(model, geom, gt_mask, batch)
    print(f"K3 chunk_geometry N={n_anchor}: bit-exact on all 11 outputs of "
          f"chunk 0 ({timed[0]['rows']} trees, {timed[0]['inside']} anchors "
          f"inside one) and chunk 1 ({timed[1]['rows']} unmasked rows); "
          f"{entry['ms']:.4f} ms in a CUDA graph ({entry['eager_ms']:.4f} "
          f"eager; bound {entry['bound_ms']:.4f}, share "
          f"{entry['share']:.3f}) vs plain {entry['plain_ms']:.4f} ms; "
          f"masked chunk {entry['ms_padding_chunk']:.4f} ms "
          f"({entry['eager_ms_padding_chunk']:.4f} eager; bound "
          f"{entry['bound_padding_chunk_ms']:.4f}); the step's "
          f"{len(chunk_args)} chunks {entry['k3_step_ms']:.4f} ms "
          f"({entry['k3_step_eager_ms']:.4f} eager)", flush=True)
    return {"chunk_geometry": entry, "containment_rescue": k4}


def assignment_rescue_args(model, batch):
    """The arguments of every K4 launch of ``batch``'s flagship assignment:
    the chunks' tables with the row maxima and rescue flags that the
    assignment computes (its candidate, tier and containment maxima)."""
    from objectdetection_3d_tpu_torch.models import assign

    calls = []
    init = assign._Kernels.__init__

    def recording(kernels, plain):
        init(kernels, plain)
        launch = kernels.rescue

        def record(*args):
            calls.append(tuple(a.clone() for a in args))
            return launch(*args)

        kernels.rescue = record

    assign._Kernels.__init__ = recording
    try:
        model.assign(batch)
    finally:
        assign._Kernels.__init__ = init
    return calls


def rescue_entry(model, geom, gt_mask, batch):
    """K4 on cloud 0's GT chunks 0 (12 trees) and 1 (all padding), each
    under two sets of thresholds: each row's own containment maximum
    (``cont_row_max``, rescue on the trees) and the row maxima and rescue
    flags of the flagship assignment itself.  Bit-exact against the plain
    version on all four; timed in a CUDA graph and eager on both chunks
    (own maxima) and over the step's 8 chunks (the assignment's); the
    bound counts the tests of the live (GT, combo) pairs, beside the bound
    of every pair in full.  Returns the kernel entry."""
    from objectdetection_3d_tpu_torch.ops.assign_geometry import (
        containment_rescue,
        containment_rescue_plain,
        rescue_flags,
    )

    combo, cells = model.combo_tab, model.anchor_layout[0]
    n_cell, m_combo = cells.shape[0], combo.shape[1]
    n_anchor = n_cell * m_combo
    real = assignment_rescue_args(model, batch)
    own = []
    for (ftab, tabs), gid in zip(geom["tables"], geom["chunks"]):
        rthr = torch.stack([geom["cont_row_max"][gid],
                            gt_mask[gid].float()], dim=1).contiguous()
        own.append((ftab, rthr, tabs, combo, cells))
    rows = {}
    for label, calls in (("own", own), ("assignment", real)):
        for c in (0, 1):
            args = calls[c]
            hit = containment_rescue(*args)
            if not torch.equal(hit, containment_rescue_plain(*args)):
                raise AssertionError(f"containment_rescue differs from its "
                                     f"plain version on chunk {c} under the "
                                     f"{label} thresholds")
            ftab, rthr, tabs = args[:3]
            flags = rescue_flags(ftab, rthr, tabs, combo)
            live = (flags & 3) != 0
            n_a = int((flags & 4).bool().sum())
            n_b = int((flags & 2).bool().sum())
            gts_a = int((flags & 4).bool().any(dim=1).sum())
            combos_b = int((flags & 2).bool().any(dim=0).sum())
            gch = ftab.shape[0]
            # tables and cells read once, the (N,) flags written once
            nbytes = 4 * (n_cell * 3 + n_anchor + gch * 19
                          + 12 * gch * m_combo + 16 * m_combo)
            ops = n_cell * (K4_IN_A_OPS * n_a + K4_IN_B_OPS * n_b
                            + K4_BASE_OPS * gts_a + K4_COV_OPS * combos_b)
            b_ms, b_by = bound(nbytes, ops)
            all_ms, _ = bound(nbytes, K4_OPS_PER_PAIR * gch * n_anchor)
            rows[(label, c)] = {
                "live_pairs": int(live.sum()), "in_a_pairs": n_a,
                "in_b_pairs": n_b, "rescue_rows": int((rthr[:, 1] > 0).sum()),
                "hits": int(hit.sum()), "bound_ms": b_ms, "bound_by": b_by,
                "bound_all_pairs_ms": all_ms}
            print(f"K4 chunk {c}, {label} thresholds: bit-exact, "
                  f"{rows[(label, c)]['hits']} hits; live (GT, combo) pairs "
                  f"{rows[(label, c)]['live_pairs']} of {gch * m_combo} "
                  f"(in_a tested {n_a}, in_b {n_b}; rescue rows "
                  f"{rows[(label, c)]['rescue_rows']}); bound {b_ms:.5f} ms "
                  f"({b_by}), all pairs {all_ms:.5f}", flush=True)
    for (label, c), row in rows.items():
        args = (own if label == "own" else real)[c]
        row["ms"] = graph_ms(lambda args=args: containment_rescue(*args), 10)
        row["eager_ms"] = cuda_ms(lambda args=args: containment_rescue(*args),
                                  20)
    main = rows[("own", 0)]
    k4 = {
        "name": "containment_rescue", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/assign_geometry.cu",
        "replaces": "objectdetection_3d_tpu/ops/assign_geometry.py:423",
        "max_abs_err": 0.0, "ms": main["ms"], "graph_ms": main["ms"],
        "eager_ms": main["eager_ms"],
        "plain_ms": cuda_ms(lambda: containment_rescue_plain(*own[0]), 3),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bound_all_pairs_ms": main["bound_all_pairs_ms"],
        "library_ms": None, "share": main["bound_ms"] / main["ms"],
        "ms_padding_chunk": rows[("own", 1)]["ms"],
        "eager_ms_padding_chunk": rows[("own", 1)]["eager_ms"],
        "bound_padding_chunk_ms": rows[("own", 1)]["bound_ms"],
        "k4_step_ms": graph_ms(lambda: [containment_rescue(*a)
                                        for a in real], 2),
        "k4_step_eager_ms": cuda_ms(lambda: [containment_rescue(*a)
                                             for a in real], 10),
        "chunks_per_step": len(real),
        "chunks": [{"thresholds": label, "chunk": c, **row}
                   for (label, c), row in rows.items()]}
    print(f"K4 containment_rescue N={n_anchor}: chunk 0 {k4['ms']:.4f} ms in "
          f"a CUDA graph ({k4['eager_ms']:.4f} eager; bound "
          f"{k4['bound_ms']:.5f}, all pairs {k4['bound_all_pairs_ms']:.4f}, "
          f"share {k4['share']:.3f}) vs plain {k4['plain_ms']:.4f} ms; "
          f"padding chunk {k4['ms_padding_chunk']:.4f} ms "
          f"({k4['eager_ms_padding_chunk']:.4f} eager); under the "
          f"assignment's thresholds chunk 0 "
          f"{rows[('assignment', 0)]['ms']:.4f} ms; the step's "
          f"{len(real)} chunks {k4['k4_step_ms']:.4f} ms "
          f"({k4['k4_step_eager_ms']:.4f} eager)", flush=True)
    return k4


def scan_entry(model, batches):
    """K1 on the sorted cell ids of cloud 0 (B = 1) and clouds 0-3 (B =
    4), flagship P: bit-exact against the plain version, timed in a CUDA
    graph and eager.  Returns the kernel entry (B = 1 as its main row)."""
    from objectdetection_3d_tpu_torch.ops.voxel_scan import (
        postsort_scan,
        postsort_scan_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxelize import cells_sorted

    vl = model.voxel_layer
    d, h, w = model.grid_dhw
    sentinel = d * h * w
    rows = {}
    for b in (1, 4):
        pts = torch.as_tensor(np.concatenate([x["points"]
                                              for x in batches[:b]]),
                              device="cuda")
        n = torch.as_tensor(np.concatenate([x["num_points"]
                                            for x in batches[:b]]),
                            device="cuda")
        cell_s, _ = cells_sorted(pts, n, voxel_size=vl.voxel_size,
                                 point_cloud_range=vl.point_cloud_range)
        vox_k, rank_k = postsort_scan(cell_s, sentinel)
        vox_p, rank_p = postsort_scan_plain(cell_s, sentinel)
        torch.cuda.synchronize()
        err = max(max_abs_err(vox_k, vox_p), max_abs_err(rank_k, rank_p))
        if not (torch.equal(vox_k, vox_p) and torch.equal(rank_k, rank_p)):
            raise AssertionError(f"postsort_scan differs from its plain "
                                 f"version at B={b} (max abs err {err})")
        bb, p = cell_s.shape
        rows[b] = {
            "shape": [bb, p], "max_abs_err": err,
            "ms": graph_ms(lambda c=cell_s: postsort_scan(c, sentinel), 20),
            "eager_ms": cuda_ms(lambda c=cell_s: postsort_scan(c, sentinel),
                                200),
            "plain_ms": cuda_ms(
                lambda c=cell_s: postsort_scan_plain(c, sentinel), 200),
            # (B, P) int32 read once, two (B, P) int32 outputs written once
            "bound_ms": bytes_ms(3 * bb * p * 4)}
        print(f"K1 postsort_scan B={bb} P={p}: bit-exact; "
              f"{rows[b]['ms']:.4f} ms in a CUDA graph "
              f"({rows[b]['eager_ms']:.4f} eager) vs plain "
              f"{rows[b]['plain_ms']:.4f} ms; bound "
              f"{rows[b]['bound_ms']:.5f} ms", flush=True)
    main = rows[1]
    return {
        "name": "postsort_scan", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/voxel_scan.cu",
        "replaces": "objectdetection_3d_tpu/ops/voxel_scan.py:119",
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "graph_ms": main["ms"], "eager_ms": main["eager_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "share": main["bound_ms"] / main["ms"], "b4": rows[4]}


def encoder_kernels(model, batch):
    """Phase 10, K8-K10: kernel entries {name: entry} for the JSON line."""
    import torch.nn.functional as F

    from objectdetection_3d_tpu_torch.models.layers import zfold_operands
    from objectdetection_3d_tpu_torch.ops.fused_stage import (
        fused_stage,
        fused_stage_plain,
    )
    from objectdetection_3d_tpu_torch.ops.zfold_conv import (
        conv2d_3x3,
        conv2d_3x3_plain,
    )

    enc = model.net.pseudoimage_generator
    ins = stage_inputs(model, batch, 3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dts = (torch.float32, torch.bfloat16)
    src = "objectdetection_3d_tpu_torch/csrc/"
    stages = {"conv2d_3x3": [], "fused_stage": []}

    # ---- K10: subm conv of stages 0 and 1 -------------------------------
    stages["subm_conv3d"] = subm_conv_stages(enc, ins)

    # ---- K9: folded subm conv of stages 0-2, forward and backward ------
    for i in (0, 1, 2):
        x, _ = ins[i]
        b, c, d, h, w = x.shape
        zb = enc._zfold_block(c, d)
        k5 = getattr(enc, f"subm_{i}_kernel").detach().permute(2, 3, 4, 1, 0)
        xo, kf = zfold_operands(x.permute(0, 2, 3, 4, 1).clone(),
                                k5.clone(), zb)
        n, _, _, cf = xo.shape
        cof = kf.shape[-1]
        g = torch.randn((n, h, w, cof), generator=gen, device="cuda")
        pairs = {}
        for dt in dts:
            got, want = [], []
            for fn, out in ((conv2d_3x3, got), (conv2d_3x3_plain, want)):
                xa = xo.to(dt, copy=True).requires_grad_()
                ka = kf.clone().requires_grad_()
                y = fn(xa, ka)
                y.backward(g.to(dt))
                out.extend([y.detach(), xa.grad, ka.grad])
            pairs[dt] = list(zip(got, want))
        torch.cuda.synchronize()
        err = gated(f"K9 stage {i} (forward, dx, dw)", pairs)
        del pairs
        xb, kb = xo.to(x.dtype), kf.to(x.dtype)
        gb = g.to(x.dtype)
        wt = kb.flip(0, 1).transpose(2, 3).contiguous()
        xl, gl = xb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2)
        kl, wtl = kb.permute(3, 2, 0, 1), wt.permute(3, 2, 0, 1)
        with torch.no_grad():
            ms = (cuda_ms(lambda: conv2d_3x3(xb, kb), 10),
                  cuda_ms(lambda: conv2d_3x3(gb, wt), 10))
            plain = (cuda_ms(lambda: conv2d_3x3_plain(xb, kb), 1),
                     cuda_ms(lambda: conv2d_3x3_plain(gb, wt), 1))
            lib = (cuda_ms(lambda: F.conv2d(xl, kl, padding=1), 10),
                   cuda_ms(lambda: F.conv2d(gl, wtl, padding=1), 10))
        # forward and dx: each reads one (n, h, w) image set and writes the
        # other, with 2 * 9 * cf * cof operations per pixel
        b_ms, b_by = bound(2 * n * h * w * (cf + cof) + 18 * cf * cof,
                           2 * 9 * cf * cof * n * h * w, BF16_TC_OPS_PER_S)
        stages["conv2d_3x3"].append({
            "stage": i, "shape": [n, h, w, cf, cof], "max_abs_err": err,
            "ms": sum(ms), "forward_ms": ms[0], "dx_ms": ms[1],
            "plain_ms": sum(plain), "library_ms": sum(lib),
            "library_forward_ms": lib[0], "library_dx_ms": lib[1],
            "bound_ms": 2 * b_ms, "bound_forward_ms": b_ms,
            "bound_dx_ms": b_ms, "bound_by": b_by,
            "share": 2 * b_ms / sum(ms), "share_forward": b_ms / ms[0],
            "share_dx": b_ms / ms[1]})
        del xo, kf, g, xb, kb, gb, wt
        torch.cuda.empty_cache()

    # ---- K8: whole eval stages 0-2 ---------------------------------------
    for i in (0, 1, 2):
        x, m = ins[i]
        xn, mn = x.permute(0, 2, 3, 4, 1), m[:, 0]
        with torch.no_grad():
            args = [a.detach() for a in enc.fused_stage_args(i)]
        pairs = {}
        for dt in dts:
            xi, mi = xn.to(dt), mn.to(dt)
            pairs[dt] = [(fused_stage(xi, mi, *args),
                          fused_stage_plain(xi, mi, *args))]
        torch.cuda.synchronize()
        err = gated(f"K8 stage {i}", pairs)
        del pairs
        b, d, h, w, c = xn.shape
        co = args[0].shape[-1]
        d_out = (d - 3) // 2 + 1
        b_ms, b_by = bound(
            2 * (b * d * h * w * (c + 1) + b * d_out * h * w * co)
            + 2 * 27 * c * co + 4 * 3 * co * co + 16 * co,
            2 * 27 * c * co * b * d * h * w + 2 * 3 * co * co * b * d_out
            * h * w, BF16_TC_OPS_PER_S)
        with torch.inference_mode():
            unfused = cuda_ms(lambda: enc.stage(i, x, m), 10)
        ms = cuda_ms(lambda: fused_stage(xn, mn, *args), 10)
        stages["fused_stage"].append({
            "stage": i, "shape": [b, d, h, w, c, co], "max_abs_err": err,
            "ms": ms,
            "plain_ms": cuda_ms(lambda: fused_stage_plain(xn, mn, *args), 1),
            "library_ms": None, "unfused_ms": unfused,
            "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
    del ins
    torch.cuda.empty_cache()
    # K10 beside K8 on the same stage (K8 also runs the down conv)
    for r in stages["subm_conv3d"]:
        r["k8_ms"] = stages["fused_stage"][r["stage"]]["ms"]

    replaces = {"subm_conv3d": ("subm_conv3d.cu", "pallas_conv.py:107"),
                "conv2d_3x3": ("zfold_conv.cu", "zfold_conv.py:93"),
                "fused_stage": ("fused_stage.cu", "fused_stage.py:156")}
    entries = {}
    for name, rows in stages.items():
        entry = {"name": name, "route": "cuda", "source": src
                 + replaces[name][0], "replaces": "objectdetection_3d_tpu/"
                 "ops/" + replaces[name][1],
                 "max_abs_err": max(r["max_abs_err"] for r in rows)}
        for key in ("ms", "plain_ms", "bound_ms"):
            entry[key] = sum(r[key] for r in rows)
        entry["bound_by"] = ("operations" if any(
            r["bound_by"] == "operations" for r in rows) else "bytes")
        entry["share"] = entry["bound_ms"] / entry["ms"]
        lib = [r["library_ms"] for r in rows]
        entry["library_ms"] = None if None in lib else sum(lib)
        entry["stages"] = rows
        entries[name] = entry
        for r in rows:
            print(f"{name} stage {r['stage']} {r['shape']}: "
                  f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']}, "
                  + (f"unfused {r['unfused_ms']:.4f} ms, " if "unfused_ms"
                     in r else "")
                  + (f"K8 {r['k8_ms']:.4f} ms, " if "k8_ms" in r else "")
                  + (f"share of bound {r['share']:.3f}, " if "share" in r
                     and "dx_ms" not in r else "") +
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f"; forward {r['forward_ms']:.4f} (cuDNN "
                     f"{r['library_forward_ms']:.4f}, share of bound "
                     f"{r['share_forward']:.3f}), dx {r['dx_ms']:.4f} "
                     f"(cuDNN {r['library_dx_ms']:.4f}, share "
                     f"{r['share_dx']:.3f})" if "dx_ms" in r else ""),
                  flush=True)
    return entries


def aligned_clipper(model, batch):
    """K5 on two inputs of 1.92 M aligned pairs: the drive (each flagship
    anchor against a random one of cloud 0's trees, as the JAX package's
    ``tools/profile_assign.py`` pairs them) and the dense input (each
    anchor against a jittered copy of itself).  On each: within 1e-5 of
    the volume scale of the plain version, exactly 0 wherever the plain
    separating-plane test clears both directions, timed in a CUDA graph
    and eager, with its bound (the least work of this input: the frames
    and the extent test of every pair, and the clip's live ring vertices,
    crossing points and fan terms on the open directions, against the
    bytes) beside the bound of clipping every pair on the TPU body's fixed
    schedule.  Returns the kernel entry (the drive as its main row), with the
    launches of one drive."""
    from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
        intersection_volume_aligned,
        intersection_volume_aligned_plain,
    )
    from objectdetection_3d_tpu_torch.ops.iou3d import separated_directions
    from objectdetection_3d_tpu_torch.scene import aligned_pair_inputs

    n = model.anchors.shape[0]
    inputs = aligned_pair_inputs(model.anchors.cpu().numpy(),
                                 batch["bboxes"][0][batch["gt_mask"][0]])
    nbytes = 2 * n * 36 + n * 4
    rows = {}
    for label, pair in inputs.items():
        b1, b2 = (torch.as_tensor(x, device="cuda") for x in pair)
        got = intersection_volume_aligned(b1, b2)
        want = intersection_volume_aligned_plain(b1, b2)
        sep = separated_directions(b1, b2)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        scale = float(want.abs().max())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"intersection_volume_aligned ({label}) "
                                 f"differs from its plain version by {err} "
                                 f"(scale {scale})")
        both = sep.all(-1)
        if not (bool((got[both] == 0).all())
                and bool((want[both] == 0).all())):
            raise AssertionError(f"intersection_volume_aligned ({label}): a "
                                 f"pair the separating-plane test clears is "
                                 f"not exactly 0")
        ops, open_dirs = clip_ops(b1, b2, sep)
        ops += (2 * FRAME_OPS + EXTENT_OPS) * n
        b_ms, b_by = bound(nbytes, ops)
        all_ms, _ = bound(nbytes, CLIP_OPS_PER_PAIR * n)
        row = {
            "max_abs_err": err, "volume_scale": scale,
            "differing": int((got != want).sum()),
            "cleared_pairs": int(both.sum()), "open_directions": open_dirs,
            "overlapping": int((want > 0).sum()),
            "ms": graph_ms(lambda: intersection_volume_aligned(b1, b2), 10),
            "eager_ms": cuda_ms(lambda: intersection_volume_aligned(b1, b2),
                                10),
            "plain_ms": cuda_ms(
                lambda: intersection_volume_aligned_plain(b1, b2), 1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_all_pairs_ms": all_ms,
            "bound_ops": ops}
        row["share"] = b_ms / row["ms"]
        # device time per launch: the count's fill, the test, the clip
        row["split_ms"] = kernel_split_ms(
            lambda: intersection_volume_aligned(b1, b2), 5)
        rows[label] = row
        print(f"K5 intersection_volume_aligned {label} pairs={n}: max abs "
              f"err {err:.3g} (volume scale {scale:.3g}, {row['differing']} "
              f"differ, {row['overlapping']} overlap); test clears "
              f"{row['cleared_pairs']} pairs ({open_dirs} of {2 * n} "
              f"directions left to clip), all exactly 0; {row['ms']:.4f} ms "
              f"in a CUDA graph ({row['eager_ms']:.4f} eager) vs plain "
              f"{row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
              f"{row['bound_ops']:.4g} ops; share {row['share']:.3f}), all "
              f"pairs on the fixed schedule {all_ms:.4f} ms; "
              f"split " + ", ".join(f"{kernel_label(k)} {v:.4f}"
                                    for k, v in row["split_ms"].items()),
              flush=True)
        del got, want, sep
    # the JAX package's tools/profile_assign.py: the tier's pairs, summed
    b1, b2 = (torch.as_tensor(x, device="cuda") for x in inputs["drive"])
    intersection_volume_aligned.launches = 0
    total = float(intersection_volume_aligned(b1, b2).sum())
    launches = intersection_volume_aligned.launches
    if launches != 1 or not np.isfinite(total):
        raise AssertionError(f"K5 drive: {launches} launches, sum {total}")
    main = rows["drive"]
    return {
        "name": "intersection_volume_aligned", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/iou3d_clip.cu",
        "replaces": "objectdetection_3d_tpu/ops/pallas_iou3d.py:341",
        "launches": launches, "library_ms": None, "pairs": n,
        **{key: main[key] for key in (
            "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_all_pairs_ms", "share", "cleared_pairs",
            "open_directions")},
        "graph_ms": main["ms"], "dense": rows["dense"]}


def knob_predicts(batches, default_preds):
    """Phase 11: predict under the lowering knobs.  Returns the launch
    counts per kernel over the four clouds of each knob set."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.fused_stage import fused_stage
    from objectdetection_3d_tpu_torch.ops.pallas_conv import subm_conv3d
    from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3

    def knob_model(tpu):
        model = PointPillars(configs.flagship_cfg(tpu), device="cuda")
        load_npz(model.net, NPZ)
        return model

    def counts():
        return {"fused_stage": fused_stage.launches,
                "subm_conv3d": subm_conv3d.launches,
                "conv2d_3x3": conv2d_3x3.launches,
                "conv2d_3x3_dx": conv2d_3x3.dx_launches}

    knob_sets = (
        ({"fused_stages": True}, {"fused_stage": 3}),
        ({"pallas_subm_conv": True, "zfold_pallas": True},
         {"subm_conv3d": 2, "conv2d_3x3": 1}))
    from objectdetection_3d_tpu_torch.models import layers

    # does the K10 wrapper's x.contiguous() copy on the predict path?
    contiguous = []

    def watched(x, kernel):
        contiguous.append(x.is_contiguous())
        return subm_conv3d(x, kernel)

    launches = {}
    for tpu, per_cloud in knob_sets:
        model = knob_model(tpu)
        predict = model.make_predict_fn()
        layers.subm_conv3d = watched
        try:
            predict(batches[0])             # warm-up
        finally:
            layers.subm_conv3d = subm_conv3d
        torch.cuda.synchronize()
        fused_stage.launches = subm_conv3d.launches = 0
        conv2d_3x3.launches = conv2d_3x3.dx_launches = 0
        times, outs = [], []
        for batch in batches:
            t = time.perf_counter()
            outs.append(predict(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        got = counts()
        want = {k: per_cloud.get(k, 0) * len(batches) for k in got}
        if got != want:
            raise AssertionError(f"predict under {tpu}: launches {got}, "
                                 f"expected {want}")
        for i, out in enumerate(outs):
            for key in ("bbox", "score"):
                if not bool(torch.isfinite(out[key]).all()):
                    raise AssertionError(f"{tpu} cloud {i}: non-finite "
                                         f"{key}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        agree = centre_matches(default_preds[0], outs[0])
        print(f"predict {tpu}: median {np.median(times) * 1e3:.1f} ms per "
              f"cloud over {len(times)} clouds (bf16); launches {got}; "
              f"valid {[int(o['valid'].sum()) for o in outs]}; cloud 0: "
              f"{agree} of {int(default_preds[0]['valid'].sum())} default "
              f"detections have one within 0.5 m", flush=True)
        del model, predict, outs
        torch.cuda.empty_cache()

    # cloud 0 in float32 (TF32 off): pseudo-images against the default's
    def pseudo(tpu):
        model = knob_model(dict(tpu, compute_dtype="float32"))
        seen = {}
        hook = model.net.pseudoimage_generator.register_forward_hook(
            lambda mod, args, out: seen.setdefault("out", out))
        model.predict(batches[0])
        hook.remove()
        return seen["out"]

    want = pseudo({})
    scale = float(want.abs().max())
    for tpu, _ in knob_sets:
        err = max_abs_err(pseudo(tpu), want)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"float32 pseudo-image under {tpu} differs "
                                 f"from the default path's by {err} (scale "
                                 f"{scale})")
        print(f"float32 pseudo-image under {tpu}: max abs err {err:.3g} of "
              f"scale {scale:.3g} against the default path", flush=True)
    del want
    torch.cuda.empty_cache()
    print(f"K10 inputs on the predict path contiguous: {contiguous}",
          flush=True)
    launches["subm_conv3d_inputs_contiguous"] = contiguous
    return launches


def zfold_train(batches, counted):
    """Phase 12: train steps with ``zfold_pallas``; returns K9's forward
    and dx launch counts over the 2 timed steps."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3

    model = PointPillars(configs.flagship_cfg({"zfold_pallas": True}),
                         device="cuda")
    load_npz(model.net, NPZ)
    tx = model.get_optimizer(dict(lr=1e-3, betas=(0.95, 0.99),
                                  weight_decay=0.01), grad_clip_value=2.0)
    step = model.make_train_step(tx)
    before = {k: v.detach().clone() for k, v in
              model.net.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    step(batches[0])                        # warm-up
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    conv2d_3x3.launches = conv2d_3x3.dx_launches = 0
    times = []
    for i in (1, 2):
        t = time.perf_counter()
        out = step(batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        vals = {k: float(v) for k, v in out.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"zfold step on cloud {i}: non-finite "
                                 f"{vals}")
        if vals["num_pos"] <= 0:
            raise AssertionError(f"zfold step on cloud {i}: no positive "
                                 f"anchor")
        print(f"zfold_pallas train step cloud {i}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in vals.items() if k != "num_pos")
            + f", num_pos {int(vals['num_pos'])}; {times[-1] * 1e3:.1f} ms",
            flush=True)
    k9 = {"forward": conv2d_3x3.launches, "dx": conv2d_3x3.dx_launches}
    if k9 != {"forward": 6, "dx": 6}:
        raise AssertionError(f"K9 launches in 2 zfold steps: {k9}, expected "
                             f"3 forward and 3 dx per step")
    others = {name: fn.launches for name, fn in counted.items()}
    if not all(others.values()):
        raise AssertionError(f"a kernel did not launch in the zfold steps: "
                             f"{others}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = model.net.state_dict()
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    if unchanged:
        raise AssertionError(f"zfold steps left {unchanged} unchanged")
    print(f"zfold_pallas train: median {np.median(times) * 1e3:.1f} ms per "
          f"step over {len(times)} steps (B=1, bf16, after one warm-up); "
          f"K9 launches {k9}; others {others}; peak memory {peak:.2f} GiB; "
          f"all {len(before)} arrays changed", flush=True)
    return k9


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from objectdetection_3d_tpu_torch.scene import (
        MAX_GT,
        card_line,
        make_batch,
        tree_scene,
    )
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.assign import geometry_tier
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops import cuda_lib
    from objectdetection_3d_tpu_torch.ops.assign_geometry import (
        chunk_geometry,
        containment_rescue,
    )
    from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
        iou_gathered,
        iou_gathered_pair,
        iou_gathered_pair_plain,
        iou_gathered_plain,
    )
    from objectdetection_3d_tpu_torch.ops.grid_scatter import (
        scatter_to_grid,
        scatter_to_grid_plain,
    )
    from objectdetection_3d_tpu_torch.ops.iou3d import separated_directions
    from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
    from objectdetection_3d_tpu_torch.profile_train import (
        phase_device_ms,
        traced_steps,
    )

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    for name in cuda_lib.KERNEL_SOURCES:
        cuda_lib.load(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{list(cuda_lib.KERNEL_SOURCES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")

    cfg = configs.flagship_cfg()
    model = PointPillars(cfg, device="cuda")
    d, h, w = model.grid_dhw
    p_max = model.tpu_cfg["max_points_static"]
    v_max = model.voxel_layer.max_voxels
    scenes = [tree_scene(seed) for seed in range(4)]
    batches = [make_batch(sc, p_max) for sc in scenes]
    kernels = {}
    if "--quick" in sys.argv[1:]:
        # the first call after a kernel change: K10 per flagship stage, K1
        # at B = 1 and 4, and K3/K4 on cloud 0's chunks against their plain
        # versions, then stop
        load_npz(model.net, NPZ)
        ins = stage_inputs(model, batches[0], 2)
        for r in subm_conv_stages(model.net.pseudoimage_generator, ins):
            print(f"K10 stage {r['stage']} {r['shape']}: {r['ms']:.4f} ms, "
                  f"cuDNN {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms, input contiguous "
                  f"{r['input_contiguous']}", flush=True)
        del ins
        scan_entry(model, batches)
        gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
        gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
        geom = geometry_tier(gt, gt_mask, model.anchor_layout,
                             model.combo_tab, MAX_GT,
                             int(model.tpu_cfg["assign_candidates_per_gt"]),
                             16, chunk_geometry)
        geometry_kernels(model, geom, gt_mask, batches[0])
        aligned_clipper(model, batches[0])
        print("quick check passed", flush=True)
        return 0

    # ---- K1: post-sort scan at B=1 and 4, P=131,072 -------------------
    kernels["postsort_scan"] = scan_entry(model, batches)
    vl = model.voxel_layer
    pts0 = torch.as_tensor(batches[0]["points"], device="cuda")
    n0 = torch.as_tensor(batches[0]["num_points"], device="cuda")
    sentinel = d * h * w

    # ---- K2: grid scatter at V=102,400, C=20, 100x400x400 --------------
    vox0 = vl.points_batch(pts0, n0)
    cz, cy, cx = vox0["coords"].unbind(-1)
    cell = torch.where(vox0["voxel_mask"], (cz * h + cy) * w + cx,
                       sentinel).to(torch.int32).contiguous()
    c_pfn = int(cfg["voxel_encoder"]["feat_channels"][-1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    valid = cell < sentinel
    rows = torch.zeros_like(cell, dtype=torch.long)[valid]
    cells_l = cell[valid].long()
    n_active = int(valid.sum())
    k2_dtypes = []
    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.randn((1, v_max, c_pfn), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        grid_k = scatter_to_grid(feats, cell, (d, h, w))
        grid_p = scatter_to_grid_plain(feats, cell, (d, h, w))
        torch.cuda.synchronize()
        err = max_abs_err(grid_k, grid_p)
        if not torch.equal(grid_k, grid_p):
            raise AssertionError(f"scatter_to_grid ({dtype}) differs from "
                                 f"its plain version (max abs err {err})")
        del grid_k, grid_p
        vals = feats[valid]
        es = feats.element_size()

        def library(vals=vals, dtype=dtype):
            g = torch.zeros((1, d * h * w, c_pfn), dtype=dtype,
                            device="cuda")
            g.index_put_((rows, cells_l), vals)
            return g

        entry = {
            "name": "scatter_to_grid", "route": "cuda",
            "source": "objectdetection_3d_tpu_torch/csrc/grid_scatter.cu",
            "replaces": "objectdetection_3d_tpu/ops/grid_scatter.py:119",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: scatter_to_grid(feats, cell, (d, h, w)),
                          20),
            "plain_ms": cuda_ms(
                lambda: scatter_to_grid_plain(feats, cell, (d, h, w)), 20),
            # feats + ids read once, the whole grid written once
            "bound_ms": bytes_ms(v_max * c_pfn * es + v_max * 4
                                 + d * h * w * c_pfn * es),
            "bound_by": "bytes",
            "library_ms": cuda_ms(library, 20),
        }
        entry["share"] = entry["bound_ms"] / entry["ms"]
        print(f"K2 scatter_to_grid {str(dtype)[6:]} V={v_max} C={c_pfn} "
              f"grid={d}x{h}x{w} active={n_active}: bit-exact; "
              f"{entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f} ms, "
              f"zeros+index_put_ {entry['library_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms (share {entry['share']:.3f})",
              flush=True)
        k2_dtypes.append({"dtype": str(dtype)[6:], **{
            key: entry[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "share")}})
        if dtype == model.compute_dtype:
            kernels["scatter_to_grid"] = entry
        del feats, vals
    kernels["scatter_to_grid"]["dtypes"] = k2_dtypes
    torch.cuda.empty_cache()

    # ---- voxelizer: kernel path on the card vs plain path on the CPU ---
    vox_cpu = vl.points_batch(pts0.cpu(), n0.cpu())
    for key, val in vox0.items():
        if not torch.equal(val.cpu(), vox_cpu[key]):
            raise AssertionError(f"voxelizer output {key!r} differs between "
                                 f"the card and the CPU")
    print(f"voxelizer: card == CPU on all {len(vox0)} outputs "
          f"({int(vox0['num_voxels'][0])} voxels)", flush=True)
    del vox0, vox_cpu

    # ---- predict: flagship, bf16, trained weights, 4 clouds ------------
    with np.load(NPZ) as z:
        n_weights = sum(k.split("/")[0] in ("params", "batch_stats")
                        for k in z.files)
    n_loaded = load_npz(model.net, NPZ)
    if n_loaded != n_weights:
        raise AssertionError(f"loaded {n_loaded} of the npz's {n_weights} "
                             f"weight arrays")
    print(f"weights: {n_loaded} arrays from {os.path.relpath(NPZ, REPO)}")
    predict = model.make_predict_fn()
    postsort_scan.launches = 0
    scatter_to_grid.launches = 0
    torch.cuda.reset_peak_memory_stats()
    predict(batches[0])                     # warm-up
    torch.cuda.synchronize()
    times, preds = [], []
    for batch in batches:
        t = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        preds.append(out)
    launches = {"postsort_scan": postsort_scan.launches,
                "scatter_to_grid": scatter_to_grid.launches}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"predict path")
        kernels[name]["launches_predict"] = count
    for i, out in enumerate(preds):
        if tuple(out["bbox"].shape) != (1, model.tpu_cfg["max_detections"],
                                        9):
            raise AssertionError(f"bbox shape {tuple(out['bbox'].shape)}")
        for key in ("bbox", "score"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"cloud {i}: non-finite {key}")
        print(f"cloud {i}: {int(out['valid'].sum())} valid detections, "
              f"{times[i] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"predict: median {np.median(times) * 1e3:.1f} ms per cloud over "
          f"{len(times)} clouds (B=1, bf16, after one warm-up); launches "
          f"{launches}; peak memory {peak:.2f} GiB", flush=True)

    # ---- float32 run of cloud 0 ----------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = PointPillars(configs.flagship_cfg({"compute_dtype": "float32"}),
                           device="cuda")
    load_npz(model32.net, NPZ)
    out32 = model32.make_predict_fn()(batches[0])
    torch.cuda.synchronize()
    matched = centre_matches(out32, preds[0])
    print(f"float32 vs bf16 on cloud 0: {matched} of "
          f"{int(out32['valid'][0].sum())} float32 detections have a bf16 "
          f"detection within 0.5 m (bf16 has "
          f"{int(preds[0]['valid'][0].sum())})", flush=True)
    del model32, out32

    # ---- assignment kernels at flagship shapes, cloud 0 ---------------
    gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
    gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
    n_anchor = model.anchors.shape[0]
    k = int(model.tpu_cfg["assign_candidates_per_gt"])
    geom = geometry_tier(gt, gt_mask, model.anchor_layout, model.combo_tab,
                         MAX_GT, k, 16, chunk_geometry)
    kernels.update(geometry_kernels(model, geom, gt_mask, batches[0]))

    rows = torch.arange(MAX_GT, dtype=torch.int32,
                        device="cuda").repeat_interleave(k)
    cand_boxes = model.anchors[geom["cand_idx"].reshape(-1)].contiguous()
    g6 = (gt, gt_mask, rows, cand_boxes)
    safe = [torch.clamp(geom[a], 0, MAX_GT - 1) for a in ("a1", "a2")]
    g7 = (gt, gt_mask, safe[0], safe[1], model.anchors)
    for name, fn, plain, args, n_pairs, src_line in (
            ("iou_gathered", iou_gathered, iou_gathered_plain, g6,
             rows.numel(), 408),
            ("iou_gathered_pair", iou_gathered_pair, iou_gathered_pair_plain,
             g7, 2 * n_anchor, 485)):
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        got = torch.stack(got) if isinstance(got, tuple) else got
        want = torch.stack(want) if isinstance(want, tuple) else want
        err = max_abs_err(got, want)
        n_diff = int((got != want).sum())
        if not err <= 1e-5:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"by {err}")
        n_ids = len(args) - 3
        # the plain separating-plane test on the same pairs: what it clears
        # must come out exactly 0 from the kernel and the plain version
        ids = torch.cat([a.long() for a in args[2:-1]])
        sep = torch.cat([separated_directions(gt[a.long()], args[-1])
                         for a in args[2:-1]])
        both = sep.all(-1)
        if not (bool((got.reshape(-1)[both] == 0).all())
                and bool((want.reshape(-1)[both] == 0).all())):
            raise AssertionError(f"{name}: a pair the separating-plane test "
                                 f"clears is not exactly 0")
        row_ok = gt_mask[ids]
        cleared = int((both | ~row_ok).sum())
        open_dirs = int(((~sep) & row_ok[:, None]).sum())
        nbytes = (args[-1].numel() * 4 + n_pairs * 4
                  + args[-1].shape[0] * 4 * n_ids + MAX_GT * 40)
        all_ms, _ = bound(nbytes, CLIP_OPS_PER_PAIR * n_pairs)
        # an invalid row's pairs are 0 without a test or a clip
        ops, _ = clip_ops(gt[ids], args[-1].repeat(n_ids, 1),
                          sep | ~row_ok[:, None])
        ops += (FRAME_OPS * (args[-1].shape[0] + int(gt_mask.sum()))
                + EXTENT_OPS * int(row_ok.sum())
                + IOU_OPS * int((row_ok & ~both).sum()))
        b_ms, b_by = bound(nbytes, ops)
        ms = cuda_ms(lambda fn=fn, args=args: fn(*args), 5)
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "objectdetection_3d_tpu_torch/csrc/iou3d_clip.cu",
            "replaces": f"objectdetection_3d_tpu/ops/pallas_iou3d.py:"
                        f"{src_line}",
            "max_abs_err": err, "ms": ms,
            "plain_ms": cuda_ms(lambda plain=plain, args=args: plain(*args),
                                1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bound_all_pairs_ms": all_ms, "share": b_ms / ms,
            "pairs": n_pairs, "cleared_pairs": cleared,
            "uncleared_directions": open_dirs,
            # device time per launch: the row records, the test, the clip
            "split_ms": kernel_split_ms(lambda fn=fn, args=args: fn(*args),
                                        5),
        }
        print(f"{'K6' if n_ids == 1 else 'K7'} {name} pairs={n_pairs}: max "
              f"abs IoU err {err:.3g} ({n_diff} of {got.numel()} differ); "
              f"{ms:.4f} ms vs plain {kernels[name]['plain_ms']:.4f} ms; "
              f"test clears {cleared} pairs ({open_dirs} of {2 * n_pairs} "
              f"directions left to clip), all exactly 0; bound {b_ms:.4f} "
              f"ms ({b_by}; share {b_ms / ms:.3f}), all pairs on the fixed "
              f"schedule {all_ms:.4f} ms", flush=True)
        del got, want
    del geom, g6, g7, cand_boxes
    torch.cuda.empty_cache()

    # ---- assignment of cloud 0: kernels vs plain versions, on the card -
    t = time.perf_counter()
    tk = model.assign(batches[0])
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t
    t = time.perf_counter()
    tp = model.assign(batches[0], plain=True)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t
    pos = tp["pos_mask"]
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets",
                "num_pos"):
        if not torch.equal(tk[key], tp[key]):
            raise AssertionError(f"assignment {key!r} differs between the "
                                 f"kernels and their plain versions")
    if not torch.equal(tk["best_gt"][pos], tp["best_gt"][pos]):
        raise AssertionError("assignment best_gt differs under pos_mask")
    num_pos = int(tk["num_pos"].sum())
    if num_pos <= 0:
        raise AssertionError("cloud 0's assignment has no positive anchor")
    print(f"assignment cloud 0 (G={MAX_GT}, {int(gt_mask.sum())} trees, "
          f"N={n_anchor}, K={k}): kernels == plain; num_pos {num_pos}, "
          f"negatives {int(tk['neg_mask'].sum())}; {t_kernel * 1e3:.1f} ms "
          f"with the kernels, {t_plain * 1e3:.1f} ms plain", flush=True)
    del tk, tp

    # ---- the same assignment without the exact anchor tier -------------
    model_nt = PointPillars(configs.flagship_cfg(
        {"assign_exact_anchor_tier": False}), device="cuda")
    iou_gathered_pair.launches = 0
    tk = model_nt.assign(batches[0])
    tp = model_nt.assign(batches[0], plain=True)
    torch.cuda.synchronize()
    pos = tp["pos_mask"]
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets",
                "num_pos"):
        if not torch.equal(tk[key], tp[key]):
            raise AssertionError(f"assignment without the tier: {key!r} "
                                 f"differs between the kernels and their "
                                 f"plain versions")
    if not torch.equal(tk["best_gt"][pos], tp["best_gt"][pos]):
        raise AssertionError("assignment without the tier: best_gt differs "
                             "under pos_mask")
    num_pos_nt = int(tk["num_pos"].sum())
    if iou_gathered_pair.launches != 0 or num_pos_nt > num_pos:
        raise AssertionError(f"assignment without the tier: K7 launched "
                             f"{iou_gathered_pair.launches} times, num_pos "
                             f"{num_pos_nt} (default {num_pos})")
    print(f"assignment cloud 0 with assign_exact_anchor_tier false: kernels "
          f"== plain, 0 K7 launches; num_pos {num_pos_nt} (default "
          f"{num_pos}), negatives {int(tk['neg_mask'].sum())}", flush=True)
    del tk, tp, model_nt

    # ---- train: flagship, bf16, B=1 --------------------------------------
    counted = {"postsort_scan": postsort_scan,
               "scatter_to_grid": scatter_to_grid,
               "chunk_geometry": chunk_geometry,
               "containment_rescue": containment_rescue,
               "iou_gathered": iou_gathered,
               "iou_gathered_pair": iou_gathered_pair}
    tx = model.get_optimizer(dict(lr=1e-3, betas=(0.95, 0.99),
                                  weight_decay=0.01), grad_clip_value=2.0)
    step = model.make_train_step(tx)
    before = {k_: v.detach().clone() for k_, v in
              model.net.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    step(batches[0])                        # warm-up
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    times = []
    for i in (1, 2, 3):
        t = time.perf_counter()
        out = step(batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        vals = {k_: float(v) for k_, v in out.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step on cloud {i}: non-finite {vals}")
        if vals["num_pos"] <= 0:
            raise AssertionError(f"step on cloud {i}: no positive anchor")
        print(f"train step cloud {i}: " + ", ".join(
            f"{k_} {v:.5f}" for k_, v in vals.items() if k_ != "num_pos")
            + f", num_pos {int(vals['num_pos'])}; "
            f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {name: fn.launches for name, fn in counted.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched in the "
                                 f"train steps")
        kernels[name]["launches"] = count
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = model.net.state_dict()
    changed = {kind: sum(not torch.equal(before[k_], after[k_])
                         for k_ in before if k_.endswith(suffix))
               for kind, suffix in (("params", ("weight", "bias",
                                                "_kernel")),
                                    ("stats", ("running_mean",
                                               "running_var")))}
    n_stats = sum(k_.endswith(("running_mean", "running_var"))
                  for k_ in before)
    if changed["params"] != len(before) - n_stats or \
            changed["stats"] != n_stats:
        raise AssertionError(f"train steps changed {changed} of "
                             f"{len(before)} arrays")
    print(f"train: median {np.median(times) * 1e3:.1f} ms per step over "
          f"{len(times)} steps (B=1, bf16, after one warm-up); launches in "
          f"3 steps {launches}; peak memory {peak:.2f} GiB; changed "
          f"{changed}", flush=True)

    # one more step of the same step function, traced; its phase ranges
    # split the device time (not counted above)
    _, walls, trace = traced_steps(
        step, [batches[1]], os.path.join(REPO, "build", "train_trace.json"))
    split = phase_device_ms(trace)
    busy = sum(split.values()) / (walls[0] * 1e3)
    print("train step split (profiler, device ms): " + ", ".join(
        f"{k_} {v:.2f}" for k_, v in split.items())
        + f"; total {sum(split.values()):.2f} of {walls[0] * 1e3:.1f} ms "
        f"wall (device busy {busy:.3f})", flush=True)

    del step, tx, before, after
    torch.cuda.empty_cache()

    # ---- encoder kernels and K5 at flagship shapes ----------------------
    load_npz(model.net, NPZ)                # the npz weights, untrained
    kernels.update(encoder_kernels(model, batches[0]))
    kernels["intersection_volume_aligned"] = aligned_clipper(model,
                                                             batches[0])
    del model
    torch.cuda.empty_cache()

    # ---- predict and train under the lowering knobs ---------------------
    launches = knob_predicts(batches, preds)
    kernels["fused_stage"]["launches"] = launches["fused_stage"]
    kernels["subm_conv3d"]["launches"] = launches["subm_conv3d"]
    kernels["subm_conv3d"]["predict_inputs_contiguous"] = launches[
        "subm_conv3d_inputs_contiguous"]
    kernels["conv2d_3x3"]["launches_predict"] = launches["conv2d_3x3"]
    k9 = zfold_train(batches, counted)
    kernels["conv2d_3x3"]["launches"] = k9["forward"] + k9["dx"]
    kernels["conv2d_3x3"]["launches_forward"] = k9["forward"]
    kernels["conv2d_3x3"]["launches_dx"] = k9["dx"]
    if len(kernels) != 10:
        raise AssertionError(f"{len(kernels)} kernels in the line, not 10")

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
