#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--quick]

``--quick`` runs phases 1-2, then K10 on cloud 0's stage 0-1 inputs, K1
on clouds 0-3, K3/K4 on cloud 0's GT chunks 0-1 (and phase 7's C9 gate)
and K5 on both of its inputs against their plain versions, timed as in
phases 3, 7 and 10, and stops: the short first call after a kernel
change.

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
   must have launched; cloud 0's warm-up and timed predicts bitwise
   equal with PyTorch's deterministic mode off (C8);
6. float32: one cloud again in float32 (TF32 off), twice, bitwise equal
   (C8); the PFN's fixed-point centroid sum against the float32
   ``index_add_`` it replaced on the cloud's rows (device ms, and
   whether 20 calls agree bit for bit); how many of its detections the
   bf16 run matches (information, not a gate);
7. assignment kernels: K3 and K4 bit-exact, K6 and K7 within 1e-5 of
   IoU, each against its plain version on cloud 0's real assignment
   inputs (128 padded GT boxes, 1.92 M anchors, K = 512), both timed
   (K3 on GT chunk 0, with 12 trees, and on chunk 1, whose 16 rows are
   all padding, and over the step's 8 chunks back to back; K4 on both
   chunks under each row's own containment maximum and under the row
   maxima and rescue flags of cloud 0's flagship assignment, with the
   live (GT, combo) pairs counted, and over the assignment's 8 chunks);
   C9: chunk 0 with three live trees' dims negated, K3 launched raw
   against the plain version (the outputs that differ are printed), its
   wrapper refusing those rows (``ValueError`` naming them) and
   bit-exact with them masked;
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
   six kernels launched during the timed steps; the same three steps
   again from the state after the warm-up, first with the centroid's
   float32 ``index_add_`` (the step before the C8 repair, timed), then as
   they ran: losses and every parameter and running statistic bitwise
   equal (C8); then one more step of the same step function under
   ``torch.profiler``, its device time split by the step's own phase
   ranges (forward, assignment, loss + backward, optimizer);
10. encoder kernels: K10 (stages 0-1), K9 (stages 0-2, forward, and the
    backward's dx and dw), K8 (stages 0-2) on cloud 0's real stage inputs
    with the npz weights, each against its plain version in float32
    (TF32 off; within 1e-3 of the largest element) and in bf16 (within
    1e-2), timed beside its bound and cuDNN's conv (K9 per stage and
    direction, with its share of the bound; K10 per stage beside K8 on
    the same stage); K11 on cloud 0's ten real eval stage norms (bf16 and
    float32, each bitwise equal to its plain version), timed beside its
    bytes bound and the ATen chain it replaces; and K5 on 1.92 M
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
    changed, K9 exactly 6 forward (3, and 3 again as the flagship's
    ``tpu.remat: true`` recomputes the encoder in the backward) and 3 dx
    launches per step;
13. gradient accumulation at the flagship width (bf16, the npz weights,
    phase 9's AdamW): at B = 1 on cloud 1, ``microbatch=1`` against the
    monolithic step from the same state (losses within 1e-5 relative;
    the gradients the update receives within 1e-4 of each leaf's
    largest element; parameters within 1e-4 of the leaf's largest
    element plus 1e-5, and within 2 lr where the gradient lies below
    its tolerance, since AdamW's first step is lr * g / (|g| + 1e-8));
    at B = 8 (clouds 0-7) one warm-up and 2 timed steps each with
    ``microbatch`` 1 and 2, their wall ms and peak memory printed (losses
    finite, ``num_pos`` > 0, every array changed, K1-K4, K6, K7
    launched); ``microbatch=3`` at B = 8 raises ``ValueError``;
14. the pipeline at the flagship width, from a config dict
    (``configs.flagship_cfg()``, B = 2 in chunks of 1, one epoch; the
    dataset: clouds 4-5 for training, 6 for validation, 7 for testing,
    written to a directory under ``build/`` in the disk contract):
    ``run_training`` from scratch (finite losses; its artifacts; K1-K4,
    K6, K7 launched), ``run_testing`` from a ``ckpt_best.pth`` written
    from the npz (``test_protocol.yaml`` reads back; precision, recall
    and F1 finite), ``run_inference`` on the testing cloud equal to
    ``predict`` (boxes within 1e-5, labels exact), ``show_inference`` on
    the testing split (keys ``bbox``, ``label``, ``score``; its P/R/F1
    block printed; its PNG written where matplotlib imports, else its
    drawing replaced on that instance and the fact printed); the wall
    seconds of training, validation, testing and the show, and ms per
    train step; then under ``ckpt_backend: orbax``: ``run_training``
    writes ``ckpt_0000{0,1}.dcp`` directories (no ``.pth``), a resume
    starts at epoch 2 from ``ckpt_00001.dcp`` and leaves Adam's step at
    3 in ``ckpt_00002.dcp``, and ``run_testing`` from a ``ckpt_best.dcp``
    of the npz gives the ``.pth`` run's precision, recall and F1;
15. tiled inference at the flagship width (bf16, the npz weights and its
    ``score_thr``) over ``scene.large_tree_scene()`` (160 x 160 m,
    1,953,668 points): 25 tiles, each tile's in-window count equal on the
    card and in numpy; the card's crop against the host's (numpy): on
    each under-budget tile the same rows as a multiset (rounded to
    1e-4), on each over-budget tile exactly P rows, all from its window;
    both crops' voxels (coords, counts) equal on under-budget tiles and
    no voxel from a ``1e9`` sentinel row; in float32 (TF32 off, PyTorch's
    deterministic mode off) tile 3 predicted twice bitwise equal (C8),
    the per-tile detections of both crops on the under-budget tiles equal
    (counts and labels exact, boxes within 1e-3) and both merged scene
    outputs in the scene's
    frame (each merged box a tile's box shifted by its origin; how many
    lie inside the scene's xy bounds is printed); in bf16 the device path (one
    warm-up, 3 timed calls), the host path (1 call) and the device path
    at ``batch_tiles=2`` (1 call, 13 chunks): s/scene, Mpts/s,
    detections, the merge's candidates, kept boxes, time and peak
    memory, and K1 and K2 exactly one launch per chunk;
16. the reference importer: a seeded synthetic reference state dict at
    the flagship widths (``scene.reference_state_dict``), saved in the
    reference's ``{epoch, model_state_dict, ...}`` envelope and loaded
    with ``load_reference_pth``; every parameter and running statistic
    written, none left at its init value, and predict on cloud 0 finite;
17. the data path at the flagship width, in a workspace under ``build/``
    (deleted after): ``tools.prepare_data.prepare_cloud`` on a 100k-point
    cloud with ``config.yaml``'s ``model.preprocess`` (the numpy
    featurizer, the MLP filter on the card with 37 input channels from a
    synthetic reference-layout ``mlp.pth``, the density voxelizer), the
    card's mask equal to the CPU's but rows within 1e-5 of
    ``trunk_confidence``, each step timed; the GT database of clouds of
    leaning trunks (``scene.tilted_tree_scene``) through
    ``tools.build_gt_database``, the card's ``points_in_boxes`` equal to
    float64 but point-box pairs within 1e-4 m of a face (counted); one
    flagship batch through ``device_augment`` (rotate, scale, flip_x,
    flip_y, translate): every real box holds the same points but those
    within 1e-4 m of a face; ``run_training`` (B = 2 in chunks of 1,
    epochs 0-1) with ``ObjectSample`` (``sample_dict {0: 16}``) and
    ``device_augment``: finite losses, ``num_pos`` > 0, objects pasted in
    each epoch, K1-K4, K6 and K7 launched;
18. serving: the packed top-k against the former cumsum + ``nonzero``
    version on cloud 0's 1.92 M head logits (k = 500) and on the step's
    eight (16, N) prefilter keys (k = 512), equal, both timed; then the
    flagship predict (bf16, the npz) under the default, ``fused_stages``
    and ``pallas_subm_conv`` + ``zfold_pallas`` exported by
    ``serving.export_predict`` at B = 1 (seconds, ``model.pt2`` bytes)
    and saved under ``build/serving_*`` (deleted after); a fresh process
    that imports only ``serving`` (none of the model's modules, nor JAX)
    loads the three artifacts and calls each on clouds 0-3; in this
    process too, each is called on clouds 0-3: bitwise equal to the live
    predict, or boxes and scores within 1e-6 and labels and ``valid``
    exact (the largest difference printed), with exact launches through
    the artifact (K1 and K2 one a cloud, K8 3, K10 2, K9 1); the served
    and live ms per cloud in turns after a warm-up (median of 4), and the
    host syncs of one served and one live call
    (``torch.cuda.set_sync_debug_mode``, ``profile_predict.host_syncs``);
19. the native host passes and the sharded paths: (a) the port's C++
    ``featurize_cloud`` on phase 17's cloud against its numpy features
    (normals |dot| > 0.999 on >= 98% of the >= 4-point neighbourhoods,
    FPFH from shared normals at rtol 2e-4 / atol 2e-3; on the rows that
    read a Darboux angle within 1e-9 of a bin edge, only mass moved
    between theta's first and last bin, their sum within the same
    tolerance), the seconds of each and of phase 17's ``prepare_cloud``
    with the numpy and the default (native) featurizer (both libraries
    loaded before the timing); ``preprocess_cloud`` against the numpy
    pass on two raw clouds with far outliers (equal within 1e-5, best of
    5 ms each); (b) world 1 over nccl in this process, flagship bf16 from
    the npz: the sharded train step at global batch 2 (clouds 1-2)
    against the one-device step (``rank_cases.check_step``: losses rtol
    2e-4; gradients within 1e-4 of each leaf's largest; parameters rtol
    2e-4 / atol 2e-5, within 2 lr where the gradient is within its
    tolerance of 0; the largest differences and bitwise equality
    printed), the sharded predict on the default path, ``fused_stages``
    and ``pallas_subm_conv`` + ``zfold_pallas`` against live (scores
    1e-4, labels exact, boxes 1e-3; bitwise printed), every step kernel
    and K8-K10 launched; (c) two ranks on this card over gloo
    (``parallel.launch.spawn``, whose default backend is gloo there):
    which collectives gloo takes for CUDA tensors (printed), the bf16
    data-parallel step (B = 1 a rank) on three global batches (clouds
    1-2, 3-4, 5-6) against the one-device step (``check_step`` with
    ``bf16_start``: losses, gradients and running statistics within 4
    bf16 ulps of the loss, of the leaf's largest gradient and of the
    leaf's largest move, as the bf16 sums of each rank's half and of the
    whole round apart; parameters as in (b); the ranks bitwise equal;
    the share of each tolerance used printed), the spatial 1 x 2
    predict in bf16 and float32 against live,
    and the spatial 1 x 2 step in float32 (TF32 off, B = 1) at the CPU
    tolerances, K1 and K2 launched on every rank in every run; the same
    spatial predict and step of the gather encoder (``sparse_budget``
    131,072, the npz) and of the dense backbone (phase 20c's config; the
    npz's PFN and encoder, a seeded backbone, neck and head), float32,
    against one device at those tolerances (K1 launched on every rank, K2
    on the dense backbone's only), but the dense backbone's gradients by
    ROADMAP C16's gates (``c16_phase``): its step through the float64
    instrument (``tests/rank_cases.py::to_float64``) whole at the full
    extent and at a 25.6 m window (``scene.tree_scene(1, extent=25.6,
    n_trees=5, n_points=40_960)``), and split where the whole step's peak
    leaves two ranks room; the float64 split within 1e-6 of each leaf's
    largest element of the float64 whole, and the float32 split (TF32
    off) within ``C16_C`` times the larger of two one-device float32
    steps' largest errors on each leaf (the step, and the step from every
    parameter moved by one ulp) plus ``C16_F`` times the leaf's largest
    float64 element; every leaf's share printed.  Times in (c) come from
    two ranks sharing one card;
20. the paths the flagship does not take, at its width: (a) the
    layout-free assignment (the flagship's 1.92 M anchors taken as a grid
    with no layout) of cloud 0's 128 padded GT boxes, through K6 and
    through its plain route: masks, labels, direction targets and
    ``num_pos`` equal, ``best_gt`` equal under ``pos_mask``,
    ``max_overlap`` and the target deltas within 1e-5, K6 one launch and
    no other assignment kernel; K6 on that path's candidates against its
    plain version (1e-5); two bf16 train steps of that model after a
    warm-up (finite losses, ``num_pos`` > 0, K6 one launch a step and no
    K3, K4 or K7), their ms beside phase 9's layout step; (b)
    ``tpu.sparse_middle`` with ``sparse_budget`` 131,072 (the active
    sites of each stage on clouds 0-3, printed, must fit it; the voxel
    budget V would cut stages 1-3): in float32 (TF32 off) from the npz,
    the gather encoder's pseudo-image of cloud 0 within 1e-3 of the
    largest element of the dense encoder's and its detections equal to
    the dense encoder's (valid and labels exact, boxes within 1e-4 of
    each coordinate's size, at least 1 m, scores within 1e-4); in bf16,
    predict on clouds 0-3 (ms, peak memory, C8: cloud 0 twice bitwise
    equal) and two train steps after a warm-up (ms, peak memory); K1 one
    launch a cloud, K2 none; (c)
    ``use_dense_backbone`` with ``config.yaml``'s backbone and neck
    widths and seeded weights: featmap 200 x 200; K1 and K2 on the inputs
    this path gives them (cloud 0) bit-exact against their plain
    versions; predict on clouds 0-3 and two train steps, as in (b), K1
    and K2 one launch a cloud, all six step kernels launched;
21. ``tpu.remat`` at the flagship width (bf16, the npz, phase 9's AdamW):
    at B = 1 under ``false``, ``"rpn"``, ``"middle"`` and ``true`` the
    first step from the npz (its gradients and running statistics bitwise
    equal to ``false``'s), then two timed steps (ms, peak memory); B = 8
    under ``true`` in chunks of 1, 2, 4 and 8 (one warm-up and one timed
    step each: ms and peak memory, or "does not fit" where the card runs
    out of memory, which is a reading, not a failure); K9 exactly 6
    forward and 3 dx launches in one ``zfold_pallas`` step under
    ``"middle"``;
22. the full width against the JAX package: the flagship's float32
    predict (TF32 off, the npz and its ``score_thr``) of clouds 0-3
    against ``tests/jax_reference/flagship_predict.npz``, the JAX
    package's predict of the same clouds (read with numpy; written by
    ``tests/make_jax_flagship_reference.py``): ``valid`` and labels
    exact, scores within 1e-5 and boxes within 1e-4 of max(|value|, 1 m),
    the largest differences and their share of each gate printed; K1 and
    K2 launched.

The last lines are the ``serving`` JSON line (phase 18's readings), the
``parallel`` JSON line (phase 19's), the ``parked`` JSON line (phase
20's), the ``remat`` JSON line (phase 21's), the ``full_width`` JSON
line (phase 22's), the ``kernels`` JSON line
(all eleven
kernels; K1 and K2 with ``launches_tiled`` and ``launches_tiled_batch2``;
K1-K4, K6 and K7 with ``launches_data_path``; K1, K2, K8-K11
with ``launches_serving``, over phase 18's twelve served calls; every
kernel with ``launches_parallel``, over phase 19(b)'s sharded step and
predicts, and K1 and K2 with ``launches_parallel_gloo_ranks``, per rank
and run of (c); K1-K4, K6 and K7 with ``launches_layout_free``,
``launches_sparse_middle`` and ``launches_dense_backbone``, over phase
20's predicts and steps of each path; K9 with ``launches_remat_middle``,
phase 21's one step; K1 and K2 with ``launches_full_width``, over phase
22's four predicts), the card line and
``{"ok": true, "device": {...}}``.
Each phase's wall seconds are printed as ``phase time:`` lines.
"""

import contextlib
import copy
import importlib
import io
import json
import os
import random
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


class PhaseClock:
    """Prints each phase's wall seconds."""

    def __init__(self):
        self.t = time.perf_counter()

    def mark(self, label):
        now = time.perf_counter()
        print(f"phase time: {label}: {now - self.t:.1f} s", flush=True)
        self.t = now


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


def negative_dims_gate(model, batch):
    """C9: K3 on GT rows with negative dims.  Cloud 0's GT chunk 0 with
    three trees' dims negated (one dim, two dims, all three at -30 m),
    launched raw (past the wrapper's check) against the plain version:
    the outputs that differ are printed.  The wrapper must refuse the
    live rows, naming them, and stay bit-exact with the rows masked."""
    from objectdetection_3d_tpu_torch.ops import assign_geometry as geo
    from objectdetection_3d_tpu_torch.ops import cuda_lib
    from objectdetection_3d_tpu_torch.scene import MAX_GT

    layout, combo = model.anchor_layout, model.combo_tab
    cells = layout[0]
    gt = torch.as_tensor(batch["bboxes"][0][:16], device="cuda").clone()
    live = torch.as_tensor(batch["gt_mask"][0][:16], device="cuda")
    gt[1, 3] = -gt[1, 3]
    gt[5, 4:6] = -gt[5, 4:6]
    gt[7, 3:6] = -30.0
    gid = torch.arange(16, dtype=torch.int32, device="cuda")
    ftab, tabs = geo.chunk_tables(gt, live, layout)
    gch, m, nc = 16, combo.shape[1], cells.shape[0]
    n = nc * m
    key = torch.empty((gch, n), dtype=torch.float32, device="cuda")
    outf = torch.empty((4, n), dtype=torch.float32, device="cuda")
    outi = torch.empty((5, n), dtype=torch.int32, device="cuda")
    rmax = torch.empty((gch, nc), dtype=torch.float32, device="cuda")
    cuda_lib.launch("assign_geometry", "chunk_geometry", geo._ARGS_GEOMETRY,
                    (ftab.data_ptr(), gid.data_ptr(), tabs.data_ptr(),
                     combo.data_ptr(), cells.data_ptr(), gch, m, nc, MAX_GT,
                     key.data_ptr(), outf.data_ptr(), outi.data_ptr(),
                     rmax.data_ptr()), torch.device("cuda"))
    want = geo.chunk_geometry_plain(ftab, gid, tabs, combo, cells, MAX_GT)
    torch.cuda.synchronize()
    got = {"key": key, "rmax": rmax,
           **dict(zip(("cm", "v1", "v2", "v3"), outf)),
           **dict(zip(("cb", "a1", "a2", "a3", "mb"), outi))}
    differ = {k: int((got[k] != want[k]).sum()) for k in want
              if not torch.equal(got[k], want[k])}
    print(f"C9 K3 raw launch on 3 live rows with negative dims: outputs "
          f"that differ from the plain version (count of elements) "
          f"{differ or 'none'}; plain rmax minimum "
          f"{float(want['rmax'].min()):.4g}, the kernel's "
          f"{float(rmax.min()):.4g}", flush=True)
    try:
        geo.chunk_geometry(ftab, gid, tabs, combo, cells, MAX_GT)
    except ValueError as e:
        if "[1, 5, 7]" not in str(e):
            raise AssertionError(f"C9: the refusal names other rows: {e}")
    else:
        raise AssertionError("C9: chunk_geometry took live rows with "
                             "negative dims")
    masked = live.clone()
    masked[[1, 5, 7]] = False
    ftab, tabs = geo.chunk_tables(gt, masked, layout)
    got = geo.chunk_geometry(ftab, gid, tabs, combo, cells, MAX_GT)
    want = geo.chunk_geometry_plain(ftab, gid, tabs, combo, cells, MAX_GT)
    torch.cuda.synchronize()
    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"C9: with the negative rows masked, "
                                 f"chunk_geometry {k!r} differs from its "
                                 f"plain version")
    print("C9 K3 wrapper: refuses the live rows [1, 5, 7] (ValueError); "
          "with them masked, bit-exact on all 11 outputs", flush=True)
    return differ


def _index_add_centroid(values, seg, num_segments, frac_bits):
    """The PFN's centroid sum before the C8 repair: float32 atomics."""
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values).double()


def centroid_sums(model, batch):
    """C8: the PFN's fixed-point centroid sum against the float32
    ``index_add_`` it replaced, on cloud 0's flagship rows (the voxelizer's
    ``seg``, valid xyz): device ms, and whether 20 calls give one bit
    pattern."""
    from objectdetection_3d_tpu_torch.models.layers import (
        fixed_point_segment_sum,
    )

    pts = torch.as_tensor(batch["points"], device="cuda")
    vox = model.voxel_layer.points_batch(
        pts, torch.as_tensor(batch["num_points"], device="cuda"))
    nseg = vox["num_points_per_voxel"].shape[1] + 1
    seg = vox["pt_voxel"].reshape(-1).long()
    vals = torch.where(vox["pt_valid"].reshape(-1)[:, None],
                       vox["points"].reshape(-1, pts.shape[-1])[:, :3], 0.0)
    bits = model.net.voxel_encoder.frac_bits
    out = {}
    for name, fn in (("fixed_point", fixed_point_segment_sum),
                     ("index_add_", _index_add_centroid)):
        first = fn(vals, seg, nseg, bits)
        same = all(torch.equal(first, fn(vals, seg, nseg, bits))
                   for _ in range(20))
        out[name] = {"ms": cuda_ms(lambda fn=fn: fn(vals, seg, nseg, bits),
                                   100), "reproducible": same}
    if not out["fixed_point"]["reproducible"]:
        raise AssertionError("C8: the fixed-point centroid sum differs "
                             "between calls")
    print(f"C8 centroid sum, {seg.numel()} rows into {nseg} voxels: "
          f"fixed point {out['fixed_point']['ms']:.4f} ms (20 calls "
          f"bitwise equal), float32 index_add_ "
          f"{out['index_add_']['ms']:.4f} ms (20 calls bitwise equal: "
          f"{out['index_add_']['reproducible']})", flush=True)
    return out


def reproducible_steps(model, tx, step, batches, start, losses, times):
    """C8: phase 9's three timed steps again from the same start (the
    state after the warm-up), deterministic mode off: first with the
    centroid's float32 ``index_add_`` (the step before the repair, timed
    only), then as they ran: losses and every parameter and running
    statistic bitwise equal."""
    from objectdetection_3d_tpu_torch.models import layers

    first = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    runs = {}
    for name, sum_fn in (("index_add_", _index_add_centroid),
                         ("fixed_point", layers.fixed_point_segment_sum)):
        model.net.load_state_dict(start[0])
        tx.load_state_dict(copy.deepcopy(start[1]))
        kept, layers.fixed_point_segment_sum = (
            layers.fixed_point_segment_sum, sum_fn)
        try:
            ms, outs = [], []
            for i in (1, 2, 3):
                t = time.perf_counter()
                outs.append(step(batches[i]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
        finally:
            layers.fixed_point_segment_sum = kept
        runs[name] = (ms, outs)
    again = runs["fixed_point"][1]
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("C8: deterministic mode is on")
    for a, b in zip(losses, again):
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"C8: the repeated steps' losses differ: "
                                 f"{a} vs {b}")
    second = model.net.state_dict()
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    if differ:
        raise AssertionError(f"C8: after the repeated steps {len(differ)} "
                             f"arrays differ: {differ[:5]}")
    print(f"C8 three bf16 train steps twice from one start (deterministic "
          f"mode off): losses and all {len(first)} arrays bitwise equal; "
          f"step ms fixed-point {', '.join(f'{t * 1e3:.1f}' for t in times)}"
          f" / index_add_ "
          f"{', '.join(f'{t:.1f}' for t in runs['index_add_'][0])} / "
          f"fixed-point again "
          f"{', '.join(f'{t:.1f}' for t in runs['fixed_point'][0])}",
          flush=True)


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


def norm_entry(model, batch):
    """Phase 10b, K11: the ten eval stage norms of cloud 0's predict (the
    npz weights), each on its real input (the conv's output, the mask and
    the batch norm's eval affine), in bf16 and float32 bitwise equal to the
    plain version, then timed in bf16 beside its bound (x and the mask
    read once, y written once), the plain version and the ATen chain it
    replaces (``library_ms``).  Returns the ``kernels`` entry."""
    import torch.nn.functional as F

    from objectdetection_3d_tpu_torch.ops.masked_norm import (
        masked_affine_relu,
        masked_affine_relu_plain,
    )

    enc = model.net.pseudoimage_generator
    ins = stage_inputs(model, batch, len(enc.out_channels))
    rows = []
    with torch.inference_mode():
        for i, (x, m) in enumerate(ins):
            xs = enc._subm_conv3d(x, i)
            wd = getattr(enc, f"down_{i}_kernel").to(enc.dtype)
            y = enc._eval_norm(xs, m, getattr(enc, f"subm_bn_{i}"))
            md = F.max_pool3d(m, (3, 1, 1), (2, 1, 1))
            xd = F.conv3d(y, wd, stride=(2, 1, 1))
            del y
            for kind, xk, mk in (("subm", xs, m), ("down", xd, md)):
                bn = getattr(enc, f"{kind}_bn_{i}")
                xn, mn = xk.permute(0, 2, 3, 4, 1), mk[:, 0].contiguous()
                a, b = bn.eval_affine()
                for dt in (torch.bfloat16, torch.float32):
                    xi, mi = xn.to(dt), mn.to(dt)
                    got = masked_affine_relu(xi, mi, a, b)
                    want = masked_affine_relu_plain(xi, mi, a, b)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K11 stage {i} {kind} ({dt}) differs from its "
                            f"plain version by {max_abs_err(got, want)}")
                    del got, want, xi, mi
                b_, d, h, w, c = xn.shape
                e, pix = b_ * d * h * w * c, b_ * d * h * w
                itemsize = xn.element_size()
                b_ms, b_by = bound(2 * e * itemsize + pix * itemsize
                                   + 8 * c, 4 * e)
                if kind == "subm":
                    def chain(xk=xk, mk=mk, bn=bn):
                        return F.relu(bn(xk * mk, mk))
                else:
                    def chain(xk=xk, mk=mk, bn=bn):
                        return F.relu(bn(xk, mk))
                ms = cuda_ms(lambda: masked_affine_relu(xn, mn, a, b), 10)
                rows.append({
                    "stage": i, "norm": kind, "shape": [b_, d, h, w, c],
                    "ms": ms,
                    "plain_ms": cuda_ms(
                        lambda: masked_affine_relu_plain(xn, mn, a, b), 3),
                    "library_ms": cuda_ms(chain, 10),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "share": b_ms / ms})
                r = rows[-1]
                print(f"K11 stage {i} {kind} {r['shape']}: {ms:.4f} ms, "
                      f"share of bound {r['share']:.3f} (bound "
                      f"{b_ms:.4f} ms, {b_by}), ATen chain "
                      f"{r['library_ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms; bitwise equal to plain "
                      f"in bf16 and float32", flush=True)
            del xs, xd, md
            torch.cuda.empty_cache()
    del ins
    torch.cuda.empty_cache()
    entry = {"name": "masked_affine_relu", "route": "cuda",
             "source": "objectdetection_3d_tpu_torch/csrc/masked_norm.cu",
             "replaces": None, "max_abs_err": 0.0}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        entry[key] = sum(r[key] for r in rows)
    entry["bound_by"] = "bytes"
    entry["share"] = entry["bound_ms"] / entry["ms"]
    entry["share_stage0_subm"] = rows[0]["share"]
    entry["norms"] = rows
    print(f"K11 over the ten norms: {entry['ms']:.4f} ms against the ATen "
          f"chain's {entry['library_ms']:.4f} ms; share of bound "
          f"{entry['share']:.3f} (stage 0 subm {rows[0]['share']:.3f})",
          flush=True)
    return entry


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
    from objectdetection_3d_tpu_torch.ops.masked_norm import (
        masked_affine_relu,
    )
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
                "conv2d_3x3_dx": conv2d_3x3.dx_launches,
                "masked_affine_relu": masked_affine_relu.launches}

    knob_sets = (
        ({"fused_stages": True}, {"fused_stage": 3, "masked_affine_relu": 4}),
        ({"pallas_subm_conv": True, "zfold_pallas": True},
         {"subm_conv3d": 2, "conv2d_3x3": 1, "masked_affine_relu": 10}))
    from objectdetection_3d_tpu_torch.models import layers

    # does the K10 wrapper's x.contiguous() copy on the predict path?
    contiguous = []

    def watched(x, kernel):
        contiguous.append(x.is_contiguous())
        return subm_conv3d(x, kernel)

    # K11 copies nothing: does each norm get a contiguous channels-last
    # view of the whole of its conv's output, and a contiguous mask?
    norm_views = []

    def watched_norm(x, mask, a, b):
        whole = x.untyped_storage().nbytes() == x.numel() * x.element_size()
        norm_views.append(x.is_contiguous() and whole
                          and mask.is_contiguous())
        return masked_affine_relu(x, mask, a, b)

    launches = {}
    for tpu, per_cloud in knob_sets:
        model = knob_model(tpu)
        predict = model.make_predict_fn()
        layers.subm_conv3d = watched
        layers.masked_affine_relu = watched_norm
        try:
            predict(batches[0])             # warm-up
        finally:
            layers.subm_conv3d = subm_conv3d
            layers.masked_affine_relu = masked_affine_relu
        torch.cuda.synchronize()
        fused_stage.launches = subm_conv3d.launches = 0
        conv2d_3x3.launches = conv2d_3x3.dx_launches = 0
        masked_affine_relu.launches = 0
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
    print(f"K11 inputs on the predict path views of the conv outputs, "
          f"contiguous: {norm_views}", flush=True)
    if not all(norm_views):
        raise AssertionError("a K11 input on the predict path is not a "
                             "contiguous view of its conv's output")
    launches["masked_affine_relu_inputs_contiguous"] = norm_views
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
    # the flagship's remat: true recomputes the encoder in the backward,
    # which launches its 3 K9 forwards again
    forward = 3 * (2 if "middle" in model.net.remat_regions else 1)
    if k9 != {"forward": 2 * forward, "dx": 6}:
        raise AssertionError(f"K9 launches in 2 zfold steps: {k9}, expected "
                             f"{forward} forward (with the recompute) and "
                             f"3 dx per step")
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


OPT = dict(lr=1e-3, betas=(0.95, 0.99), weight_decay=0.01)
CLIP = 2.0


def _step_run(model, start, batch, microbatch):
    """One train step from the state ``start`` with a fresh optimizer:
    (losses, the gradients its update received, the state after)."""
    model.net.load_state_dict(start)
    tx = model.get_optimizer(OPT, grad_clip_value=CLIP)
    grads, update = {}, tx.step

    def step_recording(closure=None):
        for name, p in model.net.named_parameters():
            grads[name] = p.grad.detach().clone()
        return update(closure)

    tx.step = step_recording
    out = model.make_train_step(tx, microbatch=microbatch)(batch)
    torch.cuda.synchronize()
    state = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    return {k: float(v) for k, v in out.items()}, grads, state


def accumulation(scenes, counted):
    """Phase 13: gradient accumulation at the flagship width.  Returns
    each counted kernel's launches over the timed B = 8 steps."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.scene import make_batch

    model = PointPillars(configs.flagship_cfg(), device="cuda")
    load_npz(model.net, NPZ)
    p_max = model.tpu_cfg["max_points_static"]
    start = {k: v.detach().clone() for k, v in model.net.state_dict().items()}

    # B = 1: one chunk against the monolithic step, cloud 1
    one = make_batch(scenes[1], p_max)
    l_mono, g_mono, s_mono = _step_run(model, start, one, None)
    l_acc, g_acc, s_acc = _step_run(model, start, one, 1)
    for k, v in l_mono.items():
        if abs(l_acc[k] - v) > 1e-5 * abs(v):
            raise AssertionError(f"microbatch=1 loss {k} {l_acc[k]} vs "
                                 f"monolithic {v}")
    worst = {"grad": 0.0, "param": 0.0, "param_raw": 0.0, "stats": 0.0}
    for k, want in s_mono.items():
        got = s_acc[k]
        scale = float(want.abs().max())
        err = (got - want).abs()
        if k not in g_mono:                 # running statistics
            worst["stats"] = max(worst["stats"], float(err.max()) / scale)
            if not bool((err <= 1e-4 * scale + 1e-5).all()):
                raise AssertionError(f"microbatch=1 running stat {k}")
            continue
        g = g_mono[k].abs()
        gscale = float(g.max())
        gerr = float((g_acc[k] - g_mono[k]).abs().max())
        worst["grad"] = max(worst["grad"], gerr / max(gscale, 1e-30))
        if gerr > 1e-4 * gscale:
            raise AssertionError(f"microbatch=1 gradient {k}: {gerr} of "
                                 f"{gscale}")
        # AdamW's first step moves an element by lr * g / (|g| + 1e-8):
        # where g lies below the gradient tolerance the two differ by up
        # to 2 lr; elsewhere 1e-4 of the leaf's largest element
        sure = g > 1e-4 * gscale
        worst["param_raw"] = max(worst["param_raw"], float(err.max()))
        if bool(sure.any()):
            worst["param"] = max(worst["param"],
                                 float(err[sure].max()) / scale)
        if not bool((err[sure] <= 1e-4 * scale + 1e-5).all()) or not bool(
                (err[~sure] <= 2 * OPT["lr"] + 1e-5).all()):
            raise AssertionError(f"microbatch=1 parameter {k}")
    print(f"accumulation B=1: microbatch=1 == monolithic on cloud 1; "
          f"losses {l_acc}; worst gradient {worst['grad']:.3g} of its "
          f"leaf's largest, parameter {worst['param']:.3g} (raw "
          f"{worst['param_raw']:.3g}), running statistic "
          f"{worst['stats']:.3g}", flush=True)
    del g_mono, g_acc, s_mono, s_acc

    # B = 8: clouds 0-7, microbatch 1 and 2
    items = [make_batch(sc, p_max) for sc in scenes[:8]]
    batch8 = {k: np.concatenate([it[k] for it in items]) for k in items[0]}
    launches = {}
    for mb in (1, 2):
        model.net.load_state_dict(start)
        step = model.make_train_step(
            model.get_optimizer(OPT, grad_clip_value=CLIP), microbatch=mb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(batch8)                        # warm-up
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        times = []
        for _ in range(2):
            t = time.perf_counter()
            out = step(batch8)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            vals = {k: float(v) for k, v in out.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"B=8 microbatch={mb}: non-finite "
                                     f"{vals}")
            if vals["num_pos"] <= 0:
                raise AssertionError(f"B=8 microbatch={mb}: no positive")
        counts = {name: fn.launches for name, fn in counted.items()}
        if not all(counts.values()):
            raise AssertionError(f"B=8 microbatch={mb}: a kernel did not "
                                 f"launch: {counts}")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        after = model.net.state_dict()
        unchanged = [k for k in start if torch.equal(start[k], after[k])]
        if unchanged:
            raise AssertionError(f"B=8 microbatch={mb} left {unchanged} "
                                 f"unchanged")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"accumulation B=8 microbatch={mb}: {times[0] * 1e3:.1f}, "
              f"{times[1] * 1e3:.1f} ms per step (wall, after one "
              f"warm-up; losses {vals}); peak memory {peak:.2f} GiB "
              f"(max_memory_allocated); launches in 2 steps {counts}; all "
              f"{len(start)} arrays changed", flush=True)
    try:
        model.make_train_step(model.get_optimizer(OPT), microbatch=3)(
            batch8)
    except ValueError as e:
        print(f"accumulation B=8 microbatch=3: ValueError ({e})")
    else:
        raise AssertionError("microbatch=3 at B=8 did not raise")
    return launches


def write_forest_split(directory, seeds, scene_fn=None):
    """Tree scenes (``scene_fn``, default ``scene.tree_scene``) written in
    the dataset's disk contract: box z at the centre, angles in
    degrees."""
    from objectdetection_3d_tpu_torch.scene import tree_scene

    os.makedirs(directory)
    for seed in seeds:
        cloud, boxes = (scene_fn or tree_scene)(seed)
        disk = boxes.astype(np.float32).copy()
        disk[:, 2] += disk[:, 5] / 2
        disk[:, 6:] = np.rad2deg(disk[:, 6:])
        np.save(os.path.join(directory, f"scene_{seed}.npy"), cloud)
        np.save(os.path.join(directory, f"scene_{seed}_bbx.npy"), disk)


def pipeline_cfg(root, inference_mode, resume_from=None, **pipeline):
    """The pipeline's config as a dict: the flagship model, the port's
    default static budgets with the flagship's, one train epoch of
    B = 2 in chunks of 1; ``pipeline`` overrides keys of its
    ``pipeline`` section."""
    from objectdetection_3d_tpu_torch import configs

    model = configs.flagship_cfg()
    tpu = dict(model.pop("tpu"), microbatch=1)
    return {
        "global_args": {"device": "cuda", "seed": 0,
                        "output_path": os.path.join(root, "output") + "/",
                        "box_params_num": 9, "model_dim": 3},
        "dataset": {"name": "tree_scenes",
                    "dataset_path": os.path.join(root, "data") + "/"},
        "model": model,
        "tpu": tpu,
        "pipeline": {
            "name": "ObjectDetection", "inference_mode": inference_mode,
            "is_resume": False, "resume_from": resume_from,
            "training_batch_size": 2, "validation_batch_size": 1,
            "testing_batch_size": 1, "max_epoch": 1, "save_ckpt_freq": 1,
            "validation_freq": 1, "grad_clip_norm": CLIP,
            "num_workers": 0, "optimizer": dict(OPT), "overlaps": [0.1],
            **pipeline},
    }


def dcp_checkpoints(root, prf_pth):
    """Phase 14 under ``ckpt_backend: orbax``: ``run_training`` writes
    ``.dcp`` directories, a resume starts at the next epoch, and
    ``run_testing`` from a ``ckpt_best.dcp`` of the npz gives the P/R/F1
    ``prf_pth`` of the ``.pth`` run."""
    from objectdetection_3d_tpu_torch.config import Config
    from objectdetection_3d_tpu_torch.entry import build_pipeline
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io

    def build(inference_mode, version=None, **pipeline):
        return build_pipeline(cfg=Config(pipeline_cfg(
            root, inference_mode, version, ckpt_backend="orbax",
            **pipeline)))[0]

    def version_of(pipe):
        return os.path.basename(os.path.dirname(
            os.path.dirname(pipe.cfg.log_dir.rstrip("/") + "/")))

    t = time.perf_counter()
    pipe = build(False)
    pipe.run_training()
    ckpt_dir = os.path.join(pipe.cfg.log_dir, "checkpoint")
    written = sorted(os.listdir(ckpt_dir))
    if not {"ckpt_00000.dcp", "ckpt_00001.dcp"} <= set(written) or \
            any(n.endswith(".pth") for n in written):
        raise AssertionError(f"orbax run_training wrote {written}")
    train_s = time.perf_counter() - t
    version = version_of(pipe)
    del pipe
    torch.cuda.empty_cache()

    t = time.perf_counter()
    resumed = build(False, version, is_resume=True, max_epoch=2)
    first, path = resumed.load_ckpt()
    record = resumed.run_training()
    last = ckpt_io.load_ckpt(os.path.join(ckpt_dir, "ckpt_00002.dcp"))
    steps = {int(v["step"])
             for v in last["optimizer_state_dict"]["state"].values()}
    # one step an epoch (two training clouds, B = 2): two before the
    # resume, one after
    if first != 2 or not path.endswith("ckpt_00001.dcp") or \
            [r["epoch"] for r in record] != [0, 1, 2] or \
            last["epoch"] != 2 or steps != {3}:
        raise AssertionError(f"orbax resume: first epoch {first} from "
                             f"{path}; record {record}; epoch "
                             f"{last['epoch']}, Adam steps {steps}")
    resume_s = time.perf_counter() - t
    del resumed, last
    torch.cuda.empty_cache()

    tester = build(True, "2026-01-01-00-00-01")
    best = os.path.join(tester.cfg.log_dir, "checkpoint", "ckpt_best.dcp")
    os.makedirs(os.path.dirname(best))
    load_npz(tester.model.net, NPZ)
    ckpt_io.save_ckpt(best, 0, tester.model.net, backend="dcp")
    if tester.load_ckpt()[1] != best:
        raise AssertionError("orbax run_testing did not take "
                             "ckpt_best.dcp")
    protocol = tester.run_testing()
    prf = [protocol[k] for k in ("4_precision", "5_recall", "6_f1")]
    if repr(prf) != repr(prf_pth):
        raise AssertionError(f"run_testing from ckpt_best.dcp: {prf}, "
                             f"from ckpt_best.pth {prf_pth}")
    print(f"pipeline under ckpt_backend: orbax: run_training {train_s:.2f} "
          f"s wrote {written}; resumed at epoch {first}, record epochs "
          f"{[r['epoch'] for r in record]}, Adam steps {steps} "
          f"({resume_s:.2f} s); run_testing from ckpt_best.dcp P/R/F1 "
          f"{prf} == the .pth run's", flush=True)
    del tester
    torch.cuda.empty_cache()


def pipeline_phase(counted):
    """Phase 14: the pipeline at the flagship width.  Returns each counted
    kernel's launches in ``run_training``."""
    import shutil
    import tempfile

    from objectdetection_3d_tpu_torch.config import Config
    from objectdetection_3d_tpu_torch.entry import build_pipeline
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io
    from objectdetection_3d_tpu_torch.pipeline.pipeline import (
        read_flat_yaml,
    )

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="pipeline_", dir=os.path.join(REPO,
                                                                  "build"))
    try:
        for split, seeds in (("training", (4, 5)), ("validation", (6,)),
                             ("testing", (7,))):
            write_forest_split(os.path.join(root, "data", split), seeds)

        # run_training from scratch, with its step and validation timed
        pipe, _ = build_pipeline(cfg=Config(pipeline_cfg(root, False)))
        model = pipe.model
        step_ms, valid_s = [], []
        make_step, run_valid = model.make_train_step, pipe.run_valid

        def timed_make(tx, microbatch=None):
            step = make_step(tx, microbatch=microbatch)

            def run(batch):
                t = time.perf_counter()
                out = step(batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                return out
            return run

        def timed_valid():
            t = time.perf_counter()
            out = run_valid()
            valid_s.append(time.perf_counter() - t)
            return out

        model.make_train_step, pipe.run_valid = timed_make, timed_valid
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        record = pipe.run_training()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counted.items()}
        if not all(launches.values()):
            raise AssertionError(f"run_training: a kernel did not launch: "
                                 f"{launches}")
        for k, vals in pipe.losses.items():
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"run_training: non-finite {k}")
        log_dir = pipe.cfg.log_dir
        files = os.listdir(log_dir)
        missing = [f for f in ("process_config.json", "training_record.csv")
                   if f not in files]
        if missing or not any(f.startswith("log_train_") for f in files) \
                or not os.path.exists(os.path.join(
                    log_dir, "checkpoint", "ckpt_00001.pth")):
            raise AssertionError(f"run_training artifacts: {files}, "
                                 f"missing {missing}")
        print(f"pipeline run_training: {train_s:.2f} s wall for "
              f"{len(step_ms)} steps (B=2 in chunks of 1) and "
              f"{len(valid_s)} validations; train step "
              f"{', '.join(f'{v:.1f}' for v in step_ms)} ms; validation "
              f"{', '.join(f'{v:.2f}' for v in valid_s)} s; record "
              f"{record}; launches {launches}", flush=True)
        del pipe, model
        torch.cuda.empty_cache()

        # run_testing from a ckpt_best.pth written from the npz
        version = "2026-01-01-00-00-00"
        tester, _ = build_pipeline(cfg=Config(pipeline_cfg(root, True,
                                                           version)))
        ckpt_dir = os.path.join(tester.cfg.log_dir, "checkpoint")
        os.makedirs(ckpt_dir)
        load_npz(tester.model.net, NPZ)
        ckpt_io.save_ckpt(os.path.join(ckpt_dir, "ckpt_best.pth"), 0,
                          tester.model.net)
        t = time.perf_counter()
        protocol = tester.run_testing()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        saved = read_flat_yaml(os.path.join(tester.cfg.log_dir, "test",
                                            "test_protocol.yaml"))
        if repr(saved) != repr(protocol):
            raise AssertionError(f"test_protocol.yaml reads back {saved}, "
                                 f"not {protocol}")
        prf = [protocol[k] for k in ("4_precision", "5_recall", "6_f1")]
        if not all(np.isfinite(prf)):
            raise AssertionError(f"run_testing: {protocol}")
        print(f"pipeline run_testing: {test_s:.2f} s wall (1 cloud); "
              f"precision {prf[0]:.2f}, recall {prf[1]:.2f}, F1 "
              f"{prf[2]:.2f}", flush=True)

        # run_inference on the testing cloud against predict
        split = tester.dataset.get_split("testing")
        data = tester.model.preprocess(split.get_data(0),
                                       split.get_attr(0))
        dets = tester.run_inference(data, validate=True)[0]
        batch = tester.batcher.collate([{"data": data, "attr": {}}])
        preds = tester.model.predict(batch.arrays)
        want = tester.model.inference_end(preds)[0]
        if len(dets) != len(want) or not dets:
            raise AssertionError(f"run_inference: {len(dets)} detections, "
                                 f"predict {len(want)}")
        err = max(float(np.abs(d["bbox"] - w["bbox"]).max())
                  for d, w in zip(dets, want))
        if err > 1e-5 or any(d["label"] != w["label"]
                             for d, w in zip(dets, want)):
            raise AssertionError(f"run_inference vs predict: boxes {err}")
        print(f"pipeline run_inference: {len(dets)} detections == predict "
              f"(boxes within {err:.3g})", flush=True)

        # show_inference on the testing split, from the same checkpoint
        try:
            import matplotlib  # noqa: F401
            drawn = True
        except ImportError:
            drawn = False
            print("show_inference: no matplotlib, PNG not drawn", flush=True)
            tester._draw = lambda data, prediction: None
        random.seed(0)
        shown = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(shown):
            pred = tester.show_inference()
        show_s = time.perf_counter() - t
        shown = shown.getvalue()
        print(shown, end="", flush=True)
        if set(pred) != {"bbox", "label", "score"}:
            raise AssertionError(f"show_inference returned {set(pred)}")
        lines = shown.splitlines()
        head = [i for i, line in enumerate(lines)
                if "==== Precision ==== Recall ==== F1 ====" in line]
        if len(head) != 1 or [line.split(":")[0] for line in
                              lines[head[0] + 1:head[0] + 4]] != [
                "Overall_precision", "Overall_recall", "F1"]:
            raise AssertionError("show_inference printed no P/R/F1 block")
        pngs = [f for f in os.listdir(tester.cfg.log_dir)
                if f.startswith("show_inference_") and f.endswith(".png")]
        if drawn and not pngs:
            raise AssertionError("show_inference wrote no PNG")
        print(f"pipeline show_inference: {show_s:.2f} s wall; "
              f"{len(pred['bbox'])} detections; PNG "
              f"{pngs if drawn else 'not drawn'}", flush=True)
        del tester
        torch.cuda.empty_cache()
        dcp_checkpoints(root, prf)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def face_gap64(points, boxes):
    """(P, N) float64 distance of each point to the nearest face plane of
    each box along the box's axes, and the (P, N) float64 membership
    (numpy, the reference of the card's ``points_in_boxes``)."""
    from objectdetection_3d_tpu_torch.scene import _rotation_zyx

    points = np.asarray(points, np.float64)[:, :3]
    boxes = np.asarray(boxes, np.float64)
    rot = np.stack([_rotation_zyx(*b[6:9]) for b in boxes])   # (N, 3, 3)
    mid = boxes[:, :3] + rot[:, :, 2] * boxes[:, 5:6] / 2
    proj = np.einsum("pnk,nkj->pnj", points[:, None] - mid[None], rot)
    excess = np.abs(proj) * 2 - boxes[None, :, 3:6]
    return np.abs(excess).min(-1) / 2, (excess < 0).all(-1)


def card_in_boxes(points, boxes):
    """The card's ``points_in_boxes`` of numpy or tensor inputs, as a
    numpy (P, N) mask."""
    from objectdetection_3d_tpu_torch.ops.boxes import points_in_boxes

    return points_in_boxes(
        torch.as_tensor(points, device="cuda")[:, :3].float().contiguous(),
        torch.as_tensor(boxes, device="cuda").float()).cpu().numpy()


DEVICE_AUGMENT = {"rotate": {"min": 0.0, "max": 6.283}, "scale": {},
                  "flip_x": True, "flip_y": True, "translate": {"std": 0.5}}


def data_path_phase(counted):
    """Phase 17: the data-preparation and augmentation path at the
    flagship width.  Returns each counted kernel's launches in its
    ``run_training``, and the prepared cloud's numpy features with the
    featurizer's and ``prepare_cloud``'s seconds."""
    import shutil
    import tempfile

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.config import Config
    from objectdetection_3d_tpu_torch.entry import build_pipeline
    from objectdetection_3d_tpu_torch.models import preprocess_tools as pre
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.scene import (
        make_batch,
        reference_mlp_state_dict,
        tilted_tree_scene,
        tree_scene,
    )
    from objectdetection_3d_tpu_torch.tools import build_gt_database
    from objectdetection_3d_tpu_torch.tools.prepare_data import prepare_cloud

    def quiet(*args):
        return None

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="data_path_", dir=os.path.join(REPO,
                                                                   "build"))
    try:
        # ---- prepare: featurize (numpy), filter (MLP on the card),
        # density voxelizer (host) on a 100k-point cloud ---------------
        models_dir = os.path.join(root, "models")
        os.makedirs(models_dir)
        torch.save({k: torch.from_numpy(v) for k, v in
                    reference_mlp_state_dict(37, seed=0).items()},
                   os.path.join(models_dir, "mlp.pth"))
        cfg = configs.preprocess_cfg(models_dir + "/")
        cfg["featurizer"]["backend"] = "numpy"
        cloud, _ = tree_scene(0)
        t = time.perf_counter()
        feats = pre.Featurizer(**cfg["featurizer"]).generate_features(cloud)
        feat_s = time.perf_counter() - t
        card = pre.ForegroundFilter(cfg["filter"], device="cuda")
        host = pre.ForegroundFilter(cfg["filter"], device="cpu")
        card.probabilities(feats)          # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        p_card = card.probabilities(feats)
        filt_ms = (time.perf_counter() - t) * 1e3
        p_host = host.probabilities(feats)
        thr = card.trunk_prob
        near = np.abs(p_host - thr) <= 1e-5
        mask = p_card > thr
        wrong = int(((mask != (p_host > thr)) & ~near).sum())
        if wrong:
            raise AssertionError(f"prepare: the card's filter mask differs "
                                 f"from the CPU's on {wrong} rows")
        t = time.perf_counter()
        vox = pre.CustomVoxelizer(**cfg["voxelization"]).voxelize(
            cloud[mask])
        vox_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out = prepare_cloud(cloud, cfg, log=quiet, device="cuda")
        chain_s = time.perf_counter() - t
        if not np.array_equal(out, np.ascontiguousarray(
                vox[:, :cloud.shape[1]], np.float32)):
            raise AssertionError("prepare: prepare_cloud differs from its "
                                 "steps run one by one")
        print(f"data path prepare ({len(cloud)} points, config.yaml's "
              f"model.preprocess, a synthetic reference mlp.pth, 37 input "
              f"channels): featurizer (numpy) {feat_s:.2f} s -> "
              f"{feats.shape[1]} columns; MLP filter on the card "
              f"{filt_ms:.1f} ms, kept {int(mask.sum())} (card == CPU, "
              f"{int(near.sum())} rows within 1e-5 of {thr}); density "
              f"voxelizer {vox_ms:.1f} ms -> {len(vox)} points; "
              f"prepare_cloud {chain_s:.2f} s -> {out.shape}", flush=True)
        # the same chain with the featurizer's default backend (open3d,
        # else the native library); phase 19 holds the native featurizer
        # against the numpy features
        native_cfg = dict(cfg, featurizer=dict(cfg["featurizer"]))
        del native_cfg["featurizer"]["backend"]
        from objectdetection_3d_tpu_torch import native
        t = time.perf_counter()
        native.load(), native.load_featurize()    # g++, outside the timing
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        out_native = prepare_cloud(cloud, native_cfg, log=quiet,
                                   device="cuda")
        prepared = {"cloud": cloud, "cfg": cfg, "feats": feats,
                    "feat_s": feat_s, "prepare_s": chain_s,
                    "prepare_native_s": time.perf_counter() - t,
                    "native_build_s": build_s,
                    "prepare_points": (len(out), len(out_native))}
        del feats, p_card, p_host

        # ---- GT database of leaning trunks ---------------------------
        data = os.path.join(root, "data")
        for split, seeds in (("training", (0, 1)), ("validation", (2,)),
                             ("testing", (3,))):
            write_forest_split(os.path.join(data, split), seeds,
                               tilted_tree_scene)
        db_path = os.path.join(root, "gt_database.pkl")
        ds_cfg = Config({"dataset": {"name": "tilted_trees",
                                     "dataset_path": data + "/", "seed": 0,
                                     "gt_db_min_points": 5}})
        t = time.perf_counter()
        db = build_gt_database.build(ds_cfg, db_path, device="cuda",
                                     log=quiet)
        db_s = time.perf_counter() - t
        from objectdetection_3d_tpu_torch.dataset import Forest3D
        split = Forest3D(**ds_cfg.dataset).get_split("training")
        n_near = n_pts = 0
        for i in range(len(split)):
            item = split.get_data(i)
            got = card_in_boxes(item["point"], item["bboxes"])
            gap, want = face_gap64(item["point"], item["bboxes"])
            bad = (got != want) & (gap >= 1e-4)
            if bad.any():
                raise AssertionError(f"GT database: the card's "
                                     f"points_in_boxes differs from float64 "
                                     f"on {int(bad.sum())} point-box pairs "
                                     f"off the faces")
            n_near += int(((got != want) | (gap < 1e-4)).sum())
            n_pts += int(got.sum())
        n_obj = sum(len(v) for v in db.values())
        print(f"data path GT database: {n_obj} objects ({n_pts} interior "
              f"points) from {len(split)} training clouds of leaning "
              f"trunks in {db_s:.2f} s; the card's points_in_boxes == "
              f"float64 but {n_near} point-box pairs within 1e-4 m of a "
              f"face", flush=True)
        if n_obj == 0:
            raise AssertionError("GT database: no object")

        # ---- one augmented flagship batch on the card -----------------
        aug_cfg = dict(configs.flagship_cfg(), device_augment=DEVICE_AUGMENT)
        model = PointPillars(aug_cfg, device="cuda")
        scene = tilted_tree_scene(4)
        batch = make_batch(scene, model.tpu_cfg["max_points_static"])
        t = time.perf_counter()
        out = model.augment(batch)
        torch.cuda.synchronize()
        aug_ms = (time.perf_counter() - t) * 1e3
        n = int(batch["num_points"][0])
        g = len(scene[1])
        before_pts = batch["points"][0, :n]
        after_pts = out["points"][0, :n].cpu().numpy()
        after_boxes = out["bboxes"][0, :g].cpu().numpy()
        in0 = card_in_boxes(before_pts, scene[1])
        in1 = card_in_boxes(after_pts, after_boxes)
        gap0, _ = face_gap64(before_pts, scene[1])
        gap1, _ = face_gap64(after_pts, after_boxes)
        near = (gap0 < 1e-4) | (gap1 < 1e-4)
        moved = int(((in0 != in1) & ~near).sum())
        if moved or int(in0.sum()) == 0:
            raise AssertionError(f"augment: {moved} point-box memberships "
                                 f"changed off the faces")
        print(f"data path augment (rotate, scale, flip_x, flip_y, "
              f"translate) of a flagship batch of leaning trunks: "
              f"{aug_ms:.2f} ms; each of the {g} boxes holds the same "
              f"points ({int(in0.sum())} memberships) but "
              f"{int((near & (in0 | in1)).sum())} within 1e-4 m of a face",
              flush=True)
        del model, out

        # ---- run_training with ObjectSample and device_augment --------
        pcfg = pipeline_cfg(root, False)
        pcfg["model"]["augment"] = {"PointShuffle": True, "ObjectSample": {
            "db_path": db_path, "sample_dict": {0: 16}}}
        pcfg["model"]["device_augment"] = DEVICE_AUGMENT
        pipe, _ = build_pipeline(cfg=Config(pcfg))
        model = pipe.model
        pasted, num_pos, step_ms = [], [], []
        sample = model.augmentor.ObjectSample

        def counting_sample(data, cfg, rng=None):
            before = len(data["bboxes"])
            data = sample(data, cfg, rng=rng)
            pasted.append(len(data["bboxes"]) - before)
            return data

        model.augmentor.ObjectSample = counting_sample
        make_step = model.make_train_step

        def recording_make(tx, microbatch=None):
            step = make_step(tx, microbatch=microbatch)

            def run(batch):
                t = time.perf_counter()
                out = step(batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                num_pos.append(float(out["num_pos"]))
                return out
            return run

        model.make_train_step = recording_make
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        pipe.run_training()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counted.items()}
        if not all(launches.values()):
            raise AssertionError(f"data path run_training: a kernel did not "
                                 f"launch: {launches}")
        for k, vals in pipe.losses.items():
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"data path run_training: non-finite "
                                     f"{k}")
        half = len(pasted) // 2
        if len(pasted) != 4 or not (sum(pasted[:half]) > 0
                                    and sum(pasted[half:]) > 0):
            raise AssertionError(f"data path run_training: pasted objects "
                                 f"per augmented cloud {pasted}, not one a "
                                 f"epoch")
        if not num_pos or min(num_pos) <= 0:
            raise AssertionError(f"data path run_training: num_pos "
                                 f"{num_pos}")
        print(f"data path run_training (flagship, B=2 in chunks of 1, "
              f"epochs 0-1, ObjectSample sample_dict {{0: 16}} and "
              f"device_augment): {train_s:.2f} s wall; pasted objects per "
              f"augmented cloud {pasted}; num_pos per step {num_pos}; step "
              f"{', '.join(f'{v:.1f}' for v in step_ms)} ms; launches "
              f"{launches}", flush=True)
        del pipe, model
        return launches, prepared
    finally:
        shutil.rmtree(root, ignore_errors=True)


def in_window(scene, pcr, shift):
    """The rows of ``scene`` inside the model window at ``shift``, in the
    window's frame (the numpy filter of the host crop)."""
    sel = np.all((scene[:, :3] >= pcr[:3] + shift)
                 & (scene[:, :3] < pcr[3:] + shift), axis=1)
    rows = scene[sel].copy()
    rows[:, :3] -= shift
    return rows


def sorted_rows(a):
    """The rows of ``a`` rounded to 1e-4, lexicographically sorted."""
    a = np.round(a, 4)
    return a[np.lexsort(a.T[::-1])]


def matched_boxes(got, want):
    """(max abs box difference, count, whether they pair) of two tiles'
    valid detections, matched by nearest centre: they pair when the
    counts agree and the match is one to one with equal labels."""
    gv, wv = got["valid"][0], want["valid"][0]
    gb, wb = got["bbox"][0][gv].double(), want["bbox"][0][wv].double()
    if len(gb) != len(wb):
        return float("nan"), len(gb), False
    if not len(gb):
        return 0.0, 0, True
    j = torch.cdist(gb[:, :3], wb[:, :3]).argmin(dim=1)
    pair = len(set(j.tolist())) == len(j) and torch.equal(
        got["label"][0][gv], want["label"][0][wv][j])
    return float((gb - wb[j]).abs().max()), len(gb), pair


def tiled_phase():
    """Phase 15: tiled inference over the plot-scale scene.  Returns K1's
    and K2's launches per ``TiledInference`` call at ``batch_tiles`` 1
    and 2."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.grid_scatter import (
        scatter_to_grid,
    )
    from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
    from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
        SENTINEL,
        TiledInference,
    )
    from objectdetection_3d_tpu_torch.scene import card_line, large_tree_scene

    counted = {"postsort_scan": postsort_scan,
               "scatter_to_grid": scatter_to_grid}
    with np.load(NPZ) as z:
        score_thr = float(z["score_thr"])

    def trained(cfg):
        model = PointPillars(cfg, device="cuda")
        load_npz(model.net, NPZ)
        model.head_cfg["score_thr"] = score_thr
        return model

    scene = large_tree_scene()
    n_scene = len(scene)
    model = trained(configs.flagship_cfg())
    ti = TiledInference(model, overlap=5.0, batch_tiles=1)
    p = ti.max_pts
    pcr = np.asarray(model.point_cloud_range)
    lo, hi = scene[:, :3].min(axis=0), scene[:, :3].max(axis=0)
    tiles = [(x0, y0)
             for x0 in ti._tile_origins(lo[0], hi[0], ti.tile_x, 5.0)
             for y0 in ti._tile_origins(lo[1], hi[1], ti.tile_y, 5.0)]
    shifts = np.asarray([[x0, y0, lo[2]] for x0, y0 in tiles], np.float32)
    if len(tiles) != 25:
        raise AssertionError(f"{len(tiles)} tiles, not 25")

    # ---- tiles: in-window counts, numpy and the card -----------------
    want = [in_window(scene, pcr, sh) for sh in shifts]
    counts = [len(w) for w in want]
    scene_d = torch.as_tensor(scene, device="cuda")
    pcr_d = torch.as_tensor(pcr, device="cuda", dtype=torch.float32)
    card = [int(((scene_d[:, :3] >= pcr_d[:3] + sh)
                 & (scene_d[:, :3] < pcr_d[3:] + sh)).all(dim=1).sum())
            for sh in torch.as_tensor(shifts, device="cuda")]
    if card != counts:
        raise AssertionError(f"in-window counts: card {card}, numpy "
                             f"{counts}")
    over = [t for t, c in enumerate(counts) if c > p]
    print(f"tiled scene: {n_scene} points, {len(tiles)} tiles (5 x 5 at "
          f"5 m overlap); in-window per tile {counts} against P = {p} "
          f"(card == numpy); over the budget: tiles {over}", flush=True)
    if not over:
        raise AssertionError("no tile exceeds the point budget")

    # ---- crop: the card's against the host's --------------------------
    lo0 = float(lo[0])
    t0 = time.perf_counter()
    ss, key = ti._sort_scene_cols(scene_d, lo0)
    dev = ti._crop_cols(ss, key, torch.as_tensor(shifts, device="cuda"),
                        lo0, ti._compaction_draws(scene_d.device))
    torch.cuda.synchronize()
    crop_ms = (time.perf_counter() - t0) * 1e3
    del ss, key
    dev_np = dev.cpu().numpy()
    sorted_pts, starts, grid = ti._bucket_sort(scene, lo)
    host_buf = np.zeros((len(tiles), p, scene.shape[1]), np.float32)
    host_n = np.zeros((len(tiles),), np.int32)
    for t, (x0, y0) in enumerate(tiles):
        local = ti._crop_tile(sorted_pts, starts, grid, lo, pcr, x0, y0)
        host_buf[t, :len(local)] = local
        host_n[t] = len(local)
    pcr32 = pcr.astype(np.float32)
    n_sent = []
    for t in range(len(tiles)):
        rows = dev_np[t]
        inr = np.all((rows[:, :3] >= pcr32[:3]) & (rows[:, :3] < pcr32[3:]),
                     axis=1)
        n_sent.append(int((rows == SENTINEL).all(axis=1).sum()))
        if t in over:
            got = {tuple(r) for r in np.round(rows, 4)}
            if not (int(inr.sum()) == p == len(got) == host_n[t]
                    and got <= {tuple(r) for r in np.round(want[t], 4)}):
                raise AssertionError(f"tile {t}: the over-budget crop is "
                                     f"not {p} rows of its window")
        elif not (np.array_equal(sorted_rows(rows[inr]),
                                 sorted_rows(host_buf[t, :host_n[t]]))
                  and host_n[t] == counts[t]):
            raise AssertionError(f"tile {t}: the card's crop differs from "
                                 f"the host's")
    print(f"crop: the card's sort + 25 crops {crop_ms:.1f} ms (first "
          f"call); under-budget tiles == the host crop as multisets "
          f"(1e-4); the over-budget tile {p} rows of its window; sentinel "
          f"rows per tile {n_sent}", flush=True)

    # ---- voxelizer on both crops ---------------------------------------
    vl = model.voxel_layer
    full = torch.full((len(tiles),), p, dtype=torch.int32, device="cuda")
    vd = vl.points_batch(dev, full)
    vh = vl.points_batch(torch.as_tensor(host_buf, device="cuda"),
                         torch.as_tensor(host_n, device="cuda"))
    for t in range(len(tiles)):
        if t in over:
            continue
        for k in ("coords", "num_points_per_voxel", "num_voxels"):
            if not torch.equal(vd[k][t], vh[k][t]):
                raise AssertionError(f"tile {t}: voxel {k} differ between "
                                     f"the crops")
    sent = (vd["points"] == SENTINEL).all(dim=-1)
    if int(sent.sum()) != sum(n_sent) or bool(vd["pt_valid"][sent].any()):
        raise AssertionError("a sentinel row reached a voxel")
    print(f"voxelizer: under-budget tiles' voxels (coords, counts) equal "
          f"between the crops; {sum(n_sent)} sentinel rows add no voxel; "
          f"voxels per tile {vd['num_voxels'].tolist()}", flush=True)
    del vd, vh

    # ---- float32 detections: the card's crop against the host's --------
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = trained(configs.flagship_cfg({"compute_dtype": "float32"}))
    worst, n_det = 0.0, 0
    # C8: tile 3's device crop predicted twice gives the same bits
    twice = [model32.predict({"points": dev[3:4], "num_points": full[:1]})
             for _ in range(2)]
    if not all(torch.equal(twice[0][k], twice[1][k]) for k in twice[0]):
        raise AssertionError("C8: two float32 predicts of tile 3 differ")
    print(f"float32 run to run, tile 3 twice: bitwise equal "
          f"({int(twice[0]['valid'].sum())} detections)", flush=True)
    for t in range(len(tiles)):
        if t in over:
            continue
        err, n, pair = matched_boxes(
            model32.predict({"points": dev[t:t + 1],
                             "num_points": full[:1]}),
            model32.predict({"points": host_buf[t:t + 1],
                             "num_points": host_n[t:t + 1]}))
        if not (pair and err <= 1e-3):
            raise AssertionError(f"tile {t}: float32 detections of the "
                                 f"crops differ (paired {pair}, boxes "
                                 f"{err})")
        worst, n_det = max(worst, err), n_det + n
    # the merged output is in the scene's frame: each merged box is one of
    # its tile's boxes shifted by the tile's origin.  (The npz weights
    # regress some centres out of their own window, so "inside the
    # scene's bounds" is counted, not required.)
    merged = {}
    for device_crop in (True, False):
        local = []
        own = model32.make_predict_fn()

        def recording(batch, own=own, local=local):
            out = own(batch)
            local.append({k: v.cpu() for k, v in out.items()})
            return out

        dets = TiledInference(model32, overlap=5.0, predict_fn=recording,
                              device_crop=device_crop)(scene)
        shifted = set()
        for (x0, y0), out in zip(tiles, local):
            b = out["bbox"][0][out["valid"][0]].numpy().copy()
            b[:, 0] += x0
            b[:, 1] += y0
            b[:, 2] += lo[2]
            shifted.update(map(tuple, b))
        if not dets or any(tuple(d["bbox"]) not in shifted for d in dets):
            raise AssertionError(f"float32 merged detections (device_crop "
                                 f"{device_crop}) are not tile detections "
                                 f"in the scene's frame")
        xy = np.stack([d["bbox"][:2] for d in dets])
        inside = np.all((xy >= lo[:2]) & (xy <= hi[:2]), axis=1)
        merged[device_crop] = (len(dets), int(inside.sum()))
    print(f"float32 (TF32 off): {n_det} detections on the "
          f"{len(tiles) - len(over)} under-budget tiles, card crop == "
          f"host crop (counts and labels exact, boxes within {worst:.3g}); "
          f"merged scene detections (in the scene's frame, of them inside "
          f"its xy bounds): device crop {merged[True]}, host crop "
          f"{merged[False]}", flush=True)
    del model32, dev, host_buf
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.empty_cache()

    # ---- bf16: timing, merge, launch counts ---------------------------
    def instrument(tiled):
        """Record each merge's candidates, kept boxes, wall time and
        peak memory on the instance."""
        log = []
        merge_host = tiled._merge_host

        def run(boxes, scores, labels):
            torch.cuda.synchronize()
            before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = merge_host(boxes, scores, labels)
            torch.cuda.synchronize()
            log.append({"candidates": sum(len(b) for b in boxes),
                        "kept": len(out),
                        "ms": (time.perf_counter() - t) * 1e3,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30, "before_gib": before / 2 ** 30})
            return out
        tiled._merge_host = run
        return log

    def timed(tiled, reps):
        log = instrument(tiled)
        walls, launches = [], []
        for _ in range(reps):
            for fn in counted.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            dets = tiled(scene)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            launches.append({k: fn.launches for k, fn in counted.items()})
        peak = max(max(e["peak_gib"], e["before_gib"]) for e in log)
        return walls, launches, dets, log, peak

    ti(scene)                               # warm-up
    torch.cuda.synchronize()
    runs = {"device crop, batch_tiles=1": (ti, 3),
            "host crop, batch_tiles=1": (TiledInference(
                model, overlap=5.0, device_crop=False), 1),
            "device crop, batch_tiles=2": (TiledInference(
                model, overlap=5.0, batch_tiles=2), 1)}
    result = {}
    for label, (tiled, reps) in runs.items():
        walls, launches, dets, log, peak = timed(tiled, reps)
        chunks = -(-len(tiles) // tiled.batch_tiles)
        for count in launches:
            if count != {k: chunks for k in counted}:
                raise AssertionError(f"{label}: launches {count}, not "
                                     f"{chunks} per kernel")
        if not dets:
            raise AssertionError(f"{label}: no detection")
        m = log[-1]
        print(f"tiled {label}: " + ", ".join(
            f"{w:.3f}" for w in walls) + f" s/scene ("
            f"{n_scene / np.median(walls) / 1e6:.2f} Mpts/s at the median), "
            f"{len(dets)} detections; merge {m['candidates']} candidates "
            f"-> {m['kept']} kept in {m['ms']:.1f} ms (peak "
            f"{m['peak_gib']:.2f} GiB in the merge); call peak {peak:.2f} "
            f"GiB; K1/K2 launches per call {launches[0]} ({chunks} chunks)",
            flush=True)
        result[tiled.batch_tiles] = launches[0]
    print(f"tiled card: {card_line()}", flush=True)
    return result


def importer_phase(batch):
    """Phase 16: a seeded synthetic reference state dict at the flagship
    widths, saved in the reference's checkpoint envelope and loaded with
    ``load_reference_pth`` into a card model; every array written, and
    one predict finite."""
    import tempfile

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.torch_import import (
        load_reference_pth,
    )
    from objectdetection_3d_tpu_torch.scene import reference_state_dict

    model = PointPillars(configs.flagship_cfg(), device="cuda")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    sd = reference_state_dict(model.net, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO,
                                                      "build")) as root:
        path = os.path.join(root, "reference.pth")
        torch.save({"epoch": 0, "model_state_dict": {
            k: torch.from_numpy(v) for k, v in sd.items()},
            "optimizer_state_dict": {}}, path)
        t = time.perf_counter()
        load_reference_pth(model.net, path)
        load_s = time.perf_counter() - t
    after = model.net.state_dict()
    same = [k for k in before if torch.equal(before[k], after[k])]
    if set(after) != set(before) or same:
        raise AssertionError(f"the import left {same} at their init values")
    out = model.predict(batch)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(out[k]).all()) for k in ("bbox",
                                                            "score")):
        raise AssertionError("predict after the import is not finite")
    print(f"importer: {len(sd)} reference arrays -> all {len(after)} "
          f"parameters and running statistics of the flagship net written "
          f"({load_s:.2f} s from a .pth envelope); predict on cloud 0 "
          f"finite, {int(out['valid'].sum())} valid detections", flush=True)


def _old_topk_rows(key, k):
    """The top-k that ``models/assign.py`` ran before its packed key: the
    k-th value, the ties below it by a cumsum, read back with
    ``nonzero`` (a host sync)."""
    kth = torch.topk(key, k, dim=1).values[:, -1:]
    above = key > kth
    ties = key == kth
    room = k - above.sum(dim=1, keepdim=True)
    take = above | (ties & (torch.cumsum(ties, dim=1, dtype=torch.int32)
                            <= room))
    return take.nonzero()[:, 1].reshape(key.shape[0], k)


def topk_gate(model, batch):
    """Phase 18's top-k gate: the packed top-k against the former cumsum
    + ``nonzero`` version on cloud 0's 1.92 M head logits (k = nms_pre)
    and on the step's (16, N) prefilter keys (k = K, all 8 GT chunks of
    cloud 0's assignment); equal index sets (and, for predict's, the same
    order), both timed."""
    from objectdetection_3d_tpu_torch.models import assign
    from objectdetection_3d_tpu_torch.models.detector import (
        topk_lowest_index,
    )

    cls, _, _ = model.apply(batch)
    row = cls[0].reshape(-1, max(model.num_classes, 1)).amax(dim=-1)
    k = int(model.head_cfg.get("nms_pre", 100))

    def old_ordered():
        idx = _old_topk_rows(row[None], k)[0]
        return idx[torch.sort(row[idx], descending=True, stable=True).indices]

    if not torch.equal(topk_lowest_index(row, k), old_ordered()):
        raise AssertionError("the packed top-k of predict's logits differs "
                             "from the cumsum version")
    out = {"predict": {
        "n": row.numel(), "k": k,
        "distinct": int(torch.unique(row).numel()),
        "ms": cuda_ms(lambda: topk_lowest_index(row, k), 20),
        "old_ms": cuda_ms(old_ordered, 20)}}
    keys = []
    packed = assign.topk_rows_lowest_index

    def recording(key, kk):
        keys.append((key.clone(), kk))
        return packed(key, kk)

    assign.topk_rows_lowest_index = recording
    try:
        model.assign(batch)
    finally:
        assign.topk_rows_lowest_index = packed
    for key, kk in keys:
        if not torch.equal(packed(key, kk), _old_topk_rows(key, kk)):
            raise AssertionError(f"the packed top-k of a {tuple(key.shape)} "
                                 f"prefilter key differs from the cumsum "
                                 f"version")
    key, kk = keys[0]
    out["prefilter"] = {
        "shape": list(key.shape), "k": kk, "chunks": len(keys),
        "ms": cuda_ms(lambda: packed(key, kk), 20),
        "old_ms": cuda_ms(lambda: _old_topk_rows(key, kk), 20)}
    for name, r in out.items():
        print(f"top-k {name} {r.get('shape', r.get('n'))} k={r['k']}: packed "
              f"== cumsum + nonzero ({r.get('chunks', 1)} inputs); "
              f"{r['ms']:.4f} ms vs {r['old_ms']:.4f} ms", flush=True)
    return out


_SERVE_SCRIPT = """
import json, sys
import torch
from objectdetection_3d_tpu_torch.serving import load_serving
from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid
from objectdetection_3d_tpu_torch.ops.fused_stage import fused_stage
from objectdetection_3d_tpu_torch.ops.masked_norm import masked_affine_relu
from objectdetection_3d_tpu_torch.ops.pallas_conv import subm_conv3d
from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3
counted = (postsort_scan, scatter_to_grid, fused_stage, subm_conv3d,
           conv2d_3x3, masked_affine_relu)
inputs = torch.load(sys.argv[1])
report = {}
for path in sys.argv[2:]:
    serve, manifest = load_serving(path)
    for fn in counted:
        fn.launches = 0
    outs = [serve(b) for b in inputs]
    torch.cuda.synchronize()
    torch.save([{k: v.cpu() for k, v in o.items()} for o in outs],
               path + "/served.pt")
    report[path] = {fn.__name__: fn.launches for fn in counted}
mods = [m for m in sys.modules if m.startswith((
    "objectdetection_3d_tpu_torch.models", "objectdetection_3d_tpu_torch.config",
    "objectdetection_3d_tpu_torch.pipeline", "jax", "objectdetection_3d_tpu."))]
print(json.dumps({"launches": report, "model_modules": mods}))
"""

SERVING_KNOBS = (
    ("default", {}, {"masked_affine_relu": 10}),
    ("fused_stages", {"fused_stages": True},
     {"fused_stage": 3, "masked_affine_relu": 4}),
    ("pallas_subm_conv+zfold_pallas",
     {"pallas_subm_conv": True, "zfold_pallas": True},
     {"subm_conv3d": 2, "conv2d_3x3": 1, "masked_affine_relu": 10}))


def _same_detections(label, got, want):
    """Bitwise equal, or boxes and scores within 1e-6 with labels and
    ``valid`` exact; returns the largest difference."""
    err = max(max_abs_err(got[k].float(), want[k].float())
              for k in ("bbox", "score"))
    if not (torch.equal(got["label"], want["label"])
            and torch.equal(got["valid"], want["valid"]) and err <= 1e-6):
        raise AssertionError(f"{label}: the artifact differs from the live "
                             f"predict (boxes/scores {err})")
    return err


def serving_phase(batches):
    """Phase 18: predict exported, reloaded and served.  Returns the
    kernels' launches through the three artifacts and the phase's
    readings."""
    import shutil
    import subprocess
    import tempfile

    from objectdetection_3d_tpu_torch import configs, serving
    from objectdetection_3d_tpu_torch.profile_predict import host_syncs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.fused_stage import fused_stage
    from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid
    from objectdetection_3d_tpu_torch.ops.masked_norm import (
        masked_affine_relu,
    )
    from objectdetection_3d_tpu_torch.ops.pallas_conv import subm_conv3d
    from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
    from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3

    counted = (postsort_scan, scatter_to_grid, fused_stage, subm_conv3d,
               conv2d_3x3, masked_affine_relu)
    report = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="serving_", dir=os.path.join(REPO,
                                                                 "build"))
    launches = {fn.__name__: 0 for fn in counted}
    try:
        inputs = [{k: torch.as_tensor(b[k], device="cuda")
                   for k in ("points", "num_points")} for b in batches]
        torch.save(inputs, os.path.join(root, "inputs.pt"))
        cells = {}
        for name, tpu, per_cloud in SERVING_KNOBS:
            knob_model = PointPillars(configs.flagship_cfg(tpu),
                                      device="cuda")
            load_npz(knob_model.net, NPZ)
            if not tpu:
                report["topk"] = topk_gate(knob_model, batches[0])
            t = time.perf_counter()
            program, manifest = serving.export_predict(knob_model)
            export_s = time.perf_counter() - t
            path = os.path.join(root, name.replace("+", "_"))
            serving.save_exported(program, manifest, path)
            del program
            nbytes = os.path.getsize(os.path.join(path, "model.pt2"))
            cells[name] = {"model": knob_model, "path": path,
                           "per_cloud": per_cloud, "export_s": export_s,
                           "artifact_bytes": nbytes}
            print(f"serving {name}: export {export_s:.2f} s, model.pt2 "
                  f"{nbytes} bytes", flush=True)
        # a fresh process that only loads and calls the artifacts
        paths = [c["path"] for c in cells.values()]
        run = subprocess.run(
            [sys.executable, "-c", _SERVE_SCRIPT,
             os.path.join(root, "inputs.pt"), *paths], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"the serving process failed:\n"
                                 f"{run.stderr[-4000:]}")
        child = json.loads(run.stdout.strip().splitlines()[-1])
        if child["model_modules"]:
            raise AssertionError(f"the serving process imported "
                                 f"{child['model_modules']}")
        for name, cell in cells.items():
            model_k, path = cell["model"], cell["path"]
            live = model_k.make_predict_fn()
            serve, _ = serving.load_serving(path)
            want = {"postsort_scan": 1, "scatter_to_grid": 1,
                    **cell["per_cloud"]}
            want = {k: want.get(k, 0) * len(batches) for k in launches}
            if child["launches"][path] != want:
                raise AssertionError(f"serving {name} in its own process: "
                                     f"launches {child['launches'][path]}, "
                                     f"expected {want}")
            lives = [live(b) for b in batches]
            served_child = torch.load(os.path.join(path, "served.pt"))
            serve(inputs[0])                    # warm-up
            torch.cuda.synchronize()
            for fn in counted:
                fn.launches = 0
            served = [serve(b) for b in inputs]
            torch.cuda.synchronize()
            got = {fn.__name__: fn.launches for fn in counted}
            if got != want:
                raise AssertionError(f"serving {name}: launches {got}, "
                                     f"expected {want}")
            for k, v in got.items():
                launches[k] += v
            bitwise, err = True, 0.0
            for i, (s, c, w) in enumerate(zip(served, served_child, lives)):
                for out in (s, {k: v.to("cuda") for k, v in c.items()}):
                    err = max(err, _same_detections(
                        f"serving {name} cloud {i}", out, w))
                    bitwise &= all(torch.equal(out[k], w[k]) for k in w)
            # served and live ms per cloud, in turns after the warm-ups
            served_ms, live_ms = [], []
            for b, x in zip(batches, inputs):
                for fn, times in ((lambda: serve(x), served_ms),
                                  (lambda: live(b), live_ms)):
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
            _, syncs_served = host_syncs(lambda: serve(inputs[0]))
            _, syncs_live = host_syncs(lambda: live(batches[0]))
            cell.update(bitwise=bitwise, max_abs_err=err,
                        served_ms=served_ms, live_ms=live_ms,
                        served_median_ms=float(np.median(served_ms)),
                        live_median_ms=float(np.median(live_ms)),
                        syncs_served=syncs_served, syncs_live=syncs_live,
                        launches=got)
            print(f"serving {name}: clouds 0-{len(batches) - 1} "
                  f"{'bitwise equal' if bitwise else 'within 1e-6'} to the "
                  f"live predict in this and a fresh process (max abs err "
                  f"{err:.3g}); launches {got}; served "
                  f"{cell['served_median_ms']:.1f} ms vs live "
                  f"{cell['live_median_ms']:.1f} ms per cloud (median of "
                  f"{len(served_ms)}); host syncs per call served "
                  f"{syncs_served}, live {syncs_live}", flush=True)
            del cell["model"], model_k, live, serve, served, lives
            torch.cuda.empty_cache()
        report["cells"] = {name: {k: v for k, v in c.items() if k != "path"}
                           for name, c in cells.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, report


def native_phase(prepared):
    """Phase 19a: the host C++ passes against the numpy paths."""
    from objectdetection_3d_tpu_torch import configs, native
    from objectdetection_3d_tpu_torch.models import preprocess_tools as pre
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.scene import tree_scene

    cloud, cfg = prepared["cloud"], prepared["cfg"]
    fc = cfg["featurizer"]
    build_s = prepared["native_build_s"]
    xyz = cloud[:, :3].astype(np.float64)
    t = time.perf_counter()
    normals, fpfh = native.featurize_cloud(
        xyz, fc["normal_rad"], fc["normal_max_nn"], fc["fpfh_rad"],
        fc["fpfh_max_nn"])
    nat_s = time.perf_counter() - t
    ref = prepared["feats"]
    ref_n, ref_f = ref[:, -36:-33], ref[:, -33:]
    # the CPU tests' gates: normals up to sign on >= 4-point
    # neighbourhoods, FPFH from shared normals
    _, valid = pre._knn_radius(xyz, fc["normal_rad"], fc["normal_max_nn"])
    ok = valid.sum(axis=1) >= 4
    dots = np.abs(np.einsum("nk,nk->n", ref_n, normals))[ok]
    share = float((dots > 0.999).mean())
    if share < 0.98:
        raise AssertionError(f"native normals: |dot| > 0.999 on {share:.4f} "
                             f"of the >= 4-point neighbourhoods, not 0.98")
    t = time.perf_counter()
    _, fpfh_shared = native.featurize_cloud(
        xyz, fc["normal_rad"], fc["normal_max_nn"], fc["fpfh_rad"],
        fc["fpfh_max_nn"], normals=ref_n)
    shared_s = time.perf_counter() - t
    # a histogram bin is discontinuous at its edges: where a pair's angle
    # lies within 1e-9 of one (theta at +-pi for antiparallel normals of
    # a 3-point neighbourhood), the two summation orders may bin it
    # apart, and every FPFH row that reads that SPFH moves by up to
    # 100 / distance
    edge = bin_edge_rows(xyz, ref_n, fc["fpfh_rad"], fc["fpfh_max_nn"])
    differ = ~np.isclose(fpfh_shared, ref_f, rtol=2e-4, atol=2e-3)
    if (differ.any(axis=1) & ~edge).any():
        raise AssertionError(
            f"native FPFH from shared normals: "
            f"{int((differ.any(axis=1) & ~edge).sum())} rows off a bin "
            f"edge differ from numpy beyond rtol 2e-4 / atol 2e-3")
    # on the rows near an edge, only mass moved between theta's first and
    # last bin (the two sides of its +-pi cut), their sum kept
    cut = [2 * 11, 3 * 11 - 1]
    if differ[edge][:, np.delete(np.arange(33), cut)].any():
        raise AssertionError("native FPFH from shared normals: a row near "
                             "a bin edge differs outside theta's first "
                             "and last bin")
    if not np.allclose(fpfh_shared[edge][:, cut].sum(axis=1),
                       ref_f[edge][:, cut].sum(axis=1), rtol=2e-4,
                       atol=2e-3):
        raise AssertionError("native FPFH from shared normals: theta's "
                             "first and last bin do not sum to numpy's")
    differ = int(differ.any(axis=1).sum())
    prep_s = prepared["prepare_native_s"]
    print(f"phase 19a native: loading both libraries before phase 17's "
          f"timed prepare_cloud (g++ of what was not built yet) "
          f"{build_s:.2f} s; featurize_cloud "
          f"({len(cloud)} points) native {nat_s:.3f} s against numpy "
          f"{prepared['feat_s']:.3f} s (x{prepared['feat_s'] / nat_s:.1f}); "
          f"normals |dot| > 0.999 on {share:.4f} of {int(ok.sum())} "
          f">= 4-point neighbourhoods; FPFH from shared normals within "
          f"rtol 2e-4 / atol 2e-3 ({shared_s:.3f} s) on all but the "
          f"{int(edge.sum())} rows that read a pair within 1e-9 of a bin "
          f"edge ({differ} rows differ, all among them, and there only "
          f"by mass moved across theta's +-pi cut); prepare_cloud "
          f"(phase 17, the MLP filter on the card) numpy "
          f"{prepared['prepare_s']:.3f} s -> default (native) "
          f"{prep_s:.3f} s; points kept {prepared['prepare_points']}",
          flush=True)

    model = PointPillars(configs.flagship_cfg(), device="cuda")
    raw = np.concatenate([tree_scene(1)[0], tree_scene(2)[0]])
    raw[:50, :3] += 400.0                         # far outliers
    got = model._preprocess_points(raw)
    want = model._preprocess_points_numpy(raw)
    if got.shape != want.shape or not np.allclose(got, want, atol=1e-5):
        raise AssertionError("native preprocess_cloud differs from the "
                             "numpy pass")
    nat_ms = min(_wall_ms(lambda: model._preprocess_points(raw))
                 for _ in range(5))
    np_ms = min(_wall_ms(lambda: model._preprocess_points_numpy(raw))
                for _ in range(5))
    print(f"phase 19a preprocess_cloud ({len(raw)} raw points -> "
          f"{len(got)}): native {nat_ms:.2f} ms against numpy "
          f"{np_ms:.2f} ms (best of 5), equal", flush=True)
    return {"featurize_native_s": nat_s,
            "featurize_numpy_s": prepared["feat_s"],
            "prepare_numpy_s": prepared["prepare_s"],
            "prepare_native_s": prep_s, "preprocess_native_ms": nat_ms,
            "preprocess_numpy_ms": np_ms}


def bin_edge_rows(xyz, normals, radius, max_nn, tol=1e-9):
    """The rows of an FPFH whose histograms read a point pair with a
    Darboux angle within ``tol`` of one of its 11 bins' edges: the row's
    own SPFH or one of its neighbours'."""
    from objectdetection_3d_tpu_torch.models import preprocess_tools as pre

    idx, valid = pre._knn_radius(xyz, radius, max_nn)
    pairs = valid.copy()
    pairs[:, 0] = False                           # the point itself
    alpha, phi, theta = pre._darboux(xyz[:, None], normals[:, None],
                                     xyz[idx], normals[idx])
    near = np.zeros_like(pairs)
    for feat, lim in ((alpha, 1.0), (phi, 1.0), (theta, np.pi)):
        edges = np.linspace(-lim, lim, 12)
        near |= np.abs(feat[..., None] - edges).min(axis=-1) < tol
    own = (near & pairs).any(axis=1)
    return own | np.where(valid, own[idx], False).any(axis=1)


def _wall_ms(fn):
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def _rank_cases():
    """``tests/rank_cases.py``: the ranks' runs and the checks that the
    CPU tests share (its directory goes on ``sys.path``, which ``spawn``
    hands on to the ranks)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import rank_cases
    return rank_cases


def leaf_grad_share(ranks, want):
    """The largest |gradient difference| of any rank and leaf, as a share
    of 1e-4 of that leaf's largest one-device gradient element."""
    share = 0.0
    for got in ranks:
        for k, g in want["grads"].items():
            tol = 1e-4 * float(g.abs().max())
            d = float((got["grads"][k] - g).abs().max())
            share = max(share, d / tol if tol > 0 else (d > 0) * np.inf)
    return share


# ROADMAP C16's gate on the dense backbone's float32 spatial step
# (c16_gates): each leaf's largest error against the float64 instrument's
# whole step at most C16_C times the one-device float32 step's own
# largest error on that leaf, plus C16_F times the leaf's largest float64
# element.  The constants were fixed from CPU readings at 25.6 m, where
# the largest ratio of the two errors was 3.03 (2.10 at 12.8 m) with
# C16_F's term taken off; the card then showed that one sample of the
# one-device error can miss a kink that rounding flips, and the reference
# became the larger of two samples (PERF.md §6)
C16_C = 5.0
C16_F = 1e-6
# the float64 instrument's smaller window, m: the CPU readings' window
C16_WINDOW = 25.6
# the largest peak, as a share of the card's memory, of the float64 whole
# step that its split (two ranks on the card) is run after
C16_SPLIT_SHARE = 0.4


def c16_windows(rr, fp32, full_batch):
    """Phase 19c's dense-backbone windows: {extent m: (cfg, state, batch)}
    at the flagship's full extent (cloud 1) and at ``C16_WINDOW`` m
    (``scene.tree_scene(1, extent=25.6, n_trees=5, n_points=40_960)``,
    budgets 65,536), each with the npz's PFN and encoder and the seeded
    backbone, neck and head."""
    from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene

    full = rr.dense_backbone_cfg(fp32)
    small = rr.window_cfg(full, C16_WINDOW, 65_536)
    return {40.0: (full, rr.dense_backbone_state(full, NPZ, "cuda"),
                   full_batch),
            C16_WINDOW: (small, rr.dense_backbone_state(small, NPZ, "cuda"),
                         make_batch(tree_scene(1, extent=C16_WINDOW,
                                               n_trees=5, n_points=40_960),
                                    65_536))}


def c16_phase(rr, base, windows, whole32, split32):
    """Phase 19c's ROADMAP C16 gates on the dense backbone's spatial 1 x 2
    step (``base``: the case's device, optimizer and clip; ``windows``:
    :func:`c16_windows`; ``whole32``, ``split32``: the float32 step at the
    full extent, whole and each rank's).  At each window it runs the
    float64 instrument's whole step (none where it does not fit), the
    float32 whole step from every parameter moved by one float32 ulp, and
    at the smaller window the float32 whole step; then two ranks on this
    card over gloo: the float32 split at the smaller window and the
    float64 split at each window whose whole step's peak leaves the ranks
    room (``C16_SPLIT_SHARE``).  Holds each window by :func:`c16_gates`
    after printing every leaf's share; returns the readings."""
    import tempfile

    from objectdetection_3d_tpu_torch.parallel import spawn

    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {ext: {} for ext in windows}
    runs[40.0].update(whole32=whole32, split32=split32)
    split_cases, memory = {}, {}
    total_bytes = torch.cuda.get_device_properties(0).total_memory
    for ext, (cfg, state, batch) in windows.items():
        case = dict(base, kind="train", cfg=cfg, state=state, batch=batch,
                    exact_fp32=True, spatial=True, mesh=(1, 2))
        if ext != 40.0:
            runs[ext]["whole32"] = rr.train(case)
            split_cases[(ext, "split32")] = case
        gen = torch.Generator().manual_seed(1)
        wiggled = {k: v * (1 + 2.0 ** -23 * torch.sign(
                       torch.rand(v.shape, generator=gen) - 0.5))
                   if v.is_floating_point() else v
                   for k, v in state["net"].items()}
        runs[ext]["whole32_ulp"] = rr.train(
            dict(case, state=dict(state, net=wiggled)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            runs[ext]["whole64"] = rr.train(dict(case, float64=True))
        except torch.cuda.OutOfMemoryError:
            runs[ext]["whole64"] = None
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        # two ranks share the card: each holds about half the slab's
        # activations, and the point and anchor work whole; a rank that
        # ran out of memory would leave the other in a collective until
        # its timeout, so the split is run only with room to spare
        fits = (runs[ext]["whole64"] is not None
                and peak <= C16_SPLIT_SHARE * total_bytes)
        if fits:
            split_cases[(ext, "split64")] = dict(case, float64=True)
        memory[ext] = {
            "whole64_peak_gib": (peak / 2 ** 30 if runs[ext]["whole64"]
                                 else "does not fit"),
            "whole64_ms": (runs[ext]["whole64"] or {}).get("ms"),
            "split64": "runs" if fits else "does not fit"}
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old_tf32
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(
            prefix="spawn_", dir=os.path.join(REPO, "build")) as init_dir:
        ranks = spawn(rr.run_cases, 2, init_dir,
                      args=(list(split_cases.values()),))
    spawn_s = time.perf_counter() - t
    for i, (ext, kind) in enumerate(split_cases):
        runs[ext][kind] = [r[i] for r in ranks]
    report = {"c": C16_C, "f": C16_F, "memory": memory, "spawn_s": spawn_s,
              "windows": {}}
    held = []
    for ext, got in runs.items():
        # one ulp of every parameter moves the one-device float32
        # gradients by this share of 1e-4 of a leaf's largest
        ulp_share = leaf_grad_share([got["whole32_ulp"]], got["whole32"])
        if got["whole64"] is None:
            # the float32 split keeps check_step's other gates; its
            # gradients are held at the windows where float64 fits
            held.append((got["split32"], got["whole32"], {
                k: np.inf for k in got["whole32"]["grads"]}))
            report["windows"][ext] = {"one_ulp_grad_share": ulp_share}
            print(f"phase 19c C16 {ext} m: the float64 whole step does not "
                  f"fit; one ulp of every parameter moves the float32 "
                  f"gradients by {ulp_share:.4g} x 1e-4 of a leaf's largest",
                  flush=True)
            continue
        tols, errors = c16_gates(rr, got)
        shares = {key: {k: e / tols[key][k] if tols[key][k] > 0
                        else (e > 0) * np.inf for k, e in errors[key].items()}
                  for key in tols}
        for key, d in shares.items():
            print(f"phase 19c C16 {ext} m {key} shares: " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in d.items()}), flush=True)
        # the leaves where the split's float32 error is largest against
        # the one-device step's own, each error over the leaf's largest
        e = errors
        top = sorted(e["split32"], key=lambda k: -e["split32"][k] / max(
            e["whole32"][k], 1e-300))[:3]
        max64 = {k: float(g.abs().max())
                 for k, g in got["whole64"]["grads"].items()}
        row = {"one_ulp_grad_share": ulp_share,
               "largest_share": {key: [max(d.values()), max(d, key=d.get)]
                                 for key, d in shares.items()},
               "errors_where_split32_is_worst": {
                   k: {n: e[n][k] / max64[k] for n in
                       ("whole32", "whole32_ulp", "split32")} for k in top},
               "split_ms": {k: [r["ms"] for r in got[k]]
                            for k in ("split32", "split64") if k in got},
               "whole_ms": {k: got[k]["ms"]
                            for k in ("whole32", "whole32_ulp", "whole64")}}
        report["windows"][ext] = row
        print(f"phase 19c C16 dense backbone at {ext} m (float32 TF32 off, "
              f"and the float64 instrument; {memory[ext]}): {row} "
              f"(split64: the share of 1e-6 of each leaf's largest; "
              f"split32: of {C16_C} x the larger float32 one-device error "
              f"+ {C16_F} x the leaf's largest)", flush=True)
        for key, tol in tols.items():
            held.append((got[key], got["whole64"], tol))
    for ranks_, want, tol in held:
        rr.check_step(ranks_, want, OPT["lr"], grad_tol=tol)
    return report


def c16_gates(rr, runs):
    """ROADMAP C16's gradient tolerances for one window's dense-backbone
    steps (``runs``: ``whole32``, ``whole32_ulp``, ``split32`` (the
    ranks' results), ``whole64`` and, where it ran, ``split64``), with
    each step's per-leaf errors against the float64 instrument's whole
    step: the float64 split within 1e-6 of each leaf's largest element;
    the float32 split within ``C16_C`` times the larger of the two
    one-device float32 steps' errors on that leaf (the step, and the step
    from every parameter one ulp away: rounding flips a ReLU or a max
    somewhere, and a leaf's gradient jumps) plus ``C16_F`` times the
    leaf's largest float64 element.  Returns ({run: {leaf: tolerance}},
    {run: {leaf: error}})."""
    w64 = runs["whole64"]
    errors = {k: rr.leaf_errors(runs[k] if isinstance(runs[k], list)
                                else [runs[k]], w64)
              for k in ("whole32", "whole32_ulp", "split32", "split64")
              if k in runs}
    tols = {"split32": {
        k: C16_C * max(errors["whole32"][k], errors["whole32_ulp"][k])
        + C16_F * float(g.abs().max()) for k, g in w64["grads"].items()}}
    if "split64" in runs:
        tols["split64"] = rr.leaf_tol(w64, 1e-6)
    return tols, errors


def parallel_phase(prepared):
    """Phase 19: the native host passes (a); the sharded paths at world 1
    over nccl in this process (b) and at world 2 on this card over gloo
    (c).  Returns each kernel's launches in (b)'s sharded runs and the
    readings."""
    import tempfile

    import torch.distributed as dist

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.parallel import make_mesh, spawn
    rr = _rank_cases()
    from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene

    report = {"native": native_phase(prepared)}

    def state_of(cfg):
        model = PointPillars(cfg, device="cuda")
        load_npz(model.net, NPZ)
        state = rr.model_state(model)
        del model
        return state

    p_max = configs.flagship_cfg()["tpu"]["max_points_static"]
    items = [make_batch(tree_scene(seed), p_max) for seed in (1, 2)]
    batch2 = {k: np.concatenate([it[k] for it in items]) for k in items[0]}
    # (c)'s bf16 data-parallel step on three global batches of two clouds
    dp_clouds = ((1, 2), (3, 4), (5, 6))
    bf16 = configs.flagship_cfg()
    fp32 = configs.flagship_cfg({"compute_dtype": "float32"})
    base = dict(device="cuda", opt=dict(OPT), clip=CLIP)
    step2 = dict(base, kind="train", cfg=bf16, state=state_of(bf16),
                 batch=batch2, mesh=(1, 1))
    pred2 = dict(step2, kind="predict", fn="predict")
    knob_preds = [dict(pred2, cfg=configs.flagship_cfg(knobs),
                       batch=items[0])
                  for knobs in ({"fused_stages": True},
                                {"pallas_subm_conv": True,
                                 "zfold_pallas": True})]

    # ---- (b) world 1 over nccl, in this process -----------------------
    t0 = time.perf_counter()
    want_step = rr.train(step2)
    want_pred = rr.predict(pred2)
    want_knobs = [rr.predict(c) for c in knob_preds]
    torch.cuda.empty_cache()
    mesh = make_mesh(1, device="cuda")     # one rank a card: nccl
    if dist.get_backend() != "nccl":
        raise AssertionError(f"world 1 on the card joined over "
                             f"{dist.get_backend()}, not nccl")
    got_step = rr.train(step2, mesh)
    got_pred = rr.predict(pred2, mesh)
    got_knobs = [rr.predict(c, mesh) for c in knob_preds]
    # each run's counts are set to 0 just before it and read just after
    launches = {name: sum(r["launches"][name] for r in
                          (got_step, got_pred, *got_knobs))
                for name in got_step["launches"]}
    dist.destroy_process_group()
    worst = rr.check_step([got_step], want_step, OPT["lr"])
    preds = [rr.check_preds(g["preds"], w["preds"]) for g, w in
             zip([got_pred, *got_knobs], [want_pred, *want_knobs])]
    bitwise = [all(torch.equal(g["preds"][k], w["preds"][k])
                   for k in w["preds"]) for g, w in
               zip([got_pred, *got_knobs], [want_pred, *want_knobs])]
    step_kernels = ("postsort_scan", "scatter_to_grid", "chunk_geometry",
                    "containment_rescue", "iou_gathered", "iou_gathered_pair")
    if not all(got_step["launches"][k] for k in step_kernels):
        raise AssertionError(f"world 1 sharded step: a kernel did not "
                             f"launch: {got_step['launches']}")
    if not (got_knobs[0]["launches"]["fused_stage"]
            and got_knobs[1]["launches"]["subm_conv3d"]
            and got_knobs[1]["launches"]["conv2d_3x3"]):
        raise AssertionError("world 1 sharded predict under the knobs: "
                             "K8-K10 did not launch")
    print(f"phase 19b world 1 over nccl (flagship bf16, global batch 2 = "
          f"clouds 1-2): sharded step {got_step['ms']:.1f} ms against one "
          f"device's {want_step['ms']:.1f} ms (each the first step of its "
          f"model): largest loss {worst['loss']:.3g}, gradient "
          f"{worst['grad']:.3g}, parameter {worst['param']:.3g} "
          f"difference, parameters bitwise equal {worst['bitwise']}; "
          f"sharded predict (default, fused_stages, pallas_subm_conv + "
          f"zfold_pallas) against live: {preds}, bitwise {bitwise}; "
          f"launches {launches} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    report["world1_nccl"] = {"step_ms": got_step["ms"],
                             "one_device_step_ms": want_step["ms"], **worst,
                             "predict_bitwise": bitwise}

    # ---- (c) world 2 on this card over gloo ----------------------------
    t0 = time.perf_counter()
    # float32, TF32 off: the spatial step and predict at the CPU
    # tolerances (two bf16 ranks at B = 1 each fit; float32 at B = 1)
    exact = dict(base, cfg=fp32, state=state_of(fp32), batch=items[0],
                 exact_fp32=True)
    sp_step = dict(exact, kind="train", spatial=True, mesh=(1, 2))
    sp_pred = dict(exact, kind="predict", fn="spatial_predict", mesh=(1, 2))
    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want_sp_step = rr.train(sp_step)
    want_sp_pred = rr.predict(sp_pred)
    # the gather encoder (sparse_budget 131,072, as phase 20b; the npz)
    # and the dense backbone (config.yaml's neck; the npz's PFN and
    # encoder, the backbone, neck and head seeded as in phase 20c): the
    # spatial 1 x 2 predict and step, float32, TF32 off
    windows = c16_windows(rr, fp32, items[0])
    net_cases, want_nets = {}, {}
    for name, cfg in (("sparse_middle", configs.flagship_cfg({
            "compute_dtype": "float32", "sparse_middle": True,
            "sparse_budget": 131_072})),
            ("dense_backbone", windows[40.0][0])):
        state = (windows[40.0][1] if name == "dense_backbone"
                 else state_of(cfg))
        ex = dict(base, cfg=cfg, state=state, batch=items[0],
                  exact_fp32=True)
        net_cases[name] = [
            dict(ex, kind="predict", fn="spatial_predict", mesh=(1, 2)),
            dict(ex, kind="train", spatial=True, mesh=(1, 2))]
        want_nets[name] = [rr.predict(net_cases[name][0]),
                           rr.train(net_cases[name][1])]
        torch.cuda.empty_cache()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old_tf32
    dp_steps = [dict(step2, mesh=(2, 1))]
    for pair in dp_clouds[1:]:
        more = [make_batch(tree_scene(seed), p_max) for seed in pair]
        dp_steps.append(dict(step2, mesh=(2, 1), batch={
            k: np.concatenate([it[k] for it in more]) for k in batch2}))
    want_dp = [want_step] + [rr.train(case) for case in dp_steps[1:]]
    torch.cuda.empty_cache()
    cases = [dict(kind="gloo_probe", device="cuda"),
             dict(pred2, fn="spatial_predict", mesh=(1, 2)),
             sp_pred, sp_step, *dp_steps]
    n_net = len(cases)
    for pair in net_cases.values():
        cases += pair
    t = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            prefix="spawn_", dir=os.path.join(REPO, "build")) as init_dir:
        # two ranks, one card: spawn's default backend is gloo
        ranks = spawn(rr.run_cases, 2, init_dir, args=(cases,))
    spawn_s = time.perf_counter() - t
    probe = ranks[0][0]
    if probe["backend"] != "gloo":
        raise AssertionError(f"two ranks on one card joined over "
                             f"{probe['backend']}, not gloo")
    sp_bf16 = [rr.check_preds(r[1]["preds"], want_pred["preds"])
               for r in ranks]
    sp_f32 = [rr.check_preds(r[2]["preds"], want_sp_pred["preds"])
              for r in ranks]
    sp_worst = rr.check_step([r[3] for r in ranks], want_sp_step, OPT["lr"])
    dp = [rr.check_step([r[4 + i] for r in ranks], want, OPT["lr"],
                        bf16_start=step2["state"])
          for i, want in enumerate(want_dp)]
    k12 = [[r[i]["launches"]["postsort_scan"],
            r[i]["launches"]["scatter_to_grid"]] for r in ranks
           for i in range(1, n_net)]
    if not all(a and b for a, b in k12):
        raise AssertionError(f"gloo world 2: K1/K2 did not launch on a "
                             f"rank: {k12}")
    nets = {}
    for j, (name, (want_p, want_s)) in enumerate(want_nets.items()):
        i = n_net + 2 * j
        got_p, got_s = [r[i] for r in ranks], [r[i + 1] for r in ranks]
        k1k2 = [[g["launches"]["postsort_scan"],
                 g["launches"]["scatter_to_grid"]] for g in got_p + got_s]
        # the gather encoder builds no dense grid: no K2
        if not all(a and (b > 0) == (name == "dense_backbone")
                   for a, b in k1k2):
            raise AssertionError(f"gloo world 2, spatial {name}: K1/K2 "
                                 f"launches {k1k2}")
        # the dense backbone's float32 gradients are ill-conditioned at
        # this size (a ReLU or a max that rounding flips moves a batch
        # norm's bias gradient, a sum that nearly cancels, past 1e-4 of
        # its largest element): c16_phase holds its split against the
        # float64 instrument's step instead
        step = None
        if name == "dense_backbone":
            dense_split32 = got_s
        else:
            step = rr.check_step(got_s, want_s, OPT["lr"])
        nets[name] = {
            "predict": [rr.check_preds(g["preds"], want_p["preds"])
                        for g in got_p],
            "step": step,
            "per_leaf_grad_share": leaf_grad_share(got_s, want_s),
            "step_ms": [g["ms"] for g in got_s],
            "one_device_step_ms": want_s["ms"], "k1_k2": k1k2}
        step_text = ("" if step is None else
                     f"step loss {step['loss']:.3g}, gradient "
                     f"{step['grad']:.3g}, parameter {step['param']:.3g}; ")
        print(f"phase 19c spatial 1 x 2 {name} (float32, TF32 off, cloud "
              f"1) against one device: predict {nets[name]['predict']}; "
              f"{step_text}the largest gradient share of 1e-4 of a leaf's "
              f"own largest {nets[name]['per_leaf_grad_share']:.3g}; "
              f"step ms per rank "
              f"{[round(m, 1) for m in nets[name]['step_ms']]} (one "
              f"device {want_s['ms']:.1f}); K1 / K2 per rank and run "
              f"{k1k2}", flush=True)
    nets["dense_backbone"]["c16"] = c16_phase(
        rr, base, windows, want_nets["dense_backbone"][1], dense_split32)
    print(f"phase 19c gloo collectives on CUDA tensors: {probe}",
          flush=True)
    dp_text = "; ".join(
        f"clouds {pair}: loss {w['loss']:.3g}, gradient {w['grad']:.3g}, "
        f"parameter {w['param']:.3g}, share of the tolerance used "
        f"{ {k: round(v, 3) for k, v in w['used'].items()} }"
        for pair, w in zip(dp_clouds, dp))
    print(f"phase 19c world 2 on one card over gloo (a correctness run: "
          f"two ranks share the card; spawn {spawn_s:.1f} s): "
          f"data-parallel step (bf16, B = 1 a rank) against one device at "
          f"B = 2 (losses, gradients and running statistics within "
          f"{rr.BF16_ULPS} bf16 ulps of the loss, of the leaf's largest "
          f"gradient and of its largest move; parameters as in (b)): "
          f"{dp_text}; spatial 1 x 2 "
          f"predict bf16 {sp_bf16}, float32 {sp_f32}; spatial 1 x 2 step "
          f"(float32, TF32 off, B = 1) against one device: loss "
          f"{sp_worst['loss']:.3g}, gradient {sp_worst['grad']:.3g}, "
          f"parameter {sp_worst['param']:.3g}; per rank, K1 / K2 launches "
          f"of the bf16 and float32 spatial predict, spatial step, dp "
          f"steps: {k12}; step ms per rank, data-parallel "
          f"{[round(r[4]['ms'], 1) for r in ranks]} (one device at B = 2: "
          f"{want_step['ms']:.1f}), spatial "
          f"{[round(r[3]['ms'], 1) for r in ranks]} (one device float32 at "
          f"B = 1: {want_sp_step['ms']:.1f}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    report["gloo_world2"] = {
        "probe": probe, "dp_bf16": dict(zip(map(str, dp_clouds), dp)),
        "spatial_step": sp_worst, "k1_k2": k12, "spawn_s": spawn_s,
        "dp_step_ms": [r[4]["ms"] for r in ranks],
        "spatial_step_ms": [r[3]["ms"] for r in ranks],
        "one_device_spatial_ref_ms": want_sp_step["ms"],
        "spatial_networks": nets}
    return launches, report


def _first_call_args(module, name, store):
    """Replace ``module.name`` by a wrapper that keeps its first call's
    arguments in ``store[name]``; returns the original, to put back."""
    orig = getattr(module, name)

    def wrapped(*args):
        store.setdefault(name, args)
        return orig(*args)

    setattr(module, name, wrapped)
    return orig


def _timed_steps(model, batches, counted):
    """A warm-up train step on ``batches[0]``, then one timed step on each
    later batch (opt as phase 9): (losses, wall ms, peak GiB, launches)
    of the timed steps; losses finite and ``num_pos`` > 0."""
    tx = model.get_optimizer(dict(lr=1e-3, betas=(0.95, 0.99),
                                  weight_decay=0.01), grad_clip_value=2.0)
    step = model.make_train_step(tx)
    torch.cuda.reset_peak_memory_stats()
    step(batches[0])
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    losses, times = [], []
    for batch in batches[1:]:
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        vals = {k: float(v) for k, v in out.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite step losses {vals}")
        if vals["num_pos"] <= 0:
            raise AssertionError("a train step with no positive anchor")
        losses.append(vals)
    return (losses, times, torch.cuda.max_memory_allocated() / 2 ** 30,
            {name: fn.launches for name, fn in counted.items()})


def _timed_predicts(model, batches):
    """One warm-up predict of cloud 0, then one of each cloud: (outputs,
    wall ms, peak GiB); outputs finite, and cloud 0's two predicts
    bitwise equal with PyTorch's deterministic mode off (C8)."""
    torch.cuda.reset_peak_memory_stats()
    warm = model.predict(batches[0])
    torch.cuda.synchronize()
    outs, times = [], []
    for batch in batches:
        t = time.perf_counter()
        outs.append(model.predict(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    for i, out in enumerate(outs):
        for key in ("bbox", "score"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"cloud {i}: non-finite {key}")
    if torch.are_deterministic_algorithms_enabled() or not all(
            torch.equal(warm[k], outs[0][k]) for k in warm):
        raise AssertionError("C8: two predicts of cloud 0 differ")
    return outs, times, torch.cuda.max_memory_allocated() / 2 ** 30


def parked_phase(batches, counted, layout_step_ms, predict_ms):
    """Phase 20: the paths the flagship does not take, at its width.
    Returns ({kernel: {launches key: count}}, the ``parked`` report)."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models import network as network_mod
    from objectdetection_3d_tpu_torch.models.assign import (
        aabb_and_volume,
        aabb_tier,
        assign_targets,
    )
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.network import init_parameters
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    # the module (the package's ``voxelize`` is the function)
    voxelize_mod = importlib.import_module(
        "objectdetection_3d_tpu_torch.ops.voxelize")
    from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
        iou_gathered,
        iou_gathered_plain,
    )
    from objectdetection_3d_tpu_torch.ops.grid_scatter import (
        scatter_to_grid,
        scatter_to_grid_plain,
    )
    from objectdetection_3d_tpu_torch.ops.sparse_conv import (
        downsample_z_active_set,
    )
    from objectdetection_3d_tpu_torch.ops.voxel_scan import (
        postsort_scan,
        postsort_scan_plain,
    )
    from objectdetection_3d_tpu_torch.scene import MAX_GT

    launches, report = {}, {}

    # ---- (a) the layout-free assignment ---------------------------------
    model = PointPillars(configs.flagship_cfg(), device="cuda")
    load_npz(model.net, NPZ)
    # the flagship's own anchors, taken as a grid with no layout
    model.anchor_layout = model.combo_tab = None
    model.anchor_aabb = aabb_and_volume(model.anchors)
    b0 = batches[0]
    gt = torch.as_tensor(b0["bboxes"][0], device="cuda")
    labels = torch.as_tensor(b0["labels"][0], device="cuda")
    gt_mask = torch.as_tensor(b0["gt_mask"][0], device="cuda")
    k = int(model.tpu_cfg["assign_candidates_per_gt"])
    args = (model.anchors, gt, labels, gt_mask, model._pos_thr,
            model._neg_thr, None)
    kw = dict(candidates_per_gt=k, num_classes=1,
              anchor_aabb=model.anchor_aabb)
    assign_targets(*args, **kw)             # warm-up
    assign_targets(*args, **kw, plain=True)
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    t = time.perf_counter()
    tk = assign_targets(*args, **kw)
    torch.cuda.synchronize()
    t_kernel = (time.perf_counter() - t) * 1e3
    counts = {name: fn.launches for name, fn in counted.items()}
    if counts != {**{n: 0 for n in counted}, "iou_gathered": 1}:
        raise AssertionError(f"layout-free assignment launched {counts}")
    t = time.perf_counter()
    tp = assign_targets(*args, **kw, plain=True)
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t) * 1e3
    pos = tp["pos_mask"]
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets",
                "num_pos"):
        if not torch.equal(tk[key], tp[key]):
            raise AssertionError(f"layout-free assignment {key!r} differs "
                                 f"between K6 and its plain version")
    if not torch.equal(tk["best_gt"][pos], tp["best_gt"][pos]):
        raise AssertionError("layout-free assignment best_gt differs under "
                             "pos_mask")
    errs = {key: max_abs_err(tk[key], tp[key])
            for key in ("max_overlap", "target_deltas")}
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"layout-free assignment: {errs} beyond 1e-5")
    num_pos = int(tk["num_pos"])
    if num_pos <= 0:
        raise AssertionError("layout-free assignment of cloud 0 has no "
                             "positive anchor")
    # K6 on this path's own candidates against its plain version
    cand, _ = aabb_tier(model.anchors, gt, MAX_GT, k, 16, model.anchor_aabb)
    rows = torch.arange(MAX_GT, dtype=torch.int32,
                        device="cuda").repeat_interleave(k)
    g6 = (gt, gt_mask, rows, model.anchors[cand.reshape(-1)].contiguous())
    k6_err = max_abs_err(iou_gathered(*g6), iou_gathered_plain(*g6))
    if not k6_err <= 1e-5:
        raise AssertionError(f"K6 on the layout-free candidates differs "
                             f"from its plain version by {k6_err}")
    k6_ms = cuda_ms(lambda: iou_gathered(*g6), 5)
    k6_plain_ms = cuda_ms(lambda: iou_gathered_plain(*g6), 1)
    print(f"20a layout-free assignment cloud 0 (G={MAX_GT}, "
          f"{int(gt_mask.sum())} trees, N={model.anchors.shape[0]}, K={k}): "
          f"K6 route == plain route (masks, labels, dir targets, best_gt "
          f"under pos_mask; max_overlap and deltas within 1e-5: {errs}); "
          f"num_pos {num_pos}, negatives {int(tk['neg_mask'].sum())}; "
          f"{t_kernel:.1f} ms with K6, {t_plain:.1f} ms plain; K6 on its "
          f"candidates: max abs err {k6_err:.3g}, {k6_ms:.4f} ms vs plain "
          f"{k6_plain_ms:.4f} ms", flush=True)
    del tk, tp, g6
    losses, times, peak, counts = _timed_steps(model, batches[:3], counted)
    if counts["iou_gathered"] != 2 or counts["chunk_geometry"] or \
            counts["containment_rescue"] or counts["iou_gathered_pair"]:
        raise AssertionError(f"layout-free steps launched {counts}")
    print(f"20a layout-free train steps (bf16, B=1, clouds 1-2 after a "
          f"warm-up): {[round(t_, 1) for t_ in times]} ms (the layout "
          f"step: {layout_step_ms:.1f} ms, phase 9); losses {losses}; peak "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    launches["layout_free"] = counts
    report["layout_free"] = {
        "assign_ms": t_kernel, "assign_plain_ms": t_plain,
        "num_pos": num_pos, "max_errs": errs, "k6_max_abs_err": k6_err,
        "k6_ms": k6_ms, "k6_plain_ms": k6_plain_ms, "step_ms": times,
        "layout_step_ms": layout_step_ms, "peak_gib": peak}
    del model
    torch.cuda.empty_cache()

    # ---- (b) the gather encoder -----------------------------------------
    # the voxel budget V cuts the active sets of stages 1-3 on these
    # clouds (up to 113k sites): the phase gives each stage 131,072
    budget = 131_072
    sizes = []
    probe = PointPillars(configs.flagship_cfg({"sparse_middle": True}),
                         device="cuda")
    for batch in batches:
        vox = probe.voxel_layer(
            torch.as_tensor(batch["points"], device="cuda"),
            torch.as_tensor(batch["num_points"], device="cuda"))
        coords, mask = vox["coords"][0], vox["voxel_mask"][0]
        grid, row = probe.grid_dhw, [int(mask.sum())]
        for _ in probe.net.pseudoimage_generator.out_channels:
            new = downsample_z_active_set(coords, mask, grid, 2 * budget)
            coords, mask, grid = (new["coords"], new["active_mask"],
                                  new["grid"])
            row.append(int(mask.sum()))
        sizes.append(row)
    del probe, vox, coords, mask, new
    if max(max(r) for r in sizes) > budget:
        raise AssertionError(f"active sets {sizes} exceed the budget "
                             f"{budget}")
    print(f"20b active sites per stage (voxels, then each downsample) on "
          f"clouds 0-3: {sizes}; budget {budget}", flush=True)

    def encoder_pair(dtype):
        tpu = {"compute_dtype": dtype}
        dense = PointPillars(configs.flagship_cfg(tpu), device="cuda")
        sparse = PointPillars(configs.flagship_cfg(dict(
            tpu, sparse_middle=True, sparse_budget=budget)), device="cuda")
        for m in (dense, sparse):
            load_npz(m.net, NPZ)
        return dense, sparse

    def pseudo_and_preds(model):
        seen = {}
        hook = model.net.pseudoimage_generator.register_forward_hook(
            lambda mod, args, out: seen.setdefault("out", out))
        preds = model.predict(batches[0])
        hook.remove()
        return seen["out"], preds

    dense, sparse = encoder_pair("float32")
    want, want_p = pseudo_and_preds(dense)
    got, got_p = pseudo_and_preds(sparse)
    scale = float(want.abs().max())
    err = max_abs_err(got, want)
    if not err <= 1e-3 * scale:
        raise AssertionError(f"float32 gather pseudo-image differs from the "
                             f"dense encoder's by {err} (scale {scale})")
    same = (torch.equal(got_p["valid"], want_p["valid"])
            and torch.equal(got_p["label"], want_p["label"])
            and bool(want_p["valid"].any()))
    gb = got_p["bbox"][want_p["valid"]].double()
    wb = want_p["bbox"][want_p["valid"]].double()
    # a box's coordinates reach hundreds of metres (decoded sizes are
    # exponentials of the deltas): each is held to 1e-4 of its own size,
    # at least 1 m (the CPU tests hold boxes to 1e-4)
    box_rel = float(((gb - wb).abs() / wb.abs().clamp(min=1.0)).max()) \
        if same else None
    score_err = max_abs_err(got_p["score"], want_p["score"])
    print(f"20b float32 cloud 0: gather pseudo-image max abs err {err:.3g} "
          f"of scale {scale:.3g}; detections: valid and labels equal "
          f"{same}, boxes {box_rel} of their size, scores {score_err:.3g}",
          flush=True)
    if not (same and box_rel <= 1e-4 and score_err <= 1e-4):
        raise AssertionError(f"float32 gather detections differ from the "
                             f"dense encoder's (boxes {box_rel} of their "
                             f"size, scores {score_err})")
    box_err = max_abs_err(gb, wb)
    print(f"20b float32 (TF32 off) cloud 0: gather pseudo-image max abs err "
          f"{err:.3g} of scale {scale:.3g} against the dense encoder (gate "
          f"1e-3 of the scale); {int(got_p['valid'].sum())} detections, "
          f"valid and labels equal, boxes within {box_err:.3g} m, "
          f"{box_rel:.3g} of their size (gate 1e-4; the largest "
          f"coordinate {float(wb.abs().max()):.1f}), scores within "
          f"{score_err:.3g} (gate 1e-4)", flush=True)
    report["sparse_middle"] = {"float32_pseudo_err": err,
                               "float32_pseudo_scale": scale,
                               "float32_box_err": box_err,
                               "float32_box_rel_err": box_rel,
                               "float32_score_err": score_err,
                               "active_sites": sizes, "budget": budget}
    del dense, sparse, want, got, want_p, got_p
    torch.cuda.empty_cache()

    _, sparse = encoder_pair("bfloat16")
    for fn in counted.values():
        fn.launches = 0
    outs, p_times, p_peak = _timed_predicts(sparse, batches)
    p_counts = {name: fn.launches for name, fn in counted.items()}
    if p_counts["postsort_scan"] != 5 or p_counts["scatter_to_grid"]:
        raise AssertionError(f"gather predicts launched {p_counts}")
    losses, s_times, s_peak, s_counts = _timed_steps(sparse, batches[:3],
                                                     counted)
    print(f"20b gather encoder (bf16, the npz): predict median "
          f"{np.median(p_times):.1f} ms per cloud over 4 clouds (the dense "
          f"encoder {predict_ms:.1f} ms, phase 5), peak {p_peak:.2f} GiB, "
          f"valid {[int(o['valid'].sum()) for o in outs]}, C8 bitwise; "
          f"train steps {[round(t_, 1) for t_ in s_times]} ms, peak "
          f"{s_peak:.2f} GiB, losses {losses}; launches predict "
          f"{p_counts}, steps {s_counts}", flush=True)
    launches["sparse_middle"] = {
        name: p_counts[name] + s_counts[name] for name in counted}
    report["sparse_middle"].update(
        predict_ms=p_times, predict_peak_gib=p_peak, step_ms=s_times,
        step_peak_gib=s_peak)
    del sparse, outs
    torch.cuda.empty_cache()

    # ---- (c) the dense backbone and neck --------------------------------
    cfg = _rank_cases().dense_backbone_cfg(configs.flagship_cfg())
    model = PointPillars(cfg, device="cuda")
    init_parameters(model.net, torch.Generator().manual_seed(0))
    if model.featmap != (200, 200) or \
            model.anchors.shape[0] != 200 * 200 * model.num_anchors:
        raise AssertionError(f"dense backbone featmap {model.featmap}")
    seen = {}
    orig = (_first_call_args(voxelize_mod, "postsort_scan", seen),
            _first_call_args(network_mod, "scatter_to_grid", seen))
    try:
        model.predict(batches[0])
    finally:
        voxelize_mod.postsort_scan, network_mod.scatter_to_grid = orig
    k_got = postsort_scan(*seen["postsort_scan"])
    k_want = postsort_scan_plain(*seen["postsort_scan"])
    g_got = scatter_to_grid(*seen["scatter_to_grid"])
    g_want = scatter_to_grid_plain(*seen["scatter_to_grid"])
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(k_got, k_want))
            and torch.equal(g_got, g_want)):
        raise AssertionError("K1 or K2 on the dense-backbone path differs "
                             "from its plain version")
    k1_ms = cuda_ms(lambda: postsort_scan(*seen["postsort_scan"]), 20)
    k2_ms = cuda_ms(lambda: scatter_to_grid(*seen["scatter_to_grid"]), 20)
    del k_got, k_want, g_got, g_want, seen
    for fn in counted.values():
        fn.launches = 0
    outs, p_times, p_peak = _timed_predicts(model, batches)
    p_counts = {name: fn.launches for name, fn in counted.items()}
    if p_counts["postsort_scan"] != 5 or p_counts["scatter_to_grid"] != 5:
        raise AssertionError(f"dense-backbone predicts launched {p_counts}")
    if tuple(outs[0]["bbox"].shape) != (1, model.tpu_cfg["max_detections"],
                                        9):
        raise AssertionError(f"bbox shape {tuple(outs[0]['bbox'].shape)}")
    losses, s_times, s_peak, s_counts = _timed_steps(model, batches[:3],
                                                     counted)
    if min(s_counts.values()) <= 0:
        raise AssertionError(f"dense-backbone steps launched {s_counts}")
    print(f"20c dense backbone + neck (bf16, seeded weights, featmap "
          f"{model.featmap}, head {model.net.bbox_head.conv_cls.in_channels} "
          f"channels): K1 and K2 on cloud 0's inputs bit-exact against "
          f"their plain versions ({k1_ms:.4f} / {k2_ms:.4f} ms); predict "
          f"median {np.median(p_times):.1f} ms per cloud, peak "
          f"{p_peak:.2f} GiB, C8 bitwise; train steps "
          f"{[round(t_, 1) for t_ in s_times]} ms, peak {s_peak:.2f} GiB, "
          f"losses {losses}; launches predict {p_counts}, steps "
          f"{s_counts}", flush=True)
    launches["dense_backbone"] = {
        name: p_counts[name] + s_counts[name] for name in counted}
    report["dense_backbone"] = {
        "featmap": list(model.featmap), "k1_ms": k1_ms, "k2_ms": k2_ms,
        "predict_ms": p_times, "predict_peak_gib": p_peak,
        "step_ms": s_times, "step_peak_gib": s_peak}
    del model, outs
    torch.cuda.empty_cache()
    return launches, report


def remat_phase(batches, scenes):
    """Phase 21: ``tpu.remat`` at the flagship width (bf16, the npz,
    phase 9's AdamW).  Returns (K9's launches in one ``zfold_pallas``
    step under ``"middle"``, the ``remat`` report)."""
    import gc

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3
    from objectdetection_3d_tpu_torch.scene import make_batch

    def model_of(tpu):
        model = PointPillars(configs.flagship_cfg(tpu), device="cuda")
        load_npz(model.net, NPZ)
        return model

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    report = {"b1": {}, "b8": {}}
    # B = 1: the first step from the npz under each value, its gradients
    # and running statistics against remat: false's; then two timed steps
    base = start = None
    for value in (False, "rpn", "middle", True):
        model = model_of({"remat": value})
        if start is None:
            start = {k: v.detach().clone()
                     for k, v in model.net.state_dict().items()}
        free()
        torch.cuda.reset_peak_memory_stats()
        losses, grads, state = _step_run(model, start, batches[1], None)
        step = model.make_train_step(
            model.get_optimizer(OPT, grad_clip_value=CLIP))
        times = []
        for i in (2, 3):
            t = time.perf_counter()
            out = step(batches[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if not all(np.isfinite(float(v)) for v in out.values()):
                raise AssertionError(f"remat {value!r} step on cloud {i}: "
                                     f"non-finite {out}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        row = {"regions": list(model.net.remat_regions),
               "ms": [t * 1e3 for t in times], "peak_gib": peak}
        if base is None:
            base = (losses, grads, state)
        else:
            stats = [k for k in state
                     if k.endswith(("running_mean", "running_var"))]
            row["losses_equal"] = losses == base[0]
            row["grads_bitwise"] = all(torch.equal(v, base[1][k])
                                       for k, v in grads.items())
            row["stats_bitwise"] = all(torch.equal(state[k], base[2][k])
                                       for k in stats)
            row["params_bitwise"] = all(torch.equal(v, base[2][k])
                                        for k, v in state.items())
            if not (row["grads_bitwise"] and row["stats_bitwise"]):
                raise AssertionError(f"remat {value!r}: the first step's "
                                     f"gradients or running statistics "
                                     f"differ from remat: false's: {row}")
        report["b1"][str(value)] = row
        print(f"phase 21 remat {value!r} (recomputes {row['regions']}), "
              f"B = 1: steps {[round(t, 1) for t in row['ms']]} ms, peak "
              f"{peak:.2f} GiB; against remat: false "
              f"{ {k: v for k, v in row.items() if k.endswith(('_equal', '_bitwise'))} }",
              flush=True)
        del model, step, losses, grads, state
    del base, start
    free()

    # B = 8 under remat: true (the flagship's) in chunks of 1, 2, 4, 8
    p_max = configs.flagship_cfg()["tpu"]["max_points_static"]
    items = [make_batch(sc, p_max) for sc in scenes[:8]]
    batch8 = {k: np.concatenate([it[k] for it in items]) for k in items[0]}
    model = model_of({"remat": True})
    start = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    for mb in (1, 2, 4, 8):
        model.net.load_state_dict(start)
        tx = model.get_optimizer(OPT, grad_clip_value=CLIP)
        step = model.make_train_step(tx, microbatch=mb)
        free()
        torch.cuda.reset_peak_memory_stats()
        try:
            step(batch8)                    # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch8)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        except torch.cuda.OutOfMemoryError:
            # data, not a failure: this chunk size does not fit the card
            report["b8"][str(mb)] = "does not fit"
            print(f"phase 21 B = 8 in chunks of {mb} (remat: true): does "
                  f"not fit", flush=True)
            tx.zero_grad(set_to_none=True)
            del step, tx
            free()
            continue
        if not all(np.isfinite(float(v)) for v in out.values()):
            raise AssertionError(f"B = 8 in chunks of {mb}: non-finite "
                                 f"{out}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        report["b8"][str(mb)] = {"ms": ms, "peak_gib": peak}
        print(f"phase 21 B = 8 in chunks of {mb} (remat: true): {ms:.1f} ms "
              f"a step, peak {peak:.2f} GiB", flush=True)
        del step, tx, out
    del model, start, batch8
    free()

    # K9 under zfold_pallas with remat: "middle": the encoder's forward
    # runs again in the backward, so 3 + 3 forward and 3 dx a step
    model = model_of({"zfold_pallas": True, "remat": "middle"})
    step = model.make_train_step(model.get_optimizer(OPT,
                                                     grad_clip_value=CLIP))
    step(batches[0])                        # warm-up
    torch.cuda.synchronize()
    conv2d_3x3.launches = conv2d_3x3.dx_launches = 0
    step(batches[1])
    torch.cuda.synchronize()
    k9 = {"forward": conv2d_3x3.launches, "dx": conv2d_3x3.dx_launches}
    if k9 != {"forward": 6, "dx": 3}:
        raise AssertionError(f"K9 launches in one zfold_pallas step under "
                             f"remat 'middle': {k9}, expected 6 forward (3 "
                             f"and their recompute) and 3 dx")
    report["k9_zfold_middle"] = k9
    print(f"phase 21 K9 in one zfold_pallas step under remat 'middle': "
          f"{k9}", flush=True)
    del model, step
    free()
    return k9, report


def full_width_phase():
    """Phase 22: the port's float32 flagship predict (TF32 off) of clouds
    0-3 on the card against the JAX package's, read from
    ``tests/jax_reference/flagship_predict.npz``
    (``tests/make_jax_flagship_reference.py``): ``valid`` and labels
    exact; where valid, scores within 1e-5 and boxes within 1e-4 of
    max(|value|, 1 m).  Returns K1's and K2's launches over the four
    predicts and the readings."""
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid
    from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
    from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene

    path = os.path.join(REPO, "tests", "jax_reference",
                        "flagship_predict.npz")
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PointPillars(configs.flagship_cfg({"compute_dtype": "float32"}),
                         device="cuda")
    load_npz(model.net, NPZ)
    with np.load(NPZ) as z:
        model.head_cfg["score_thr"] = float(z["score_thr"])
    predict = model.make_predict_fn()
    p_max = model.tpu_cfg["max_points_static"]
    batches = [make_batch(tree_scene(seed), p_max)
               for seed in range(len(want["valid"]))]
    postsort_scan.launches = 0
    scatter_to_grid.launches = 0
    got = [{k: v.cpu().numpy()[0] for k, v in predict(b).items()}
           for b in batches]
    torch.cuda.synchronize()
    launches = {"postsort_scan": postsort_scan.launches,
                "scatter_to_grid": scatter_to_grid.launches}
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old_tf32
    del model
    torch.cuda.empty_cache()
    if not all(launches.values()):
        raise AssertionError(f"phase 22: K1 / K2 did not launch: {launches}")
    clouds = []
    for i, out in enumerate(got):
        valid = want["valid"][i]
        if not np.array_equal(out["valid"], valid) or not np.array_equal(
                out["label"][valid], want["label"][i][valid]):
            raise AssertionError(
                f"phase 22 cloud {i}: valid or labels differ from the JAX "
                f"package's ({int(out['valid'].sum())} valid against "
                f"{int(valid.sum())})")
        d_score = np.abs(out["score"][valid] - want["score"][i][valid])
        box = want["bbox"][i][valid]
        d_box = np.abs(out["bbox"][valid] - box)
        row = {"valid": int(valid.sum()),
               "score": float(d_score.max(initial=0.0)),
               "score_share": float(d_score.max(initial=0.0) / 1e-5),
               "bbox": float(d_box.max(initial=0.0)),
               "bbox_share": float((d_box / (1e-4 * np.maximum(
                   np.abs(box), 1.0))).max(initial=0.0))}
        clouds.append(row)
        print(f"phase 22 cloud {i} (float32, TF32 off) against the JAX "
              f"package: {row['valid']} valid, labels equal; largest score "
              f"difference {row['score']:.3g} ({row['score_share']:.3g} of "
              f"1e-5), box {row['bbox']:.3g} m ({row['bbox_share']:.3g} of "
              f"1e-4 of max(|value|, 1 m))", flush=True)
        if row["score_share"] > 1 or row["bbox_share"] > 1:
            raise AssertionError(f"phase 22 cloud {i}: {row}")
    return launches, {"reference": str(want["provenance"]),
                      "clouds": clouds, "launches": launches}


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
    from objectdetection_3d_tpu_torch.ops.masked_norm import (
        masked_affine_relu,
    )
    from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
    from objectdetection_3d_tpu_torch.profile_train import (
        phase_device_ms,
        traced_steps,
    )

    clock = PhaseClock()
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
        norm_entry(model, batches[0])
        scan_entry(model, batches)
        gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
        gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
        geom = geometry_tier(gt, gt_mask, model.anchor_layout,
                             model.combo_tab, MAX_GT,
                             int(model.tpu_cfg["assign_candidates_per_gt"]),
                             16, chunk_geometry)
        geometry_kernels(model, geom, gt_mask, batches[0])
        negative_dims_gate(model, batches[0])
        aligned_clipper(model, batches[0])
        print("quick check passed", flush=True)
        return 0

    clock.mark('build')
    # ---- K1: post-sort scan at B=1 and 4, P=131,072 -------------------
    kernels["postsort_scan"] = scan_entry(model, batches)
    vl = model.voxel_layer
    pts0 = torch.as_tensor(batches[0]["points"], device="cuda")
    n0 = torch.as_tensor(batches[0]["num_points"], device="cuda")
    sentinel = d * h * w

    clock.mark('K1: post-sort scan at B=1 and 4, P=131,072')
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

    clock.mark('K2: grid scatter at V=102,400, C=20, 100x400x400')
    # ---- voxelizer: kernel path on the card vs plain path on the CPU ---
    vox_cpu = vl.points_batch(pts0.cpu(), n0.cpu())
    for key, val in vox0.items():
        if not torch.equal(val.cpu(), vox_cpu[key]):
            raise AssertionError(f"voxelizer output {key!r} differs between "
                                 f"the card and the CPU")
    print(f"voxelizer: card == CPU on all {len(vox0)} outputs "
          f"({int(vox0['num_voxels'][0])} voxels)", flush=True)
    del vox0, vox_cpu

    clock.mark('voxelizer: kernel path on the card vs plain path on the CPU')
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
    masked_affine_relu.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm = predict(batches[0])              # warm-up
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
    # K11: the ten eval stage norms of each of the five predicts
    k11_predict = masked_affine_relu.launches
    if k11_predict != 10 * (len(batches) + 1):
        raise AssertionError(f"K11 launched {k11_predict} times in "
                             f"{len(batches) + 1} predicts, not 10 each")
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
    predict_ms = float(np.median(times) * 1e3)
    print(f"predict: median {np.median(times) * 1e3:.1f} ms per cloud over "
          f"{len(times)} clouds (B=1, bf16, after one warm-up); launches "
          f"{launches}; peak memory {peak:.2f} GiB", flush=True)
    # C8: the warm-up and the timed call of cloud 0, deterministic mode off
    if torch.are_deterministic_algorithms_enabled() or not all(
            torch.equal(warm[k], preds[0][k]) for k in warm):
        raise AssertionError("C8: two bf16 predicts of cloud 0 differ")
    print("C8 bf16 predict of cloud 0 twice (deterministic mode off): "
          "bitwise equal", flush=True)
    del warm

    clock.mark('predict: flagship, bf16, trained weights, 4 clouds')
    # ---- float32 run of cloud 0 ----------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = PointPillars(configs.flagship_cfg({"compute_dtype": "float32"}),
                           device="cuda")
    load_npz(model32.net, NPZ)
    out32 = model32.make_predict_fn()(batches[0])
    again = model32.make_predict_fn()(batches[0])
    torch.cuda.synchronize()
    if not all(torch.equal(out32[k], again[k]) for k in out32):
        raise AssertionError("C8: two float32 predicts of cloud 0 differ")
    print("C8 float32 predict of cloud 0 twice (TF32 off, deterministic "
          "mode off): bitwise equal", flush=True)
    centroid_sums(model32, batches[0])
    del again
    matched = centre_matches(out32, preds[0])
    print(f"float32 vs bf16 on cloud 0: {matched} of "
          f"{int(out32['valid'][0].sum())} float32 detections have a bf16 "
          f"detection within 0.5 m (bf16 has "
          f"{int(preds[0]['valid'][0].sum())})", flush=True)
    del model32, out32

    clock.mark('float32 run of cloud 0')
    # ---- assignment kernels at flagship shapes, cloud 0 ---------------
    gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
    gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
    n_anchor = model.anchors.shape[0]
    k = int(model.tpu_cfg["assign_candidates_per_gt"])
    geom = geometry_tier(gt, gt_mask, model.anchor_layout, model.combo_tab,
                         MAX_GT, k, 16, chunk_geometry)
    kernels.update(geometry_kernels(model, geom, gt_mask, batches[0]))
    kernels["chunk_geometry"]["c9_raw_differs"] = negative_dims_gate(
        model, batches[0])

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

    clock.mark('assignment kernels at flagship shapes, cloud 0')
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

    clock.mark('assignment of cloud 0: kernels vs plain versions, on the card')
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

    clock.mark('the same assignment without the exact anchor tier')
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
    start = (copy.deepcopy(model.net.state_dict()),
             copy.deepcopy(tx.state_dict()))
    for fn in counted.values():
        fn.launches = 0
    times, losses = [], []
    for i in (1, 2, 3):
        t = time.perf_counter()
        out = step(batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(out)
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
    step_ms = float(np.median(times) * 1e3)
    print(f"train: median {np.median(times) * 1e3:.1f} ms per step over "
          f"{len(times)} steps (B=1, bf16, after one warm-up); launches in "
          f"3 steps {launches}; peak memory {peak:.2f} GiB; changed "
          f"{changed}", flush=True)
    reproducible_steps(model, tx, step, batches, start, losses, times)
    del start, losses

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

    clock.mark('train: flagship, bf16, B=1')
    # ---- encoder kernels and K5 at flagship shapes ----------------------
    load_npz(model.net, NPZ)                # the npz weights, untrained
    kernels.update(encoder_kernels(model, batches[0]))
    kernels["masked_affine_relu"] = norm_entry(model, batches[0])
    kernels["masked_affine_relu"]["launches_predict"] = k11_predict
    kernels["intersection_volume_aligned"] = aligned_clipper(model,
                                                             batches[0])
    del model
    torch.cuda.empty_cache()

    clock.mark('encoder kernels and K5 at flagship shapes')
    # ---- predict and train under the lowering knobs ---------------------
    launches = knob_predicts(batches, preds)
    kernels["fused_stage"]["launches"] = launches["fused_stage"]
    kernels["subm_conv3d"]["launches"] = launches["subm_conv3d"]
    kernels["subm_conv3d"]["predict_inputs_contiguous"] = launches[
        "subm_conv3d_inputs_contiguous"]
    kernels["conv2d_3x3"]["launches_predict"] = launches["conv2d_3x3"]
    kernels["masked_affine_relu"]["launches"] = launches[
        "masked_affine_relu"]
    kernels["masked_affine_relu"]["predict_inputs_contiguous"] = launches[
        "masked_affine_relu_inputs_contiguous"]
    k9 = zfold_train(batches, counted)
    kernels["conv2d_3x3"]["launches"] = k9["forward"] + k9["dx"]
    kernels["conv2d_3x3"]["launches_forward"] = k9["forward"]
    kernels["conv2d_3x3"]["launches_dx"] = k9["dx"]
    torch.cuda.empty_cache()

    clock.mark('predict and train under the lowering knobs')
    # ---- gradient accumulation and the pipeline at the flagship width ----
    for name, count in accumulation(scenes + [tree_scene(s) for s in
                                              range(4, 8)],
                                    counted).items():
        kernels[name]["launches_accumulation"] = count
    torch.cuda.empty_cache()
    for name, count in pipeline_phase(counted).items():
        kernels[name]["launches_pipeline"] = count
    torch.cuda.empty_cache()

    clock.mark('gradient accumulation and the pipeline at the flagship width')
    # ---- tiled inference over the plot-scale scene; the importer -------
    tiled = tiled_phase()
    for name in ("postsort_scan", "scatter_to_grid"):
        kernels[name]["launches_tiled"] = tiled[1][name]
        kernels[name]["launches_tiled_batch2"] = tiled[2][name]
    torch.cuda.empty_cache()
    importer_phase(batches[0])
    torch.cuda.empty_cache()

    clock.mark('tiled inference over the plot-scale scene; the importer')
    # ---- the data-preparation and augmentation path ---------------------
    data_launches, prepared = data_path_phase(counted)
    for name, count in data_launches.items():
        kernels[name]["launches_data_path"] = count
    torch.cuda.empty_cache()

    clock.mark('the data-preparation and augmentation path')
    # ---- serving: predict exported, reloaded in a fresh process, served -
    served, serving_report = serving_phase(batches)
    for name, count in served.items():
        kernels[name]["launches_serving"] = count
    print("serving: " + json.dumps(serving_report), flush=True)
    torch.cuda.empty_cache()

    clock.mark('serving: predict exported, reloaded in a fresh process')
    # ---- the native host passes and the sharded paths ------------------
    launches, parallel_report = parallel_phase(prepared)
    for name, entry in kernels.items():
        entry["launches_parallel"] = launches[name]
    for i, name in enumerate(("postsort_scan", "scatter_to_grid")):
        kernels[name]["launches_parallel_gloo_ranks"] = [
            row[i] for row in parallel_report["gloo_world2"]["k1_k2"]]
    print("parallel: " + json.dumps(parallel_report), flush=True)
    clock.mark("native and parallel (phase 19)")
    # ---- the paths the flagship does not take ---------------------------
    launches, parked_report = parked_phase(batches, counted, step_ms,
                                           predict_ms)
    for path, counts in launches.items():
        for name, count in counts.items():
            kernels[name][f"launches_{path}"] = count
    print("parked: " + json.dumps(parked_report), flush=True)
    clock.mark("the paths the flagship does not take (phase 20)")
    # ---- tpu.remat: its values at B = 1, B = 8's chunk sizes ------------
    k9, remat_report = remat_phase(
        batches, scenes + [tree_scene(s) for s in range(4, 8)])
    kernels["conv2d_3x3"]["launches_remat_middle"] = (k9["forward"]
                                                      + k9["dx"])
    print("remat: " + json.dumps(remat_report), flush=True)
    clock.mark("tpu.remat (phase 21)")
    # ---- the full width against the JAX package's reference ------------
    launches, full_report = full_width_phase()
    for name, count in launches.items():
        kernels[name]["launches_full_width"] = count
    print("full_width: " + json.dumps(full_report), flush=True)
    clock.mark("the full width against the JAX package (phase 22)")
    if len(kernels) != 11:
        raise AssertionError(f"{len(kernels)} kernels in the line, not 11")

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
