#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit from ``nvidia-smi``;
2. build: compiles every CUDA kernel of the path from ``csrc/`` (one
   ``nvcc`` per source, all started together) and prints the build time;
3. kernels: at flagship shapes, each kernel against its plain PyTorch
   version on the same inputs, bit-exact, with both timed by CUDA events;
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
   inputs (128 padded GT boxes, 1.92 M anchors, K = 512), both timed;
8. assignment: the flagship assignment of cloud 0 through the kernels
   and through their plain versions, both on the card: masks, labels,
   direction targets and ``best_gt`` under ``pos_mask`` equal, and
   ``num_pos`` > 0;
9. train: the flagship (bf16, B = 1) from the trained npz with AdamW (lr
   1e-3, betas (0.95, 0.99), weight decay 0.01, gradient value clip 2.0):
   one warm-up step, then 3 timed steps on clouds 1-3; every loss finite,
   ``num_pos`` > 0, parameters and running statistics changed, and all
   six kernels launched during the timed steps; then one more step of
   the same step function under ``torch.profiler``, its device time split
   by the step's own phase ranges (forward, assignment, loss + backward,
   optimizer).

The last lines are the ``kernels`` JSON line, the card line and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "artifacts", "overfit_ckpt.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# float32 operations (arithmetic, compares, min/max) counted from the
# kernel bodies: per (GT, anchor) pair of K3 and of K4, and per clipped
# box pair of K6/K7 (12 polygons; per plane slot 23 ops over the 49 slots
# of the ring schedule, 16 per fan triangle, and 560 for the two boxes'
# corners, planes and the IoU)
K3_OPS_PER_PAIR = 128
K4_OPS_PER_PAIR = 53
CLIP_OPS_PER_PAIR = 12 * (49 * 23 + 10 * 16) + 560


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def bytes_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the float32 operations over the card's peak."""
    by_bytes = bytes_ms(nbytes)
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations"
    return by_bytes, "bytes"


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
        chunk_geometry_plain,
        containment_rescue,
        containment_rescue_plain,
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
    from objectdetection_3d_tpu_torch.ops.voxel_scan import (
        postsort_scan,
        postsort_scan_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxelize import cells_sorted
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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = configs.flagship_cfg()
    model = PointPillars(cfg, device="cuda")
    d, h, w = model.grid_dhw
    p_max = model.tpu_cfg["max_points_static"]
    v_max = model.voxel_layer.max_voxels
    scenes = [tree_scene(seed) for seed in range(4)]
    batches = [make_batch(sc, p_max) for sc in scenes]
    kernels = {}

    # ---- K1: post-sort scan at B=1, P=131,072 -------------------------
    vl = model.voxel_layer
    pts0 = torch.as_tensor(batches[0]["points"], device="cuda")
    n0 = torch.as_tensor(batches[0]["num_points"], device="cuda")
    cell_s, _ = cells_sorted(pts0, n0, voxel_size=vl.voxel_size,
                             point_cloud_range=vl.point_cloud_range)
    sentinel = d * h * w
    vox_k, rank_k = postsort_scan(cell_s, sentinel)
    vox_p, rank_p = postsort_scan_plain(cell_s, sentinel)
    torch.cuda.synchronize()
    err = max(max_abs_err(vox_k, vox_p), max_abs_err(rank_k, rank_p))
    if not (torch.equal(vox_k, vox_p) and torch.equal(rank_k, rank_p)):
        raise AssertionError(f"postsort_scan differs from its plain version "
                             f"(max abs err {err})")
    b1, p1 = cell_s.shape
    kernels["postsort_scan"] = {
        "name": "postsort_scan", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/voxel_scan.cu",
        "replaces": "objectdetection_3d_tpu/ops/voxel_scan.py:119",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: postsort_scan(cell_s, sentinel), 200),
        "plain_ms": cuda_ms(lambda: postsort_scan_plain(cell_s, sentinel),
                            200),
        # (B, P) int32 read once, two (B, P) int32 outputs written once
        "bound_ms": bytes_ms(3 * b1 * p1 * 4), "bound_by": "bytes",
        "library_ms": None,
    }
    print(f"K1 postsort_scan B={b1} P={p1}: bit-exact; "
          f"{kernels['postsort_scan']['ms']:.4f} ms vs plain "
          f"{kernels['postsort_scan']['plain_ms']:.4f} ms", flush=True)

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
        print(f"K2 scatter_to_grid {str(dtype)[6:]} V={v_max} C={c_pfn} "
              f"grid={d}x{h}x{w} active={n_active}: bit-exact; "
              f"{entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f} ms, "
              f"zeros+index_put_ {entry['library_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms", flush=True)
        if dtype == model.compute_dtype:
            kernels["scatter_to_grid"] = entry
        del feats, vals
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
    v32 = out32["valid"][0]
    v16 = preds[0]["valid"][0]
    c32 = out32["bbox"][0][v32][:, :3]
    c16 = preds[0]["bbox"][0][v16][:, :3]
    matched = 0
    if len(c32) and len(c16):
        dist = torch.cdist(c32[:, :2], c16[:, :2])
        matched = int((dist.min(dim=1).values < 0.5).sum())
    print(f"float32 vs bf16 on cloud 0: {matched} of {int(v32.sum())} "
          f"float32 detections have a bf16 detection within 0.5 m "
          f"(bf16 has {int(v16.sum())})", flush=True)
    del model32, out32

    # ---- assignment kernels at flagship shapes, cloud 0 ---------------
    gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
    gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
    n_anchor = model.anchors.shape[0]
    n_cell = model.anchor_layout[0].shape[0]
    k = int(model.tpu_cfg["assign_candidates_per_gt"])
    geom = geometry_tier(gt, gt_mask, model.anchor_layout, model.combo_tab,
                         MAX_GT, k, 16, chunk_geometry)
    (ftab, tabs), gid = geom["tables"][0], geom["chunks"][0].int()
    gch = ftab.shape[0]
    geo_args = (ftab, gid, tabs, model.combo_tab, model.anchor_layout[0],
                MAX_GT)
    got = chunk_geometry(*geo_args)
    want = chunk_geometry_plain(*geo_args)
    torch.cuda.synchronize()
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"chunk_geometry output {key!r} differs "
                                 f"from its plain version")
    n_cont = int((got["cm"] > 0).sum())
    del got, want
    m_combo = model.combo_tab.shape[1]
    # tables and cells read once; key, 9 per-anchor outputs, rmax written
    nbytes = 4 * (n_cell * 3 + gch * 18 + 12 * gch * m_combo + 16 * m_combo
                  + gch * n_anchor + 9 * n_anchor + gch * n_cell)
    ops = K3_OPS_PER_PAIR * gch * n_anchor
    b_ms, b_by = bound(nbytes, ops)
    kernels["chunk_geometry"] = {
        "name": "chunk_geometry", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/assign_geometry.cu",
        "replaces": "objectdetection_3d_tpu/ops/assign_geometry.py:358",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: chunk_geometry(*geo_args), 20),
        "plain_ms": cuda_ms(lambda: chunk_geometry_plain(*geo_args), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    rthr = torch.stack([geom["cont_row_max"][gid.long()],
                        gt_mask[gid.long()].float()], dim=1).contiguous()
    res_args = (ftab, rthr, tabs, model.combo_tab, model.anchor_layout[0])
    hit = containment_rescue(*res_args)
    if not torch.equal(hit, containment_rescue_plain(*res_args)):
        raise AssertionError("containment_rescue differs from its plain "
                             "version")
    b_ms, b_by = bound(4 * (n_cell * 3 + n_anchor),
                       K4_OPS_PER_PAIR * gch * n_anchor)
    kernels["containment_rescue"] = {
        "name": "containment_rescue", "route": "cuda",
        "source": "objectdetection_3d_tpu_torch/csrc/assign_geometry.cu",
        "replaces": "objectdetection_3d_tpu/ops/assign_geometry.py:423",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: containment_rescue(*res_args), 20),
        "plain_ms": cuda_ms(lambda: containment_rescue_plain(*res_args), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    print(f"K3 chunk_geometry gch={gch} N={n_anchor}: bit-exact on all 11 "
          f"outputs ({n_cont} anchors inside a GT of chunk 0); "
          f"{kernels['chunk_geometry']['ms']:.4f} ms vs plain "
          f"{kernels['chunk_geometry']['plain_ms']:.4f} ms; K4 "
          f"containment_rescue: bit-exact ({int(hit.sum())} hits), "
          f"{kernels['containment_rescue']['ms']:.4f} ms vs plain "
          f"{kernels['containment_rescue']['plain_ms']:.4f} ms", flush=True)

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
        b_ms, b_by = bound(args[-1].numel() * 4 + n_pairs * 4
                           + args[-1].shape[0] * 4 * n_ids + MAX_GT * 40,
                           CLIP_OPS_PER_PAIR * n_pairs)
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "objectdetection_3d_tpu_torch/csrc/iou3d_clip.cu",
            "replaces": f"objectdetection_3d_tpu/ops/pallas_iou3d.py:"
                        f"{src_line}",
            "max_abs_err": err,
            "ms": cuda_ms(lambda fn=fn, args=args: fn(*args), 5),
            "plain_ms": cuda_ms(lambda plain=plain, args=args: plain(*args),
                                1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        print(f"{'K6' if n_ids == 1 else 'K7'} {name} pairs={n_pairs}: max "
              f"abs IoU err {err:.3g} ({n_diff} of {got.numel()} differ); "
              f"{kernels[name]['ms']:.4f} ms vs plain "
              f"{kernels[name]['plain_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms", flush=True)
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

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
