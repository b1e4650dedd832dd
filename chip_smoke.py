#!/usr/bin/env python3
"""Drive the PyTorch port's single-cloud inference path on one CUDA card.

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
   detections the bf16 run matches (information, not a gate).

The last lines are the ``kernels`` JSON line, the card line and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "artifacts", "overfit_ckpt.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
N_POINTS = 100_000


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tree_scene(seed, extent=40.0, n_trees=12, n_points=N_POINTS):
    """A 40x40 m forest plot: trunk columns over uniform clutter, exactly
    ``n_points`` points of (x, y, z, reflectance)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n_trees):
        cx, cy = rng.uniform(2.0, extent - 2.0, 2)
        z0 = rng.uniform(0.2, 1.0)
        height = rng.uniform(10.0, 14.0)
        radius = rng.uniform(0.25, 0.45)
        k = int(rng.integers(2500, 4000))
        ang = rng.uniform(0, 2 * np.pi, k)
        rad = radius * np.sqrt(rng.uniform(0, 1, k))
        z = z0 + height * rng.uniform(0, 1, k) ** 0.7
        trunk = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang), z],
                         -1)
        refl = rng.uniform(0.3, 1.0, (k, 1))
        pts.append(np.concatenate([trunk, refl], -1))
    n_noise = n_points - sum(len(p) for p in pts)
    noise = np.concatenate(
        [rng.uniform([0, 0, 0], [extent, extent, 25], (n_noise, 3)),
         rng.uniform(0, 0.3, (n_noise, 1))], -1)
    pts.append(noise)
    cloud = np.concatenate(pts).astype(np.float32)
    return cloud[rng.permutation(len(cloud))]


def make_batch(cloud, max_points):
    points = np.zeros((1, max_points, 4), np.float32)
    points[0, :len(cloud)] = cloud
    return {"points": points,
            "num_points": np.array([len(cloud)], np.int32)}


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    sys.path.insert(0, REPO)
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.ops import cuda_lib
    from objectdetection_3d_tpu_torch.ops.grid_scatter import (
        scatter_to_grid,
        scatter_to_grid_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxel_scan import (
        postsort_scan,
        postsort_scan_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxelize import cells_sorted

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
    clouds = [tree_scene(seed) for seed in range(4)]
    batches = [make_batch(c, p_max) for c in clouds]
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
        kernels[name]["launches"] = count
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

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
