"""Time kernel sources against variants of them in one process on the card.

Run from the repository root on a CUDA machine, with another checkout
(for example the parent commit, unpacked by ``git archive``) at
``--parent``:

    python3 -m objectdetection_3d_tpu_torch.variant_times --parent DIR

Each variant is a copy of ``csrc/`` (this checkout's, with an optional
text edit, or the other checkout's) built by ``nvcc`` with the flags of
``ops/cuda_lib.py`` into ``build/variants/`` and swapped in under the
kernel's wrapper, so every variant runs the same wrapper on the same
inputs.  Variants are timed in turns (this, variant, variant, this) and
each output is held against the plain version first.  Cases:

* K10 ``subm_conv3d`` at the flagship's stages 0 and 1 (bf16, random
  inputs): this source against the same source without its k8 products
  on the last narrow chunk;
* K8 ``fused_stage`` at the flagship's stages 0-2: this source against
  the other checkout's;
* K3 ``chunk_geometry`` on cloud 0's flagship GT chunks 0 (12 trees) and
  1 (all padding), timed in a CUDA graph: this source against the other
  checkout's, and against this source at two blocks per SM (``lb2``),
  with one anchor per thread (``ka1``), and with one anchor per thread
  at four blocks per SM (``ka1_lb4``);
* K4 ``containment_rescue`` on the same chunks under each row's own
  containment maximum (rescue on the trees), in a CUDA graph and eager:
  this source against the other checkout's;
* K1 ``postsort_scan`` on the sorted cell ids of cloud 0 (B = 1) and of
  clouds 0-3 (B = 4), in a CUDA graph and eager: this source against the
  other checkout's; and the voxelizer's ``points_batch`` (predict's voxelize stage) around each:
  its span back to back, which the host's launches set, and the device
  time of its kernels (``timing.kernel_ms``);
* K5 ``intersection_volume_aligned`` on the 1.92 M flagship anchors
  against a random tree of cloud 0 (``chip_smoke.py``'s drive) and
  against jittered copies of themselves (dense), in a CUDA graph and
  eager: this source against the other checkout's, each called through
  its own C interface (the one-pass kernel of a checkout before the
  separating-plane test took no scratch);
* K6 ``iou_gathered`` and K7 ``iou_gathered_pair`` on cloud 0's
  assignment pairs (``chip_smoke.py``'s phase 7), in a CUDA graph and
  eager: this source against the other checkout's.

``--cases`` picks some of them (``k10 k8 k3 k4 k1 k5 k6 k7``; all by
default).
Prints one JSON line of {case: {variant: ms}}.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.timing import cuda_ms, graph_ms, kernel_ms

# the K10 source without its k8 products (every chunk k16)
NO_K8 = ("const bool k8_last = C - (chunks - 1) * 16 <= 8;",
         "const bool k8_last = false;")
# K3 at two or four blocks per SM (registers up to 128 or 64), and with
# one anchor per thread
K3_LB2 = ("__launch_bounds__(kMaxThreads, 3)",
          "__launch_bounds__(kMaxThreads, 2)")
K3_LB4 = ("__launch_bounds__(kMaxThreads, 3)",
          "__launch_bounds__(kMaxThreads, 4)")
K3_KA1 = ("constexpr int kA = 2;", "constexpr int kA = 1;")


def build_variant(name, csrc, tag, *edits):
    """Build ``csrc/<name>.cu`` (with ``edits``, (old, new) text pairs,
    applied) into ``build/variants/<tag>``; returns the loaded library."""
    out = cuda_lib.BUILD_DIR.parent / "variants" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in list(Path(csrc).glob("*.cu")) + list(Path(csrc).glob("*.cuh")):
        shutil.copy(f, out / f.name)
    for old, new in edits:
        src = (out / f"{name}.cu").read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"edit {old!r} not found once in {name}")
        (out / f"{name}.cu").write_text(src.replace(old, new))
    lib = out / f"lib{name}.so"
    log = subprocess.run([cuda_lib._nvcc(), *cuda_lib._flags(name), "-o",
                          str(lib), str(out / f"{name}.cu")], check=True,
                         capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"  ptxas {tag}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def in_turns(name, libs, fn, check, timer):
    """Time ``fn`` under each library of ``libs`` {variant: lib} in turns
    (first, others, others, first), after ``check()`` under each."""
    order = list(libs)
    saved = cuda_lib.load(name)
    times = {v: [] for v in order}
    try:
        for v in order:
            cuda_lib._libs[name] = libs[v]
            check()
        for v in order + order[::-1]:
            cuda_lib._libs[name] = libs[v]
            times[v].append(timer(fn))
    finally:
        cuda_lib._libs[name] = saved
    return {v: sum(t) / len(t) for v, t in times.items()}


def through(name, lib, fn):
    """``fn`` run with ``lib`` as the kernel library ``name``."""
    def call(*args):
        saved = cuda_lib.load(name)
        cuda_lib._libs[name] = lib
        try:
            return fn(*args)
        finally:
            cuda_lib._libs[name] = saved
    return call


def aligned_callers(parent_lib, parent_csrc):
    """{variant: fn(b1, b2)} of K5: this wrapper, and the other checkout's
    library through its own C interface, which is this wrapper's or the
    one-pass kernel's (boxes1, boxes2, out, p, stream)."""
    from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
        intersection_volume_aligned,
    )

    fns = {"this": intersection_volume_aligned}
    src = (Path(parent_csrc) / "iou3d_clip.cu").read_text()
    if "aligned_test_kernel" in src:
        fns["parent"] = through("iou3d_clip", parent_lib,
                                intersection_volume_aligned)
        return fns
    fn = parent_lib.intersection_volume_aligned
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def parent(b1, b2):
        out = torch.empty((b1.shape[0],), dtype=torch.float32,
                          device=b1.device)
        err = fn(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), b1.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"intersection_volume_aligned (parent) "
                               f"failed: {err}")
        return out

    fns["parent"] = parent
    return fns


def voxelize_with(layer, scan, points, num_points):
    """``layer.points_batch`` with ``scan`` as its post-sort scan."""
    from objectdetection_3d_tpu_torch.ops import voxelize

    saved = voxelize.postsort_scan
    voxelize.postsort_scan = scan
    try:
        return layer.points_batch(points, num_points)
    finally:
        voxelize.postsort_scan = saved


def fns_in_turns(fns, check, timer):
    """Time each of ``fns`` {variant: fn()} in turns (first, others,
    others, first), after ``check(fn)`` on each."""
    order = list(fns)
    for v in order:
        check(fns[v])
    times = {v: [] for v in order}
    for v in order + order[::-1]:
        times[v].append(timer(fns[v]))
    return {v: sum(t) / len(t) for v, t in times.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="another checkout whose csrc/ is a variant")
    kinds = ["k10", "k8", "k3", "k4", "k1", "k5", "k6", "k7"]
    ap.add_argument("--cases", nargs="+", default=kinds, choices=kinds)
    args = ap.parse_args(argv)
    cases = set(args.cases)
    if not torch.cuda.is_available():
        print("variant_times: no CUDA device", file=sys.stderr)
        return 1
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.assign import geometry_tier
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.ops.assign_geometry import (
        chunk_geometry,
        chunk_geometry_plain,
        containment_rescue,
        containment_rescue_plain,
    )
    from objectdetection_3d_tpu_torch.ops.fused_stage import (
        fused_stage,
        fused_stage_plain,
    )
    from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
        intersection_volume_aligned_plain,
        iou_gathered,
        iou_gathered_pair,
        iou_gathered_pair_plain,
        iou_gathered_plain,
    )
    from objectdetection_3d_tpu_torch.ops.pallas_conv import (
        subm_conv3d,
        subm_conv3d_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxel_scan import (
        postsort_scan,
        postsort_scan_plain,
    )
    from objectdetection_3d_tpu_torch.ops.voxelize import cells_sorted
    from objectdetection_3d_tpu_torch.scene import (
        MAX_GT,
        aligned_pair_inputs,
        card_line,
        make_batch,
        tree_scene,
    )

    print(card_line(), flush=True)
    here = cuda_lib.CSRC_DIR
    parent = Path(args.parent) / "objectdetection_3d_tpu_torch" / "csrc"
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale)

    def close(got, want, tol=1e-2):
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"variant differs by {err} (scale {scale})")

    out = {}
    if "k10" in cases:
        libs = {"this": cuda_lib.load("subm_conv3d"),
                "no_k8": build_variant("subm_conv3d", here, "no_k8", NO_K8)}
        for i, (d, c, co) in enumerate(((100, 20, 20), (49, 20, 32))):
            x = randn(1, d, 400, 400, c).to(torch.bfloat16)
            k = randn(3, 3, 3, c, co, scale=0.1)
            want = subm_conv3d_plain(x, k)
            out[f"subm_conv3d stage {i}"] = in_turns(
                "subm_conv3d", libs, lambda: subm_conv3d(x, k),
                lambda: close(subm_conv3d(x, k), want),
                lambda fn: cuda_ms(fn, 10))
            del x, want
    if "k8" in cases:
        libs = {"this": cuda_lib.load("fused_stage"),
                "parent": build_variant("fused_stage", parent, "parent")}
        for i, (d, c, co) in enumerate(((100, 20, 20), (49, 20, 32),
                                        (24, 32, 64))):
            m = (torch.rand((1, d, 400, 400), generator=gen, device="cuda")
                 < 0.1).to(torch.bfloat16)
            x = randn(1, d, 400, 400, c).to(torch.bfloat16) * m[..., None]
            fargs = (randn(3, 3, 3, c, co, scale=0.1),
                     randn(3, co, co, scale=0.2), randn(co).abs() + 0.5,
                     randn(co, scale=0.2), randn(co).abs() + 0.5,
                     randn(co, scale=0.2))
            want = fused_stage_plain(x, m, *fargs)
            out[f"fused_stage stage {i}"] = in_turns(
                "fused_stage", libs, lambda: fused_stage(x, m, *fargs),
                lambda: close(fused_stage(x, m, *fargs), want),
                lambda fn: cuda_ms(fn, 10))
            del x, m, want
    torch.cuda.empty_cache()

    model = PointPillars(configs.flagship_cfg(), device="cuda")
    batches = [make_batch(tree_scene(i), model.tpu_cfg["max_points_static"])
               for i in range(4)]
    gt = torch.as_tensor(batches[0]["bboxes"][0], device="cuda")
    gt_mask = torch.as_tensor(batches[0]["gt_mask"][0], device="cuda")
    if cases & {"k3", "k4", "k6", "k7"}:
        geom = geometry_tier(gt, gt_mask, model.anchor_layout,
                             model.combo_tab, MAX_GT, 512, 16,
                             chunk_geometry_plain)
    if cases & {"k3", "k4"}:
        libs = {"this": cuda_lib.load("assign_geometry"),
                "parent": build_variant("assign_geometry", parent, "parent")}
    if "k3" in cases:
        libs3 = {**libs,
                 "lb2": build_variant("assign_geometry", here, "lb2", K3_LB2),
                 "ka1": build_variant("assign_geometry", here, "ka1", K3_KA1),
                 "ka1_lb4": build_variant("assign_geometry", here, "ka1_lb4",
                                          K3_KA1, K3_LB4)}
        for c in (0, 1):
            (ftab, tabs), gid = geom["tables"][c], geom["chunks"][c].int()
            gargs = (ftab, gid, tabs, model.combo_tab,
                     model.anchor_layout[0], MAX_GT)
            want = chunk_geometry_plain(*gargs)

            def exact(gargs=gargs, want=want):
                got = chunk_geometry(*gargs)
                if not all(torch.equal(got[key], want[key]) for key in want):
                    raise AssertionError("chunk_geometry variant not "
                                         "bit-exact")

            out[f"chunk_geometry chunk {c}"] = in_turns(
                "assign_geometry", libs3,
                lambda gargs=gargs: chunk_geometry(*gargs), exact,
                lambda fn: graph_ms(fn, 10))
    if "k4" in cases:
        for c in (0, 1):
            (ftab, tabs), gid = geom["tables"][c], geom["chunks"][c]
            rthr = torch.stack([geom["cont_row_max"][gid],
                                gt_mask[gid].float()], dim=1).contiguous()
            rargs = (ftab, rthr, tabs, model.combo_tab,
                     model.anchor_layout[0])
            want = containment_rescue_plain(*rargs)

            def exact(rargs=rargs, want=want):
                if not torch.equal(containment_rescue(*rargs), want):
                    raise AssertionError("containment_rescue variant not "
                                         "bit-exact")

            for timer, label in ((lambda fn: graph_ms(fn, 10), "graph"),
                                 (lambda fn: cuda_ms(fn, 20), "eager")):
                out[f"containment_rescue chunk {c} {label}"] = in_turns(
                    "assign_geometry", libs,
                    lambda rargs=rargs: containment_rescue(*rargs), exact,
                    timer)
    if "k1" in cases:
        vl = model.voxel_layer
        d, h, w = model.grid_dhw
        sentinel = d * h * w
        fns = {"this": postsort_scan,
               "parent": through("voxel_scan",
                                 build_variant("voxel_scan", parent,
                                               "parent"), postsort_scan)}
        for b in (1, 4):
            pts = torch.as_tensor(np.concatenate(
                [x["points"] for x in batches[:b]]), device="cuda")
            n = torch.as_tensor(np.concatenate(
                [x["num_points"] for x in batches[:b]]), device="cuda")
            cell_s, _ = cells_sorted(pts, n, voxel_size=vl.voxel_size,
                                     point_cloud_range=vl.point_cloud_range)
            want = postsort_scan_plain(cell_s, sentinel)
            calls = {v: (lambda fn=fn, c=cell_s: fn(c, sentinel))
                     for v, fn in fns.items()}

            def exact(call, want=want):
                if not all(torch.equal(g, w_) for g, w_ in zip(call(), want)):
                    raise AssertionError("postsort_scan variant not "
                                         "bit-exact")

            for timer, label in ((lambda fn: graph_ms(fn, 20), "graph"),
                                 (lambda fn: cuda_ms(fn, 200), "eager")):
                out[f"postsort_scan B={b} {label}"] = fns_in_turns(
                    calls, exact, timer)
            # the voxelize stage of predict around each K1: its span back
            # to back (host-bound: the host's issue time of the stage) and
            # the device time of its kernels
            stage = {v: (lambda fn=fn, pts=pts, n=n: voxelize_with(
                vl, fn, pts, n)) for v, fn in fns.items()}
            ref = vl.points_batch(pts, n)

            def same(call, ref=ref):
                got = call()
                if not all(torch.equal(got[k], ref[k]) for k in ref):
                    raise AssertionError("voxelize differs under a K1 "
                                         "variant")

            out[f"voxelize B={b} span"] = fns_in_turns(
                stage, same, lambda fn: cuda_ms(fn, 50))
            out[f"voxelize B={b} kernels"] = fns_in_turns(
                stage, same, lambda fn: kernel_ms(fn, 20))
    if cases & {"k5", "k6", "k7"}:
        clip_lib = cuda_lib.load("iou3d_clip")
        parent_clip = build_variant("iou3d_clip", parent, "parent")
    if "k5" in cases:
        fns = aligned_callers(parent_clip, parent)
        inputs = aligned_pair_inputs(
            model.anchors.cpu().numpy(),
            batches[0]["bboxes"][0][batches[0]["gt_mask"][0]])
        for label, pair in inputs.items():
            b1, b2 = (torch.as_tensor(x, device="cuda") for x in pair)
            want = intersection_volume_aligned_plain(b1, b2)
            calls = {v: (lambda fn=fn, b1=b1, b2=b2: fn(b1, b2))
                     for v, fn in fns.items()}
            for timer, tag in ((lambda fn: graph_ms(fn, 10), "graph"),
                               (lambda fn: cuda_ms(fn, 10), "eager")):
                out[f"intersection_volume_aligned {label} {tag}"] = \
                    fns_in_turns(calls, lambda call, want=want: close(
                        call(), want, 1e-5), timer)
            del want
    if cases & {"k6", "k7"}:
        k = 512
        rows = torch.arange(MAX_GT, dtype=torch.int32,
                            device="cuda").repeat_interleave(k)
        cand = model.anchors[geom["cand_idx"].reshape(-1)].contiguous()
        safe = [torch.clamp(geom[a], 0, MAX_GT - 1) for a in ("a1", "a2")]
        libs = {"this": clip_lib, "parent": parent_clip}
        for case, name, fn, plain, args in (
                ("k6", "iou_gathered", iou_gathered, iou_gathered_plain,
                 (gt, gt_mask, rows, cand)),
                ("k7", "iou_gathered_pair", iou_gathered_pair,
                 iou_gathered_pair_plain,
                 (gt, gt_mask, safe[0], safe[1], model.anchors))):
            if case not in cases:
                continue
            want = plain(*args)
            want = torch.stack(want) if isinstance(want, tuple) else want

            def within(fn=fn, args=args, want=want):
                got = fn(*args)
                got = torch.stack(got) if isinstance(got, tuple) else got
                err = float((got - want).abs().max())
                if not err <= 1e-5:
                    raise AssertionError(f"variant differs by {err}")

            for timer, tag in ((lambda f: graph_ms(f, 10), "graph"),
                               (lambda f: cuda_ms(f, 10), "eager")):
                out[f"{name} {tag}"] = in_turns(
                    "iou3d_clip", libs, lambda fn=fn, args=args: fn(*args),
                    within, timer)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
