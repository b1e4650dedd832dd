"""Stage breakdown of the port's flagship predict on one CUDA card.

Run from the repository root:

    python3 -m objectdetection_3d_tpu_torch.profile_predict [--reps N] \
        [--tpu KEY=VALUE ...]

Builds the flagship PointPillars (bf16; ``--tpu`` overrides keys of its
``tpu`` section, e.g. ``--tpu fused_stages=true``) with the trained
``artifacts/overfit_ckpt.npz``, runs predict on the 40x40 m trunk-column
clouds of ``scene.py`` and prints:

* per-stage device time from CUDA events recorded at the network's module
  boundaries (voxelize, PFN, grid build, vertical encoder, RPN, head,
  decode + NMS), median over the clouds;
* host wall time per predict and the share of it the device spent in
  kernels (from ``torch.profiler``), whose complement is the idle share;
* the top CUDA kernels by total device time.

The full profiler table goes to ``chiprun_out/profile_predict.txt``.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("voxelize", "pfn", "grid", "encoder", "rpn", "head", "decode_nms")


def _record_stages(model, batch):
    """One predict with CUDA events at the stage boundaries -> {stage: ms}."""
    net = model.net
    ev = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    hooks = []
    for mod, start, end in ((net.voxel_encoder, "pfn0", "pfn1"),
                            (net.pseudoimage_generator, "enc0", "enc1"),
                            (net.sparse_rpn, "rpn0", "rpn1"),
                            (net.bbox_head, "head0", "head1")):
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, s=start: mark(s)))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, e=end: mark(e)))
    try:
        mark("start")
        model.predict(batch)
        mark("end")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    pairs = {"voxelize": ("start", "pfn0"), "pfn": ("pfn0", "pfn1"),
             "grid": ("pfn1", "enc0"), "encoder": ("enc0", "enc1"),
             "rpn": ("rpn0", "rpn1"), "head": ("head0", "head1"),
             "decode_nms": ("head1", "end")}
    out = {k: ev[a].elapsed_time(ev[b]) for k, (a, b) in pairs.items()}
    out["total"] = ev["start"].elapsed_time(ev["end"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4,
                    help="clouds (seeds 0..reps-1) to time")
    ap.add_argument("--tpu", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override a key of the flagship's tpu section "
                         "(repeatable), e.g. fused_stages=true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_predict: no CUDA device", file=sys.stderr)
        return 1
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.scene import (
        card_line,
        make_batch,
        tree_scene,
    )

    tpu = configs.parse_tpu_overrides(args.tpu)
    print(f"card: {card_line()}; tpu overrides {tpu}")
    model = PointPillars(configs.flagship_cfg(tpu), device="cuda")
    load_npz(model.net, os.path.join(REPO, "artifacts", "overfit_ckpt.npz"))
    p_max = model.tpu_cfg["max_points_static"]
    batches = [make_batch(tree_scene(s), p_max) for s in range(args.reps)]
    model.predict(batches[0])              # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()

    stages = [_record_stages(model, b) for b in batches]
    print("stage device ms (median over clouds, B=1, bf16):")
    for k in (*STAGES, "total"):
        vals = [s[k] for s in stages]
        print(f"  {k:<11} {np.median(vals):9.3f}   "
              f"[{min(vals):.3f} .. {max(vals):.3f}]")

    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            t0 = time.perf_counter()
            model.predict(b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = sum(walls) * 1e3
    busy = dev_us / 1e3 / wall_ms
    print(f"profiled wall {wall_ms / len(walls):.3f} ms per predict, kernels "
          f"{dev_us / 1e3 / len(walls):.3f} ms per predict: device busy "
          f"{busy:.3f}, idle {1 - busy:.3f}")
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print("top kernels by device time (ms per predict):")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / len(walls):9.3f}  "
              f"{e.count // len(walls):4d}x  {e.key[:90]}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_predict.txt"), "w") as f:
        f.write(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
