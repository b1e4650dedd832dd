"""Breakdown of the port's flagship training step on one CUDA card.

Run from the repository root:

    python3 -m objectdetection_3d_tpu_torch.profile_train [--steps N] \
        [--tpu KEY=VALUE ...]

Builds the flagship PointPillars (bf16, B = 1; ``--tpu`` overrides keys
of its ``tpu`` section, e.g. ``--tpu zfold_pallas=true``) from the trained
``artifacts/overfit_ckpt.npz`` with the AdamW settings of
``chip_smoke.py``, takes one warm-up step on the trunk-column cloud of
seed 0, then traces ``make_train_step``'s step on seeds 1..N with
``torch.profiler`` and prints:

* the device time of each phase range the step marks (forward,
  assignment, loss + backward, optimizer), mean over the steps;
* host wall time per step and the share of it the device spent in kernels,
  whose complement is the idle share;
* the top CUDA kernels by total device time, over the step and within
  its loss + backward range.

The full profiler table, and every kernel of the loss + backward range,
go to ``profile_train.txt`` in the trace's output directory.
"""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("forward", "assignment", "loss+backward", "optimizer")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _charged(trace, phases):
    """(phase or "other", device event) for each kernel, copy and fill of
    a Chrome trace: the innermost phase range whose host interval holds
    the runtime call that launched it, from any thread."""
    events = trace["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in phases)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in _LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        name = "other"
        if ts is not None:
            # ranges are sorted by start: the last that holds ts is the
            # innermost
            for start, end, phase in ranges:
                if start > ts:
                    break
                if ts <= end:
                    name = phase
        yield name, e


def phase_device_ms(trace, phases=PHASES):
    """Device time of each phase range in a Chrome trace of train steps.

    Each kernel, copy and fill is charged to the innermost phase range
    whose host interval holds the runtime call that launched it, from any
    thread (autograd launches the backward from a thread of its own while
    the calling thread waits inside its range).

    Args:
        trace: the trace ``torch.profiler`` exports, as a dict.
    Returns:
        {phase: device ms summed over the trace, "other": device ms
        launched outside every phase}.
    """
    out = dict.fromkeys((*phases, "other"), 0.0)
    for name, e in _charged(trace, phases):
        out[name] += e["dur"] / 1e3
    return out


def phase_kernel_ms(trace, phase, phases=PHASES):
    """{kernel name: device ms summed over the trace} of the kernels,
    copies and fills charged to ``phase`` as :func:`phase_device_ms`
    charges them."""
    out = {}
    for name, e in _charged(trace, phases):
        if name == phase:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def traced_steps(step, batches, trace_path):
    """Run ``step`` on each batch under ``torch.profiler``.

    Returns:
        (profiler, host wall seconds of each step, the exported Chrome
        trace as a dict; also written to ``trace_path``).
    """
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    return prof, walls, trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps (clouds of seeds 1..steps)")
    ap.add_argument("--tpu", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override a key of the flagship's tpu section "
                         "(repeatable), e.g. zfold_pallas=true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
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
    tx = model.get_optimizer(dict(lr=1e-3, betas=(0.95, 0.99),
                                  weight_decay=0.01), grad_clip_value=2.0)
    p_max = model.tpu_cfg["max_points_static"]
    batches = [make_batch(tree_scene(s), p_max)
               for s in range(args.steps + 1)]
    step = model.make_train_step(tx)
    step(batches[0])                        # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()

    out_dir = os.path.join(REPO, "chiprun_out")
    prof, walls, trace = traced_steps(
        step, batches[1:], os.path.join(out_dir, "profile_train_trace.json"))
    n = len(walls)
    split = phase_device_ms(trace)
    print("step split, device ms per step (mean over steps, B=1, bf16):")
    for k, v in split.items():
        print(f"  {k:<14} {v / n:9.3f}")
    dev_ms = sum(split.values())
    wall_ms = sum(walls) * 1e3
    busy = dev_ms / wall_ms
    print(f"profiled wall {wall_ms / n:.3f} ms per step, kernels "
          f"{dev_ms / n:.3f} ms per step: device busy {busy:.3f}, "
          f"idle {1 - busy:.3f}")
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in PHASES]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    print("top kernels by device time (ms per step):")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f}  "
              f"{e.count // n:4d}x  {e.key[:90]}")
    per_kernel = sorted(phase_kernel_ms(trace, "loss+backward").items(),
                        key=lambda kv: -kv[1])
    print("top kernels of loss+backward (ms per step):")
    for name, ms in per_kernel[:25]:
        print(f"  {ms / n:9.3f}  {name[:90]}")
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
        f.write("\nloss+backward, every kernel (ms per step):\n")
        f.writelines(f"{ms / n:9.3f}  {name}\n" for name, ms in per_kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
