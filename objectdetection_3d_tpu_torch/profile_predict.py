"""Stage breakdown of the port's flagship predict on one CUDA card.

Run from the repository root:

    python3 -m objectdetection_3d_tpu_torch.profile_predict [--reps N] \
        [--plot] [--tpu KEY=VALUE ...]

Builds the flagship PointPillars (bf16; ``--tpu`` overrides keys of its
``tpu`` section, e.g. ``--tpu fused_stages=true``) with the trained
``artifacts/overfit_ckpt.npz``, runs predict on the 40x40 m trunk-column
clouds of ``scene.py`` and prints:

* per-stage device ms per predict, read from the program's spans
  (``profiling``) in a ``torch.profiler`` run of the clouds: each kernel,
  copy and fill is charged to every span whose host interval holds the
  runtime call that launched it (:func:`predict_table`), with the NMS
  rounds and the device idle inside NMS;
* the synchronizing CUDA calls of each predict (:func:`host_syncs`);
* host wall time per predict and the share of it the device was busy,
  whose complement is the idle share;
* the top CUDA kernels by total device time.

``--plot`` then traces one tiled call over ``scene.large_tree_scene()``
(25 tiles) and prints its sort and crop device ms, its merge's host ms
and the device idle inside it outside every predict
(:func:`plot_table`).  The full profiler table goes to
``chiprun_out/profile_predict.txt``.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import torch

from objectdetection_3d_tpu_torch import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (row, the spans it sums); "encoder.norm" lies inside "encoder", "nms"
# inside "decode_nms"
STAGES = (("voxelize", ("predict.voxelize",)),
          ("pfn_grid", ("predict.pfn_grid",)),
          ("front", ("predict.voxelize", "predict.pfn_grid")),
          ("encoder", ("predict.encoder",)),
          ("encoder.norm", ("encoder.norm",)),
          ("rpn_head", ("predict.rpn_head",)),
          ("decode_nms", ("predict.decode_nms",)),
          ("nms", ("predict.nms",)))
# the rows that together hold a predict's work
OUTER = ("front", "encoder", "rpn_head", "decode_nms")


def host_syncs(fn):
    """(``fn()``, the number of synchronizing CUDA calls it made, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def predict_table(trace, nms_rounds=0):
    """Per-predict readings of a trace of predicts: {row: device ms} of
    each of ``STAGES``; ``busy``, the ms the device was busy; ``outer``,
    the share of ``busy`` that ``OUTER`` holds; ``nms_idle``, device idle
    ms whose gap lies inside ``predict.nms``; ``nms_rounds``, the
    ``nms.rounds`` count given over the predicts."""
    n = profiling.span_count(trace, "predict")
    out = {row: profiling.span_device_ms(trace, spans) / n
           for row, spans in STAGES}
    out["busy"] = profiling.device_busy_ms(trace) / n
    out["outer"] = sum(out[k] for k in OUTER) / out["busy"]
    out["nms_idle"] = profiling.span_idle_ms(trace, "predict.nms") / n
    out["nms_rounds"] = nms_rounds / n
    return out


def plot_table(trace):
    """Per-plot readings of a trace of tiled calls: ``sort_crop``, device
    ms launched in ``plot.sort`` and ``plot.crop``; ``merge``, host ms of
    ``plot.merge``; ``tiler_idle``, device idle ms inside ``plot`` and
    outside every ``predict``; ``predicts``, the tiles' predicts."""
    n = profiling.span_count(trace, "plot")
    return {"sort_crop": profiling.span_device_ms(
                trace, ("plot.sort", "plot.crop")) / n,
            "merge": profiling.span_host_ms(trace, "plot.merge") / n,
            "tiler_idle": profiling.span_idle_ms(
                trace, "plot", outside=("predict",)) / n,
            "predicts": profiling.span_count(trace, "predict") / n}


def _traced(fn):
    """(the Chrome trace of ``fn()`` under ``torch.profiler`` as a dict,
    the profiler, host wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), prof, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4,
                    help="clouds (seeds 0..reps-1) to time")
    ap.add_argument("--tpu", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override a key of the flagship's tpu section "
                         "(repeatable), e.g. fused_stages=true")
    ap.add_argument("--plot", action="store_true",
                    help="also trace one tiled call of the 160 m scene")
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

    syncs = [host_syncs(lambda b=b: model.predict(b))[1] for b in batches]
    profiling.counters()
    trace, prof, wall = _traced(lambda: [model.predict(b) for b in batches])
    table = predict_table(trace, profiling.counters().get("nms.rounds", 0))
    n = len(batches)
    print(f"stage device ms per predict (over {n} clouds, B=1, bf16):")
    for row, _ in STAGES:
        print(f"  {row:<13} {table[row]:9.3f}")
    print(f"  {'busy':<13} {table['busy']:9.3f}   "
          f"({'+'.join(OUTER)}: {100 * table['outer']:.1f}% of it)")
    print(f"NMS: {table['nms_rounds']:.2f} rounds per predict, device idle "
          f"{table['nms_idle']:.3f} ms in it")
    print(f"host syncs per predict, clouds 0-{n - 1}: {syncs}")
    busy = table["busy"] * n / (wall * 1e3)
    print(f"profiled wall {wall * 1e3 / n:.3f} ms per predict: device "
          f"busy {busy:.3f}, idle {1 - busy:.3f}")
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print("top kernels by device time (ms per predict):")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f}  "
              f"{e.count // n:4d}x  {e.key[:90]}")
    text = events.table(sort_by="self_device_time_total", row_limit=25)

    if args.plot:
        from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
            TiledInference,
        )
        from objectdetection_3d_tpu_torch.scene import large_tree_scene

        scene = large_tree_scene()
        tiler = TiledInference(model, overlap=5.0)
        tiler(scene)                       # warm-up
        torch.cuda.synchronize()
        trace, _, wall = _traced(lambda: tiler(scene))
        plot = plot_table(trace)
        tile_ms = (profiling.span_device_ms(trace, "predict")
                   / plot["predicts"])
        print(f"plot of {len(scene)} points, {plot['predicts']:.0f} "
              f"predicts: wall {wall * 1e3:.1f} ms, sort + crop "
              f"{plot['sort_crop']:.3f} device ms, merge {plot['merge']:.3f} "
              f"host ms, idle outside the predicts "
              f"{plot['tiler_idle']:.3f} ms; a tile's predict "
              f"{tile_ms:.3f} device ms")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_predict.txt"), "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
